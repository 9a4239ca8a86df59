"""Parity of tianshou_tpu_torch/ops/returns.py with tianshou_tpu/ops/returns.py.

Inputs come from a numpy seed and go to both packages. Tolerance: float32,
1e-6 absolute plus 1e-6 relative. Both sides run the same float32 recurrence
in the same order; the only difference allowed is the last bit of ``pow``
in ``nstep_returns`` (XLA's and PyTorch's float32 ``pow`` may round
differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.ops import returns as jr
from tianshou_tpu_torch.ops import returns as tr
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_nstep_returns_matches_jax(seed, n):
    rng = np.random.default_rng(seed)
    B, A = 16, 4
    rew = rng.standard_normal((n, B)).astype(np.float32)
    # episode ends inside the n-window, including at the first and last step
    end = (rng.random((n, B)) < 0.3).astype(np.float32)
    end[:, 0] = 0
    end[0, 1] = 1
    end[-1, 2] = 1
    tq = rng.standard_normal((B, A)).astype(np.float32)
    want = _np(jr.nstep_returns(jnp.asarray(rew), jnp.asarray(end), jnp.asarray(tq), 0.97))
    got = tr.nstep_returns(torch.from_numpy(rew), torch.from_numpy(end), torch.from_numpy(tq), 0.97).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # scalar target values keep their [B] shape
    want1 = _np(jr.nstep_returns(jnp.asarray(rew), jnp.asarray(end), jnp.asarray(tq[:, 0]), 0.9))
    got1 = tr.nstep_returns(torch.from_numpy(rew), torch.from_numpy(end), torch.from_numpy(tq[:, 0]), 0.9).numpy()
    assert got1.shape == want1.shape
    np.testing.assert_allclose(got1, want1, **TOL)


def test_value_mask_matches_jax():
    term = np.array([True, False, True, False])
    np.testing.assert_array_equal(tr.value_mask(torch.from_numpy(term)).numpy(), _np(jr.value_mask(jnp.asarray(term))))


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_advantages_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, E = 12, 5
    rew = rng.standard_normal((T, E)).astype(np.float32)
    v = rng.standard_normal((T, E)).astype(np.float32)
    nv = rng.standard_normal((T, E)).astype(np.float32)
    term = rng.random((T, E)) < 0.15
    end = term | (rng.random((T, E)) < 0.1)
    end[-1] = True
    args_j = [jnp.asarray(a) for a in (rew, v, nv, term, end)]
    args_t = [torch.from_numpy(a) for a in (rew, v, nv, term, end)]
    want = _np(jr.gae_advantages(*args_j, 0.99, 0.95))
    got = tr.gae_advantages(*args_t, 0.99, 0.95).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("with_ends", [False, True])
def test_mc_return_to_go_matches_jax(with_ends):
    rng = np.random.default_rng(3)
    rew = rng.standard_normal((10, 4)).astype(np.float32)
    end = rng.random((10, 4)) < 0.25 if with_ends else None
    want = _np(jr.mc_return_to_go(jnp.asarray(rew), 0.9, None if end is None else jnp.asarray(end)))
    got = tr.mc_return_to_go(torch.from_numpy(rew), 0.9, None if end is None else torch.from_numpy(end)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
