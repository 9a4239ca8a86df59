"""The port's RMSprop and SGD factories against optax, on the CPU.

Six steps of each optimizer on the same weights (two tensors) with the same
numpy gradients: ``RMSpropOptimizerFactory`` (optax's ``rmsprop``:
``rsqrt(nu + eps)``, not torch's ``sqrt(nu) + eps``) and
``SGDOptimizerFactory`` at momentum 0 and 0.9, each with and without
``max_grad_norm`` (a clip that acts: the gradients' norm is above it) and
with a constant rate or ``linear_lr_schedule``. The weights after every step
within atol 2e-6 and rtol 1e-6 of optax's (rsqrt and the products round
differently on the two sides), RMSprop's second moment and SGD's trace
likewise; the rate tensor after the run the schedule's. RMSprop with
``eps`` 1e-2 tells the two placements of ``eps`` apart: torch's placement
misses by more than the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tianshou_tpu.algorithm.optim import RMSpropOptimizerFactory as JRMSprop
from tianshou_tpu.algorithm.optim import SGDOptimizerFactory as JSGD
from tianshou_tpu.algorithm.optim import linear_lr_schedule as jlinear
from tianshou_tpu_torch.algorithm.optim import RMSpropOptimizerFactory, SGDOptimizerFactory, linear_lr_schedule
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

STEPS = 6
TOL = dict(rtol=1e-6, atol=2e-6)


def _data():
    rng = np.random.default_rng(0)
    w = [rng.normal(0, 1, (4, 3)).astype(np.float32), rng.normal(0, 1, (3,)).astype(np.float32)]
    g = [[rng.normal(0, 2, x.shape).astype(np.float32) for x in w] for _ in range(STEPS)]
    return w, g


CASES = [
    ("rmsprop", dict(lr=1e-2, alpha=0.99, eps=1e-8)),
    ("rmsprop", dict(lr=1e-2, alpha=0.9, eps=1e-2)),
    ("sgd", dict(lr=0.05, momentum=0.0)),
    ("sgd", dict(lr=0.05, momentum=0.9)),
]


@pytest.mark.parametrize("clip", [None, 1.0], ids=["no_clip", "clip"])
@pytest.mark.parametrize("schedule", [False, True], ids=["const", "linear"])
@pytest.mark.parametrize("kind,kw", CASES, ids=["rmsprop", "rmsprop_eps", "sgd", "sgd_momentum"])
def test_matches_optax(kind, kw, clip, schedule):
    jfac, tfac = {"rmsprop": (JRMSprop, RMSpropOptimizerFactory), "sgd": (JSGD, SGDOptimizerFactory)}[kind]
    kw = dict(kw)
    lr = kw.pop("lr")
    jlr, tlr = (jlinear(lr, 4), linear_lr_schedule(lr, 4)) if schedule else (lr, lr)
    tx = jfac(lr=jlr, max_grad_norm=clip, **kw)
    factory = tfac(lr=tlr, max_grad_norm=clip, **kw)
    w0, grads = _data()
    jw = [jnp.asarray(x) for x in w0]
    jstate = tx.init(jw)
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in w0]
    opt = factory.create(params)
    for g in grads:
        assert clip is None or np.sqrt(sum((x**2).sum() for x in g)) > clip  # the clip acts
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jw)
        jw = optax.apply_updates(jw, upd)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        factory.step(opt)
        for p, x in zip(params, jw):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(x), **TOL)
    buf = {"rmsprop": ("square_avg", "nu"), "sgd": ("momentum_buffer", "trace")}[kind]
    want = [leaf for _, leaf in optax.tree_utils.tree_get_all_with_path(jstate, buf[1])]
    if kind == "sgd" and not kw["momentum"]:
        assert all(set(opt.state[p]) == {"step"} for p in params)
    else:
        for p, x in zip(params, want[0]):
            np.testing.assert_allclose(opt.state[p][buf[0]].numpy(), np.asarray(x), **TOL)
    assert all(int(opt.state[p]["step"]) == STEPS for p in params)
    if schedule:
        assert torch.is_tensor(opt.param_groups[0]["lr"]) and float(opt.param_groups[0]["lr"]) == 0.0


def test_rmsprop_places_eps_inside_the_square_root():
    """optax's ``rsqrt(nu + eps)`` against torch's ``sqrt(nu) + eps``: with a large
    eps one step differs by far more than the tolerance."""
    w0, grads = _data()
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in w0]
    factory = RMSpropOptimizerFactory(lr=1e-2, alpha=0.9, eps=1e-2)
    opt = factory.create(params)
    ref = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in w0]
    torch_rms = torch.optim.RMSprop(ref, lr=1e-2, alpha=0.9, eps=1e-2)
    for p, q, g in zip(params, ref, grads[0]):
        p.grad, q.grad = torch.from_numpy(g.copy()), torch.from_numpy(g.copy())
    factory.step(opt)
    torch_rms.step()
    assert max(float((p - q).detach().abs().max()) for p, q in zip(params, ref)) > 100 * TOL["atol"]
