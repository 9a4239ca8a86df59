"""The return and advantage battery of the JAX package, against the port's
``tianshou_tpu_torch/ops/returns.py``: the degenerate-parameter identities of
``tests/test_returns_battery.py`` (GAE at lambda 0 and 1, gamma 0,
truncation; n-step at n = 1, gamma 0 and a mid-chain end; Monte-Carlo returns
per episode and per env) and the reference's exact vectors of
``tests/test_returns_reference_vectors.py`` (upstream test/base/test_returns.py,
truncation bootstrapping included), with the same inputs and tolerances. The
on-policy update's GAE and Monte-Carlo returns rest on these."""

import numpy as np
import torch

from tianshou_tpu_torch.ops.returns import gae_advantages, mc_return_to_go, nstep_returns, value_mask
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def t(x):
    return torch.as_tensor(np.asarray(x))


def _np(a):
    return a.numpy()


def test_gae_lambda_zero_is_td_error():
    T = 6
    rng = np.random.default_rng(0)
    rew = rng.normal(size=T).astype(np.float32)
    val = rng.normal(size=T).astype(np.float32)
    nxt = rng.normal(size=T).astype(np.float32)
    term = np.zeros(T, bool)
    end = np.zeros(T, bool)
    adv = gae_advantages(t(rew), t(val), t(nxt), t(term), t(end), gamma=0.9, gae_lambda=0.0)
    np.testing.assert_allclose(_np(adv), rew + 0.9 * nxt - val, rtol=1e-6)


def test_gae_lambda_one_is_mc_minus_value():
    """lambda = 1 telescopes: on one episode terminated at T-1 the advantage
    is the Monte-Carlo return to go minus the value."""
    T = 5
    rng = np.random.default_rng(1)
    rew = rng.normal(size=T).astype(np.float32)
    val = rng.normal(size=T).astype(np.float32)
    nxt = np.concatenate([val[1:], [rng.normal()]]).astype(np.float32)
    term = np.zeros(T, bool)
    term[-1] = True
    end = term.copy()
    gamma = 0.95
    adv = gae_advantages(t(rew), t(val), t(nxt), t(term), t(end), gamma=gamma, gae_lambda=1.0)
    mc = _np(mc_return_to_go(t(rew), gamma, t(end)))
    np.testing.assert_allclose(_np(adv), mc - val, rtol=1e-5, atol=1e-6)


def test_gae_gamma_zero_is_immediate_td():
    T = 4
    rew = np.arange(1.0, T + 1, dtype=np.float32)
    val = np.full(T, 0.5, np.float32)
    adv = gae_advantages(t(rew), t(val), torch.ones(T), torch.zeros(T, dtype=torch.bool),
                         torch.zeros(T, dtype=torch.bool), gamma=0.0, gae_lambda=0.95)
    np.testing.assert_allclose(_np(adv), rew - val, rtol=1e-6)


def test_gae_truncation_cuts_chain_but_bootstraps():
    """A truncated step keeps gamma * V(s') in its own delta but the
    advantage chain does not cross it."""
    T = 4
    rew = np.ones(T, np.float32)
    val = np.zeros(T, np.float32)
    nxt = np.full(T, 2.0, np.float32)
    term = np.zeros(T, bool)
    end = np.zeros(T, bool)
    end[1] = True  # truncated at t=1
    gamma, lam = 0.9, 0.8
    adv = _np(gae_advantages(t(rew), t(val), t(nxt), t(term), t(end), gamma=gamma, gae_lambda=lam))
    delta = rew + gamma * nxt - val
    assert np.isclose(adv[1], delta[1])
    assert np.isclose(adv[0], delta[0] + gamma * lam * delta[1])
    assert np.isclose(adv[3], delta[3])
    assert np.isclose(adv[2], delta[2] + gamma * lam * delta[3])


def test_value_mask_terminated_vs_truncated():
    np.testing.assert_array_equal(_np(value_mask(torch.tensor([False, True, False]))), [1.0, 0.0, 1.0])


def test_nstep_n1_is_td_target():
    B = 5
    rng = np.random.default_rng(2)
    rew = rng.normal(size=(1, B)).astype(np.float32)
    end = np.zeros((1, B), np.float32)
    q = rng.normal(size=(B, 1)).astype(np.float32)
    out = _np(nstep_returns(t(rew), t(end), t(q), gamma=0.9))
    np.testing.assert_allclose(out, rew.T + 0.9 * q, rtol=1e-6)


def test_nstep_gamma_zero_is_first_reward():
    rew = np.array([[1.0, 2.0], [10.0, 20.0], [100.0, 200.0]], np.float32)
    end = np.zeros((3, 2), np.float32)
    q = np.full((2, 1), 7.0, np.float32)
    np.testing.assert_allclose(_np(nstep_returns(t(rew), t(end), t(q), gamma=0.0)), [[1.0], [2.0]])


def test_nstep_mid_chain_end_truncates_sum_and_discounts_bootstrap():
    """An episode that ends at chain step 1: r0 + g*r1 + g^2*Q_terminal;
    rewards past the end do not leak in."""
    gamma = 0.5
    rew = np.array([[1.0], [2.0], [999.0]], np.float32)
    end = np.array([[0.0], [1.0], [1.0]], np.float32)
    q = np.array([[4.0]], np.float32)
    out = _np(nstep_returns(t(rew[:2]), t(end[:2]), t(q), gamma=gamma))
    np.testing.assert_allclose(out, [[1.0 + 0.5 * 2.0 + 0.25 * 4.0]])
    rew3 = np.array([[1.0], [2.0], [0.0]], np.float32)
    out3 = _np(nstep_returns(t(rew3), t(end), t(q), gamma=gamma))
    np.testing.assert_allclose(out3, [[1.0 + 0.5 * 2.0 + 0.25 * 4.0]])


def test_mc_return_gamma_one_is_suffix_sums_per_episode():
    rew = np.array([1, 2, 3, 4, 5], np.float32)
    end = np.array([0, 0, 1, 0, 0], bool)
    np.testing.assert_allclose(_np(mc_return_to_go(t(rew), 1.0, t(end))), [6, 5, 3, 9, 5])


def test_mc_return_batched_envs():
    rew = np.array([[1, 10], [2, 20], [3, 30]], np.float32)  # [T=3, E=2]
    end = np.array([[0, 0], [1, 0], [0, 1]], bool)
    out = _np(mc_return_to_go(t(rew), 0.5, t(end)))
    np.testing.assert_allclose(out[:, 0], [1 + 0.5 * 2, 2, 3])
    np.testing.assert_allclose(out[:, 1], [10 + 0.5 * (20 + 0.5 * 30), 20 + 0.5 * 30, 30])


# ---------------------------------------------------------------------------
# the reference's exact vectors (upstream test/base/test_returns.py): the
# reference passes v_s_ (the value of obs_next) and derives v_s = roll(v_s_, 1)
# ---------------------------------------------------------------------------
def episodic_returns(rew, terminated, truncated, v=None, gamma=0.1, lam=1.0):
    rew = np.asarray(rew, np.float32)
    term = np.asarray(terminated, np.float32)
    trunc = np.asarray(truncated, np.float32)
    v = np.zeros_like(rew) if v is None else np.asarray(v, np.float32)
    v_s = np.roll(v * (1 - term), 1)
    end = np.maximum(term, trunc)
    return _np(gae_advantages(t(rew), t(v_s), t(v), t(term), t(end), gamma, lam)) + v_s


def test_reference_case_1():
    got = episodic_returns(rew=[0, 1, 2, 3, 4, 5, 6, 7.0], terminated=[1, 0, 0, 1, 0, 0, 0, 1],
                           truncated=[0, 0, 0, 0, 0, 1, 0, 0])
    np.testing.assert_allclose(got, [0, 1.23, 2.3, 3, 4.5, 5, 6.7, 7], rtol=1e-5)


def test_reference_case_2():
    got = episodic_returns(rew=[7, 6, 1, 2, 3, 4, 5.0], terminated=[0, 1, 0, 1, 0, 1, 0], truncated=[0] * 7)
    np.testing.assert_allclose(got, [7.6, 6, 1.2, 2, 3.4, 4, 5], rtol=1e-5)


def test_reference_case_3():
    got = episodic_returns(rew=[7, 6, 1, 2, 3, 4, 5.0], terminated=[0, 1, 0, 1, 0, 0, 1], truncated=[0] * 7)
    np.testing.assert_allclose(got, [7.6, 6, 1.2, 2, 3.45, 4.5, 5], rtol=1e-5)


def test_reference_gae_ground_truth():
    got = episodic_returns(
        rew=[101, 102, 103.0, 200, 104, 105, 106, 201, 107, 108, 109, 202],
        terminated=[0, 0, 0, 1.0, 0, 0, 0, 1, 0, 0, 0, 1], truncated=[0] * 12,
        v=[2.0, 3.0, 4, -1, 5.0, 6.0, 7, -2, 8.0, 9.0, 10, -3], gamma=0.99, lam=0.95,
    )
    ground_truth = [454.8344, 376.1143, 291.298, 200.0, 464.5610, 383.1085, 295.387, 201.0,
                    474.2876, 390.1027, 299.476, 202.0]
    np.testing.assert_allclose(got, ground_truth, atol=1e-3)


def test_reference_gae_with_truncation():
    """Truncated episodes bootstrap their next-state value."""
    got = episodic_returns(
        rew=[101, 102, 103.0, 200, 104, 105, 106, 201, 107, 108, 109, 202],
        terminated=[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1], truncated=[0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0],
        v=[2.0, 3.0, 4, -1, 5.0, 6.0, 7, -2, 8.0, 9.0, 10, -3], gamma=0.99, lam=0.95,
    )
    ground_truth = [454.0109, 375.2386, 290.3669, 199.01, 462.9138, 381.3571, 293.5248, 199.02,
                    474.2876, 390.1027, 299.476, 202.0]
    np.testing.assert_allclose(got, ground_truth, atol=1e-3)
