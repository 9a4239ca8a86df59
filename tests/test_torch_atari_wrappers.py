"""The DeepMind wrapper stack in the port (tianshou_tpu_torch/env/atari.py)
against the JAX package's, on a scripted ALE-like env (no ALE is installed).

Every case of ``tests/test_atari_wrappers.py`` runs on the port's wrappers,
and each wrapper and the composed ``wrap_deepmind`` stack run side by side
with the JAX package's over the same scripted episodes and actions: frames,
rewards, terminations, truncations and the underlying env's action log
equal, exactly (numpy on the host in both). Two departures are held as such:
the port's ``FrameStack`` stacks on a new leading axis (``[n, 84, 84]``, the
reference's layout) where the JAX module stacks last, so its frames are
compared through ``np.moveaxis``; and the port's ``NoopResetEnv`` reseeds its
no-op draw from ``reset(seed=...)``, so the JAX side is given the same
generator by hand.
"""

import numpy as np
import pytest

from tianshou_tpu.env import atari as jatari
from tianshou_tpu_torch.env.atari import (
    ClipRewardEnv,
    EpisodicLifeEnv,
    FireResetEnv,
    FrameStack,
    MaxAndSkipEnv,
    NoopResetEnv,
    ScaledFloatFrame,
    WarpFrame,
    make_atari_env,
    wrap_deepmind,
)
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


class _FakeALE:
    def __init__(self, outer):
        self._outer = outer

    def lives(self):
        return self._outer._lives


class FakeAtari:
    """Scripted ALE-like env (``tests/test_atari_wrappers.py:37``): frame t is a
    constant image of value t % 256 (or, with ``pattern``, a position-dependent
    one); rewards, life losses and the episode end follow scripts."""

    def __init__(self, shape=(210, 160, 3), rewards=None, life_losses=(), done_at=None,
                 meanings=("NOOP", "FIRE", "RIGHT", "LEFT"), episode_len=10_000, pattern=False):
        self.shape = shape
        self.rewards = rewards or {}
        self.life_losses = set(life_losses)
        self.done_at = done_at
        self.meanings = list(meanings)
        self.episode_len = episode_len
        self.pattern = pattern
        self.t = 0
        self._lives = 3
        self.steps_taken = []
        self.reset_count = 0
        self.ale = _FakeALE(self)
        self.unwrapped = self

    def get_action_meanings(self):
        return self.meanings

    def _frame(self):
        if self.pattern:
            h, w, c = self.shape
            idx = np.arange(h * w * c, dtype=np.int64).reshape(self.shape)
            return ((idx * 7 + self.t * 13 + (self.steps_taken[-1] if self.steps_taken else 0) * 31) % 256).astype(np.uint8)
        return np.full(self.shape, self.t % 256, np.uint8)

    def reset(self, **kw):
        self.t = 0
        self._lives = 3
        self.reset_count += 1
        return self._frame(), {}

    def step(self, a):
        self.steps_taken.append(int(a))
        self.t += 1
        if self.t in self.life_losses:
            self._lives -= 1
        term = (self.done_at is not None and self.t >= self.done_at) or self._lives <= 0
        trunc = self.t >= self.episode_len
        return self._frame(), float(self.rewards.get(self.t, 0.0)), term, trunc, {}


# ---------------------------------------------------------------- the JAX battery on the port
def test_noop_reset_steps_noops():
    env = FakeAtari()
    w = NoopResetEnv(env, noop_max=8)
    for _ in range(20):
        env.steps_taken.clear()
        w.reset()
        assert 1 <= len(env.steps_taken) <= 8 and all(a == 0 for a in env.steps_taken)


def test_noop_reset_reresets_on_done():
    env = FakeAtari(done_at=1)
    obs, _ = NoopResetEnv(env, noop_max=5).reset()
    assert env.reset_count >= 2 and obs.shape == env.shape


def test_noop_reset_repeats_under_a_seed():
    counts = []
    for _ in range(2):
        env = FakeAtari()
        w = NoopResetEnv(env, noop_max=30)
        w.reset(seed=3)
        w.reset()
        counts.append(len(env.steps_taken))
    assert counts[0] == counts[1]


def test_max_and_skip_pools_last_two_and_sums_reward():
    env = FakeAtari(rewards={1: 1.0, 2: 2.0, 3: 4.0, 4: 8.0})
    w = MaxAndSkipEnv(env, skip=4)
    env.reset()
    obs, r, term, trunc, _ = w.step(3)
    assert r == 15.0 and len(env.steps_taken) == 4
    assert obs.max() == obs.min() == 4 and not term and not trunc


def test_max_and_skip_stops_at_done():
    env = FakeAtari(rewards={1: 1.0, 2: 1.0}, done_at=2)
    w = MaxAndSkipEnv(env, skip=4)
    env.reset()
    obs, r, term, _, _ = w.step(0)
    assert term and r == 2.0 and len(env.steps_taken) == 2


def test_episodic_life_splits_episodes_without_real_reset():
    env = FakeAtari(life_losses={3}, done_at=100)
    w = EpisodicLifeEnv(env)
    w.reset()
    resets_before = env.reset_count
    term, steps = False, 0
    while not term:
        _, _, term, _, _ = w.step(0)
        steps += 1
    assert steps == 3 and not w.was_real_done
    w.reset()
    assert env.reset_count == resets_before and env.t == 4


def test_episodic_life_real_done_truly_resets():
    env = FakeAtari(done_at=2)
    w = EpisodicLifeEnv(env)
    w.reset()
    term = False
    while not term:
        _, _, term, _, _ = w.step(0)
    assert w.was_real_done
    before = env.reset_count
    w.reset()
    assert env.reset_count == before + 1 and env.t == 0


def test_fire_reset_presses_fire():
    env = FakeAtari()
    w = FireResetEnv(env)
    env.steps_taken.clear()
    w.reset()
    assert env.steps_taken == [1]


def test_warp_frame_shape_dtype_and_grayscale():
    env = FakeAtari()
    w = WarpFrame(env)
    obs, _ = w.reset()
    assert obs.shape == (84, 84) and obs.dtype == np.uint8
    env.t = 100
    obs, *_ = w.step(0)
    assert obs.max() == obs.min() and abs(int(obs[0, 0]) - 101) <= 1


def test_warp_frame_grayscale_weights():
    w = WarpFrame(FakeAtari())
    red = np.zeros((210, 160, 3), np.uint8)
    red[..., 0] = 200
    assert w._warp(red)[0, 0] == int(200 * 0.299)
    blue = np.zeros((210, 160, 3), np.uint8)
    blue[..., 2] = 200
    assert w._warp(blue)[0, 0] == int(200 * 0.114)


def test_clip_reward_signs():
    env = FakeAtari(rewards={1: 7.5, 2: -3.0, 3: 0.0})
    w = ClipRewardEnv(env)
    env.reset()
    assert [w.step(0)[1] for _ in range(3)] == [1.0, -1.0, 0.0]


def test_scaled_float_frame():
    env = FakeAtari()
    w = ScaledFloatFrame(env)
    obs, _ = w.reset()
    assert obs.dtype == np.float32 and obs.max() <= 1.0 and obs.min() >= 0.0
    env.t = 254
    obs, *_ = w.step(0)
    assert obs.max() == 1.0


def test_frame_stack_reset_fill_and_rolling():
    env = FakeAtari(shape=(4, 4, 3))
    w = FrameStack(WarpFrame(env), n_frames=4)
    obs, _ = w.reset()
    assert obs.shape == (4, 84, 84)  # oldest first on a leading axis
    assert (obs[0] == obs[3]).all()
    for _ in range(4):
        obs, *_ = w.step(0)
    vals = [int(obs[i, 0, 0]) for i in range(4)]
    assert vals == sorted(vals) and vals[-1] == env.t % 256


def test_wrap_deepmind_composed_contract():
    env = FakeAtari(rewards={5: 3.0}, life_losses={40}, done_at=200)
    w = wrap_deepmind(env, noop_max=2, max_and_skip=4, frame_stack=4)
    obs, _ = w.reset()
    assert obs.shape == (4, 84, 84) and obs.dtype == np.uint8
    obs, r, term, trunc, _ = w.step(0)
    assert r in (0.0, 1.0)
    saw_term = False
    for _ in range(30):
        obs, r, term, trunc, _ = w.step(0)
        if term:
            saw_term = True
            break
    assert saw_term
    resets = env.reset_count
    obs, _ = w.reset()
    assert env.reset_count == resets and obs.shape == (4, 84, 84)


def test_wrap_deepmind_skips_fire_when_absent():
    w = wrap_deepmind(FakeAtari(meanings=("NOOP", "RIGHT", "LEFT")), noop_max=2)
    layers = []
    while hasattr(w, "env"):
        layers.append(type(w).__name__)
        w = w.env
    assert "FireResetEnv" not in layers


def test_make_atari_env_without_ale_raises_import_error():
    with pytest.raises(ImportError):
        make_atari_env("ALE/NoSuchGame-v5")


# ---------------------------------------------------------------- side by side with the JAX wrappers
def _layer(w, cls_name):
    while type(w).__name__ != cls_name:
        w = w.env
    return w


def _run_both(make_port, make_jax, actions, seed=0, resets_at=(), frame_stacked=False, **env_kw):
    """Drive a port stack and a JAX stack over the same script; hold every
    output equal. Returns the two underlying envs."""
    pe, je = FakeAtari(pattern=True, **env_kw), FakeAtari(pattern=True, **env_kw)
    pw, jw = make_port(pe), make_jax(je)
    if any(type(x).__name__ == "NoopResetEnv" for x in _chain(jw)):
        _layer(jw, "NoopResetEnv")._rng = np.random.default_rng(seed)

    def same(p, j):
        if frame_stacked:
            j = np.moveaxis(np.asarray(j), -1, 0)
        assert np.asarray(p).dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(p, j)

    po, _ = pw.reset(seed=seed)
    jo, _ = jw.reset(seed=seed)
    same(po, jo)
    for i, a in enumerate(actions):
        if i in resets_at:
            po, _ = pw.reset()
            jo, _ = jw.reset()
            same(po, jo)
            continue
        p_out, j_out = pw.step(a), jw.step(a)
        same(p_out[0], j_out[0])
        assert p_out[1:4] == j_out[1:4], (i, p_out[1:4], j_out[1:4])
    assert pe.steps_taken == je.steps_taken and pe.reset_count == je.reset_count
    return pe, je


def _chain(w):
    out = [w]
    while hasattr(w, "env"):
        w = w.env
        out.append(w)
    return out


SCRIPT = dict(rewards={2: 1.0, 5: -2.0, 9: 4.0, 14: 1.0, 30: 7.0}, life_losses=(11, 26), done_at=60, episode_len=45)
ACTIONS = [int(a) for a in np.random.default_rng(0).integers(0, 4, 40)]


@pytest.mark.parametrize("name,port,jax_", [
    ("noop", lambda e: NoopResetEnv(e, 5), lambda e: jatari.NoopResetEnv(e, 5)),
    ("skip", lambda e: MaxAndSkipEnv(e, 4), lambda e: jatari.MaxAndSkipEnv(e, 4)),
    ("life", EpisodicLifeEnv, jatari.EpisodicLifeEnv),
    ("fire", FireResetEnv, jatari.FireResetEnv),
    ("warp", WarpFrame, jatari.WarpFrame),
    ("scale", ScaledFloatFrame, jatari.ScaledFloatFrame),
    ("clip", ClipRewardEnv, jatari.ClipRewardEnv),
])
def test_each_wrapper_matches_jax(name, port, jax_):
    _run_both(port, jax_, ACTIONS, resets_at=(13, 27), **SCRIPT)


def test_frame_stack_matches_jax_with_the_stack_axis_moved():
    _run_both(lambda e: FrameStack(WarpFrame(e), 4), lambda e: jatari.FrameStack(jatari.WarpFrame(e), 4), ACTIONS,
              resets_at=(13,), frame_stacked=True, **SCRIPT)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [dict(), dict(episode_life=False, clip_rewards=False), dict(noop_max=0, frame_stack=2)])
def test_wrap_deepmind_matches_jax(seed, kw):
    """The composed stack over episodes with life losses, a real end and a
    truncation, resets in between (a fake terminal's resume included)."""
    actions = [int(a) for a in np.random.default_rng(seed).integers(0, 4, 60)]
    pe, _ = _run_both(lambda e: wrap_deepmind(e, **kw), lambda e: jatari.wrap_deepmind(e, **kw), actions, seed=seed,
                      resets_at=(4, 20, 41), frame_stacked=kw.get("frame_stack", 4) > 0, **SCRIPT)
    assert len(pe.steps_taken) > 60
