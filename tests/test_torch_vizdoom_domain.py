"""The port's ViZDoom domain (``examples_torch/vizdoom/``) against the JAX
package's (``examples/vizdoom/``).

- The button tables, ``RES``, ``STACK`` and the nearest-neighbour resize equal.
- ``SyntheticDoom._obs`` bit-equal over every heading x target x dist in
  [0, 30] (46,656 states), and ``reset_from`` / ``step_from`` under
  ``FrameStack(·, 4)`` bit-equal to the JAX env's ``reset`` / ``step`` with the
  draws of the JAX keys handed over: a random-action run of 3 envs over 250
  steps (the 200-step truncation and a reset inside it), and the scripted
  optimal play of ``tests/test_vizdoom_domain.py`` (the same medikit count).
- ``VizdoomEnv`` in both packages over one stub ``vizdoom`` module: frames,
  rewards, terminations and truncations equal on a normal and a battle map;
  ``make_vizdoom_env``'s two branches.
- ``C51Net`` and the PPO script's ``PixelActor`` / ``PixelCritic`` at 40x60
  against the flax nets with converted weights: the JAX scripts' bf16 nets at
  atol 2e-3 on C51's probabilities (the tolerance of
  ``tests/test_torch_rainbow.py``'s bf16 C51Net) and 1e-2 on the actor's
  logits and the critic's values (bf16 trunks whose 512 features round apart
  by an ulp, summed by float32 heads); float32 twins at rtol 1e-4 / atol 1e-5,
  which also holds the SAME padding at this width (15 -> 8 at stride 2).
- One C51 update and one PPO minibatch step on SyntheticDoom frames with the
  float32 twins. C51: the loss at rtol 1e-4 / atol 1e-5, every weight within
  1e-4 and 99.9% of each tensor within 2e-6 (the one-Adam-step tolerance of
  ``tests/test_torch_rainbow.py``). PPO: the stats at 1e-4; Adam's moments
  (the gradients, after one step) within 5e-3 of their norm per tensor (the
  actor's conv layers, whose cotangent is the softmax gradient with rows that
  sum to zero, carry the float order's error at about 2e-3 of their norm,
  every other tensor at about 3e-5); 99.5% of each weight tensor within 2e-6
  and all within 2 lr: a first Adam step moves a weight by about lr times
  the sign of its gradient, and a gradient that cancels to a few 1e-6 over
  these mostly-zero frames can take either sign in another float order.
- What each script builds against what the JAX script builds (the
  hyper-parameters, the nets' sizes, the ring, the trainer's parameters);
  a tiny run of each through ``main(["--device", "cpu"])`` on
  ``SyntheticDoom``, and one on the stub's real-game branch (host collectors
  and trainers over forked subprocess envs); ``main([])`` raises without a
  GPU. The parsers are held in
  ``tests/test_torch_examples_cli.py``.
"""

import functools
import importlib.util
import math
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

import tianshou_tpu.trainer.trainer as jtrainer
import tianshou_tpu_torch.trainer.trainer as ttrainer
from examples_torch.vizdoom import env as tenv
from examples_torch.vizdoom import vizdoom_c51, vizdoom_ppo
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from tests.test_torch_examples_builders import (
    _capture,
    _eps_schedules_agree,
    abstract_jax_init,
    assert_same_hyperparameters,
    assert_same_net_fields,
    assert_same_nets,
    assert_same_trainers,
    run_jax_script,
    run_port_script,
)
from tests.test_torch_onpolicy import adam_states, by_name, jax_perms
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.wrappers import FrameStack
from tianshou_tpu_torch.models.atari import C51Net
from tianshou_tpu_torch.models.convert import (
    actor_critic_params_from_flax,
    c51net_params_from_flax,
    module_params_from_flax,
)

REPO = Path(__file__).resolve().parents[1]
JAX_DOOM = REPO / "examples" / "vizdoom"
F32 = dict(rtol=1e-4, atol=1e-5)
N_HEAD = 36


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jenv():
    """The JAX package's ``examples/vizdoom/env.py``, under a name of its own."""
    return _load("jax_examples_vizdoom_env", JAX_DOOM / "env.py")


@pytest.fixture(scope="module")
def jppo(jenv):
    """The JAX ``vizdoom_ppo.py`` module (its ``PixelActor`` and ``PixelCritic``); it imports its sibling as
    ``env``, which is put in place for the load and taken out after it."""
    saved = sys.modules.get("env")
    sys.modules["env"] = jenv
    try:
        return _load("jax_examples_vizdoom_ppo", JAX_DOOM / "vizdoom_ppo.py")
    finally:
        if saved is None:
            sys.modules.pop("env", None)
        else:
            sys.modules["env"] = saved


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# tables and the synthetic game
# ---------------------------------------------------------------------------
def test_button_tables_and_resize_equal_jax(jenv):
    assert tenv.normal_button_comb() == jenv.normal_button_comb()
    assert tenv.battle_button_comb() == jenv.battle_button_comb()
    assert (len(tenv.normal_button_comb()), len(tenv.battle_button_comb())) == (6, 108)
    assert (tenv.RES, tenv.STACK) == (jenv.RES, jenv.STACK) == ((40, 60, 1), 4)
    img = np.random.default_rng(0).integers(0, 256, (120, 160), dtype=np.uint8)
    for h, w in ((40, 60), (7, 11), (120, 160), (200, 300)):
        np.testing.assert_array_equal(tenv._resize_nearest(img, h, w), jenv._resize_nearest(img, h, w))


def test_synthetic_doom_obs_is_bit_equal_over_every_state(jenv):
    jgame, game = jenv.SyntheticDoom(), tenv.SyntheticDoom()
    assert (game.n_headings, game.max_episode_steps, game.action_space.n) == (N_HEAD, 200, 6)
    assert tuple(game.observation_space.shape) == jgame.observation_space.shape == (40, 60, 1)
    heading, target = np.meshgrid(np.arange(N_HEAD, dtype=np.int32), np.arange(N_HEAD, dtype=np.int32), indexing="ij")
    heading, target = heading.ravel(), target.ravel()
    jobs = jax.jit(jax.vmap(jgame._obs))
    lit = 0
    for dist in range(31):
        d = np.full_like(heading, dist)
        want = np.asarray(jobs(jenv._DoomState(jnp.asarray(heading), jnp.asarray(target), jnp.asarray(d),
                                               jnp.zeros_like(jnp.asarray(d)))))
        s = tenv._DoomState(*(torch.from_numpy(x) for x in (heading, target, d, np.zeros_like(d))))
        got = game._obs(s)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (N_HEAD * N_HEAD, 40, 60, 1)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"dist {dist}")
        lit += int((want[:, : 30] > 0).sum())
    assert lit > 0  # the medikit column is drawn, not only the floor


class _Handed:
    """The port's game with the draws handed over: ``reset`` and ``step`` pop them from queues."""

    def __init__(self, game):
        self.game, self.resets, self.targets = game, [], []
        self.observation_space, self.action_space = game.observation_space, game.action_space
        self.max_episode_steps = game.max_episode_steps

    def reset(self, num_envs, generator, device):
        return self.game.reset_from(*self.resets.pop(0))

    def step(self, state, action, generator):
        return self.game.step_from(state, action, self.targets.pop(0))


_randint = jax.jit(jax.vmap(lambda k: jax.random.randint(k, (), 0, N_HEAD)))
_first_half = jax.jit(jax.vmap(lambda k: jax.random.split(k)[0]))


def _draw(keys):
    """``randint(k, (), 0, 36)`` for each key."""
    return torch.from_numpy(np.array(_randint(keys)))


def test_reset_and_step_are_bit_equal_to_jax_with_handed_draws(jenv):
    from tianshou_tpu.env.wrappers import FrameStack as JFrameStack

    E, steps = 3, 250
    jstack = JFrameStack(jenv.SyntheticDoom(), 4)
    handed = _Handed(tenv.SyntheticDoom())
    tstack = FrameStack(handed, 4)
    jreset, jstep = jax.jit(jax.vmap(jstack.reset)), jax.jit(jax.vmap(jstack.step))

    def reset(key):
        keys = jax.random.split(key, E)
        kt_kh = jax.vmap(jax.random.split)(keys)  # SyntheticDoom.reset: kt, kh = split(key)
        handed.resets.append((_draw(kt_kh[:, 1]), _draw(kt_kh[:, 0])))
        return jreset(keys), tstack.reset(E, None, "cpu")

    (js, jobs), (ts, tobs) = reset(jax.random.key(0))
    rng = np.random.default_rng(0)
    rewards = resets = 0
    for t in range(steps):
        assert tuple(tobs.shape) == (E, 4, 40, 60, 1) == jobs.shape
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        # mostly forward, so that medikits are collected and new targets drawn
        act = np.where(rng.random(E) < 0.6, 3, rng.integers(0, 6, E))
        keys = jax.random.split(jax.random.key(t + 1), E)
        handed.targets.append(_draw(_first_half(keys)))  # SyntheticDoom.step: kt, kd = split(key)
        jout = jstep(js, jnp.asarray(act, jnp.int32), keys)
        tout = tstack.step(ts, torch.from_numpy(act), None)
        for name in ("heading", "target", "dist", "t"):
            got = getattr(tout.state.inner, name)
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jout.state.inner, name)), err_msg=name)
        np.testing.assert_array_equal(tout.obs.numpy(), np.asarray(jout.obs))
        np.testing.assert_array_equal(tout.reward.numpy(), np.asarray(jout.reward))
        assert tout.reward.dtype == torch.float32
        np.testing.assert_array_equal(tout.terminated.numpy(), np.asarray(jout.terminated))
        np.testing.assert_array_equal(tout.truncated.numpy(), np.asarray(jout.truncated))
        rewards += int(np.asarray(jout.reward).sum())
        (js, jobs), (ts, tobs) = (jout.state, jout.obs), (tout.state, tout.obs)
        if bool(np.asarray(jout.truncated).all()):
            (js, jobs), (ts, tobs) = reset(jax.random.key(1000 + t))
            resets += 1
    assert resets == 1 and rewards > 0
    assert not handed.resets and not handed.targets


def test_scripted_optimal_play_collects_as_many_medikits_as_jax(jenv):
    """``tests/test_vizdoom_domain.py:33-53``'s play: turn toward the medikit, then walk forward."""
    jgame, game = jenv.SyntheticDoom(), tenv.SyntheticDoom()
    key = jax.random.key(0)
    js, jobs = jgame.reset(key)
    kt, kh = jax.random.split(key)
    ts, tobs = game.reset_from(_draw(kh[None]), _draw(kt[None]))
    np.testing.assert_array_equal(tobs[0].numpy(), np.asarray(jobs))
    jstep = jax.jit(jgame.step)
    jtotal, total = 0.0, 0.0
    for i in range(120):
        rel = (int(js.target) - int(js.heading)) % N_HEAD
        signed = rel - N_HEAD if rel > N_HEAD // 2 else rel
        a = 3 if abs(signed) <= 2 else (1 if signed > 0 else 2)
        key = jax.random.key(i)
        jout = jstep(js, jnp.int32(a), key)
        tout = game.step_from(ts, torch.tensor([a]), _draw(jax.random.split(key)[0][None]))
        np.testing.assert_array_equal(tout.obs[0].numpy(), np.asarray(jout.obs))
        for name in ("heading", "target", "dist", "t"):
            assert int(getattr(tout.state, name)[0]) == int(getattr(jout.state, name)), (i, name)
        js, ts = jout.state, tout.state
        jtotal += float(jout.reward)
        total += float(tout.reward[0])
    assert total == jtotal >= 2.0


# ---------------------------------------------------------------------------
# the real game's host adapter, over a stub vizdoom
# ---------------------------------------------------------------------------
def _stub_vizdoom() -> types.ModuleType:
    """A ``vizdoom`` module whose ``DoomGame`` plays a seeded numpy game: a 120x160 screen drawn from the seed and
    the tic, health moving both ways, kills and ammo, death at zero health (no screen then), the episode's end
    after 48 tics."""
    vzd = types.ModuleType("vizdoom")

    class GameVariable:
        HEALTH, KILLCOUNT, AMMO2 = "health", "killcount", "ammo2"

    class _State:
        def __init__(self, screen):
            self.screen_buffer = screen

    class DoomGame:
        LIMIT = 48

        def __init__(self):
            self.seed, self.episode = 0, 0

        def load_config(self, path):
            self.cfg = path

        def init(self):
            pass

        def set_seed(self, seed):
            self.seed = seed

        def new_episode(self, *lmp):
            self.episode += 1
            self.rng = np.random.default_rng((self.seed, self.episode))
            self.tic, self.vars = 0, {"health": 25.0, "killcount": 0.0, "ammo2": 50.0}

        def get_state(self):  # a screen at the time limit too, so that the adapter's truncation branch runs
            if self.is_player_dead():
                return None
            screen = np.random.default_rng((self.seed, self.episode, self.tic)).integers(0, 256, (120, 160))
            return _State(screen.astype(np.uint8))

        def get_game_variable(self, name):
            return self.vars[name]

        def make_action(self, buttons, skip):
            self.tic += skip
            v = self.vars
            v["health"] += float(self.rng.integers(-12, 10)) + 0.5 * sum(buttons)
            v["killcount"] += float(self.rng.random() < 0.25)
            v["ammo2"] -= float(self.rng.integers(0, 3))

        def is_player_dead(self):
            return self.vars["health"] <= 0

        def is_episode_finished(self):
            return self.is_player_dead() or self.tic >= self.LIMIT

        def close(self):
            pass

    vzd.GameVariable, vzd.DoomGame = GameVariable, DoomGame
    return vzd


@pytest.mark.parametrize("cfg", ["D1_basic.cfg", "D3_battle.cfg"])
def test_vizdoom_env_host_adapter_equals_jax(jenv, cfg, monkeypatch):
    monkeypatch.setitem(sys.modules, "vizdoom", _stub_vizdoom())
    jgame, game = jenv.VizdoomEnv(cfg), tenv.VizdoomEnv(cfg)
    n = 108 if "battle" in cfg else 6
    assert game.action_space.n == jgame.action_space.n == n
    assert tuple(game.observation_space.shape) == jgame.observation_space.shape == (4, 40, 60)
    assert game.available_actions == jgame.available_actions
    rng = np.random.default_rng(1)
    jo, _ = jgame.reset(seed=7)
    to, _ = game.reset(seed=7)
    seen = {"terminated": 0, "truncated": 0, "negative": 0}
    for _ in range(120):
        np.testing.assert_array_equal(to, jo)
        assert to.dtype == np.uint8 and to.shape == (4, 40, 60)
        a = int(rng.integers(0, n))
        jo, jr, jterm, jtrunc, _ = jgame.step(a)
        to, tr, tterm, ttrunc, _ = game.step(a)
        assert (tr, tterm, ttrunc) == (jr, jterm, jtrunc)
        assert type(tr) is float and type(tterm) is bool and type(ttrunc) is bool
        seen["terminated"] += tterm
        seen["truncated"] += ttrunc
        seen["negative"] += tr < 0
        if tterm or ttrunc:
            jo, _ = jgame.reset()
            to, _ = game.reset()
    assert seen["terminated"] and seen["truncated"] and seen["negative"], seen
    game.close()
    jgame.close()


def test_vizdoom_env_needs_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "vizdoom", None)  # an import of it raises ImportError
    with pytest.raises(ImportError, match="vizdoom is not installed"):
        tenv.VizdoomEnv("D1_basic.cfg")


def test_make_vizdoom_env_falls_back_to_the_device_game_and_takes_the_real_one(jenv, monkeypatch):
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.venvs import SubprocVectorEnv

    monkeypatch.setitem(sys.modules, "vizdoom", None)
    env, train_envs, test_envs = tenv.make_vizdoom_env(num_training_envs=4, num_test_envs=2, device="cpu")
    jgame, jtrain, jtest = jenv.make_vizdoom_env(num_training_envs=4, num_test_envs=2)
    assert isinstance(env, FrameStack) and isinstance(env.env, tenv.SyntheticDoom) and env.n_frames == 4
    assert isinstance(train_envs, VectorDeviceEnv) and (train_envs.num_envs, test_envs.num_envs) == (4, 2)
    assert (jtrain.num_envs, jtest.num_envs) == (4, 2) and type(jgame.env).__name__ == "SyntheticDoom"
    assert tuple(env.observation_space.shape) == jgame.observation_space.shape == (4, 40, 60, 1)
    assert train_envs.device.type == "cpu" and env.action_space.n == jgame.action_space.n == 6
    _, obs = train_envs.reset(torch.Generator().manual_seed(0))
    assert obs.dtype == torch.uint8 and tuple(obs.shape) == (4, 4, 40, 60, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        tenv.make_vizdoom_env(num_training_envs=1, num_test_envs=1)
    # with the package: the real game's subprocess envs (forked; the stub module is inherited)
    monkeypatch.setitem(sys.modules, "vizdoom", _stub_vizdoom())
    env, train_envs, test_envs = tenv.make_vizdoom_env("D3_battle", num_training_envs=2, num_test_envs=1)
    try:
        assert isinstance(env, tenv.VizdoomEnv) and env.action_space.n == 108
        assert isinstance(train_envs, SubprocVectorEnv) and (len(train_envs), len(test_envs)) == (2, 1)
        assert env.game.cfg.endswith("examples_torch/vizdoom/maps/D3_battle.cfg")
        obs, _ = train_envs.reset(seed=3)  # seeds 3 and 4
        assert obs.shape == (2, 4, 40, 60) and obs.dtype == np.uint8
        for i in range(2):
            np.testing.assert_array_equal(obs[i], env.reset(seed=3 + i)[0])
            env.game.episode = 0  # each worker's game is on its first episode
    finally:
        train_envs.close()
        test_envs.close()


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------
class JC51Net32(fnn.Module):
    """The JAX C51Net over a float32 NatureCNN."""

    action_dim: int
    num_atoms: int
    features: int

    @fnn.compact
    def __call__(self, x):
        from tianshou_tpu.models.atari import NatureCNN

        logits = fnn.Dense(self.action_dim * self.num_atoms)(NatureCNN(self.features, jnp.float32)(x))
        return fnn.softmax(logits.reshape(-1, self.action_dim, self.num_atoms), axis=-1)


class JPixelActor32(fnn.Module):
    """The JAX script's ``PixelActor`` over a float32 NatureCNN."""

    action_dim: int
    features: int

    @fnn.compact
    def __call__(self, obs):
        from tianshou_tpu.models.atari import NatureCNN

        return fnn.Dense(self.action_dim)(NatureCNN(self.features, jnp.float32)(obs))


class JPixelCritic32(fnn.Module):
    """The JAX script's ``PixelCritic`` over a float32 NatureCNN."""

    features: int

    @fnn.compact
    def __call__(self, obs):
        from tianshou_tpu.models.atari import NatureCNN

        return NatureCNN(self.features, jnp.float32)(obs) @ self.param(
            "w", fnn.initializers.lecun_normal(), (self.features, 1))


def _doom_frames(n: int, seed: int = 0) -> np.ndarray:
    """``[n, 4, 40, 60, 1]`` stacks of SyntheticDoom frames from random states."""
    rng = np.random.default_rng(seed)
    s = tenv._DoomState(*(torch.from_numpy(rng.integers(lo, hi, 4 * n, dtype=np.int32))
                          for lo, hi in ((0, N_HEAD), (0, N_HEAD), (1, 26), (0, 1))))
    return tenv.SyntheticDoom()._obs(s).numpy().reshape(n, 4, 40, 60, 1)


def _pixel_pair(jppo, kind: str, f32: bool, features: int = 512):
    """(flax module, its params, port net with the converted weights): the JAX scripts' bf16 nets, or float32
    twins of ``features`` features."""
    from tianshou_tpu.models.atari import C51Net as JC51Net

    dtype = torch.float32 if f32 else torch.bfloat16
    if kind == "c51":
        jnet = JC51Net32(6, 51, features) if f32 else JC51Net(6, 51)
        tnet = C51Net(6, 51, features, compute_dtype=dtype, input_hw=(40, 60))
    elif kind == "actor":
        jnet = JPixelActor32(6, features) if f32 else jppo.PixelActor(6)
        tnet = vizdoom_ppo.PixelActor(6, features, compute_dtype=dtype)
    else:
        jnet = JPixelCritic32(features) if f32 else jppo.PixelCritic()
        tnet = vizdoom_ppo.PixelCritic(features, compute_dtype=dtype)
    params = _np(jax.jit(jnet.init)(jax.random.key(3), jnp.zeros((1, 4, 40, 60, 1), jnp.uint8)))
    if kind == "c51":
        tnet.load_state_dict(c51net_params_from_flax(params, flat_hw=tnet.cnn.flat_hw))
    else:
        tnet.load_state_dict(module_params_from_flax(params, tnet))  # through the class's converter
    return jnet, params, tnet


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "float32"])
@pytest.mark.parametrize("kind", ["c51", "actor", "critic"])
def test_the_nets_at_40x60_match_flax(jppo, kind, f32):
    jnet, params, tnet = _pixel_pair(jppo, kind, f32, features=64 if f32 else 512)
    assert tnet.cnn.flat_hw == (5, 8) and tnet.cnn.fc.in_features == 5 * 8 * 64  # 40x60 -> 10x15 -> 5x8 -> 5x8
    assert np.asarray(params["params"]["NatureCNN_0"]["Dense_0"]["kernel"]).shape[0] == 2560
    frames = _doom_frames(5)
    want = np.asarray(jnet.apply(params, jnp.asarray(frames)))
    got = tnet(torch.from_numpy(frames)).detach()
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if f32:
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3 if kind == "c51" else 1e-2)


def test_the_atari_pixel_critic_converts_through_the_same_class_rule():
    """``PixelCritic`` names the Atari runner's critic too (``Dense_0`` -> ``head``, 84x84)."""
    from examples_torch.atari._runner import PixelCritic
    from tests.test_torch_examples_cli import _jax_runner

    jnet = _jax_runner().PixelCritic()
    frames = np.random.default_rng(0).integers(0, 256, (2, 4, 84, 84, 1), dtype=np.uint8)
    params = _np(jax.jit(jnet.init)(jax.random.key(3), jnp.asarray(frames)))
    tnet = PixelCritic()
    tnet.load_state_dict(module_params_from_flax(params, tnet))
    want = np.asarray(jnet.apply(params, jnp.asarray(frames)))
    np.testing.assert_allclose(tnet(torch.from_numpy(frames)).detach().numpy(), want, rtol=0, atol=1e-2)


def test_the_converter_refuses_a_map_it_cannot_place():
    from tianshou_tpu_torch.models.convert import nature_cnn_params_from_flax

    tree = {f"Conv_{i}": {"kernel": np.zeros((3, 3, 4, 64), np.float32), "bias": np.zeros(64, np.float32)}
            for i in range(3)}
    tree["Dense_0"] = {"kernel": np.zeros((2560, 8), np.float32), "bias": np.zeros(8, np.float32)}
    with pytest.raises(ValueError, match="not a square map"):
        nature_cnn_params_from_flax(tree)
    with pytest.raises(ValueError, match=r"not a \(5, 7\) map"):
        nature_cnn_params_from_flax(tree, flat_hw=(5, 7))
    assert nature_cnn_params_from_flax(tree, flat_hw=(5, 8))["fc.weight"].shape == (8, 2560)


# ---------------------------------------------------------------------------
# one update of each algorithm on doom frames
# ---------------------------------------------------------------------------
def test_one_c51_update_on_doom_frames_matches_jax():
    from tianshou_tpu.algorithm.modelfree.c51 import C51 as JC51
    from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
    from tianshou_tpu.data.batch import Batch as JBatch
    from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
    from tianshou_tpu.env import core as jcore
    from tianshou_tpu_torch.algorithm.modelfree.c51 import C51
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.env import core as tcore

    E, C, FEAT = 2, 12, 32
    kw = dict(num_atoms=51, v_min=-10.0, v_max=10.0, gamma=0.99, n_step_return_horizon=3, target_update_freq=500)
    jalgo = JC51(model=JC51Net32(6, 51, FEAT), action_space=jcore.Discrete(6), optim=JAdam(lr=1e-3), **kw)
    jts = jax.jit(jalgo.init)(jax.random.key(0), jnp.zeros((4, 40, 60, 1), jnp.uint8))
    net = C51Net(6, 51, FEAT, compute_dtype=torch.float32, input_hw=(40, 60))
    net.load_state_dict(c51net_params_from_flax(_np(jts.params["model"]), flat_hw=net.cnn.flat_hw))
    talgo = C51(model=net, action_space=tcore.Discrete(6), optim=AdamOptimizerFactory(lr=1e-3), **kw)
    tts = talgo.init("cpu")
    ring = dict(stack_num=4, save_only_last_obs=True)
    jb, tb = JVRB(E * C, E, **ring), VectorReplayBuffer(E * C, E, **ring)
    ex = dict(obs=np.zeros((40, 60, 1), np.uint8), act=np.int32(0), rew=np.float32(0), terminated=np.bool_(False),
              truncated=np.bool_(False), obs_next=np.zeros((40, 60, 1), np.uint8))
    js = jb.init(JBatch({k: jnp.asarray(v) for k, v in ex.items()}))
    ts = tb.init(Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()}), device="cpu")
    rng = np.random.default_rng(0)
    jadd = jax.jit(jb.add)
    for i in range(10):
        step = dict(obs=_doom_frames(E, seed=i), act=rng.integers(0, 6, E).astype(np.int32),
                    rew=(rng.random(E) < 0.3).astype(np.float32), terminated=np.zeros(E, bool),
                    truncated=rng.random(E) < 0.1, obs_next=_doom_frames(E, seed=100 + i))
        js, _ = jadd(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    idx = rng.integers(0, 10, 16) + C * rng.integers(0, E, 16)
    drop = jalgo.update_sample_drop_keys
    assert talgo.update_sample_drop_keys == drop == ("obs_next",)
    key = jax.random.key(1)
    jidx = jnp.asarray(idx)
    jbatch = jb.get(js, jidx, drop_keys=drop)
    jbatch = jax.jit(lambda t, s, b: jalgo.preprocess(t, jb, s, b, jidx, key))(jts, js, jbatch)
    jts2, jstats = jax.jit(jalgo.update_step)(jts, jbatch, key)
    tidx = torch.from_numpy(idx)
    tbatch = tb.get(ts, tidx, drop_keys=drop)
    assert tuple(tbatch.obs.shape) == (16, 4, 40, 60, 1)
    np.testing.assert_array_equal(tbatch.obs.numpy(), np.asarray(jbatch.obs))
    tbatch = talgo.preprocess(tts, tb, ts, tbatch, tidx, torch.Generator())
    np.testing.assert_allclose(tbatch.target_dist.numpy(), np.asarray(jbatch.target_dist), **F32)
    before = {k: v.clone() for k, v in tts.model.state_dict().items()}
    tts, tstats = talgo.update_step(tts, tbatch, None)
    np.testing.assert_allclose(tstats.loss.item(), float(jstats.loss), **F32)
    want = c51net_params_from_flax(_np(jts2.params["model"]), flat_hw=net.cnn.flat_hw)
    got = {k: v.detach().numpy() for k, v in tts.model.state_dict().items()}
    assert set(want) == set(got)
    for k, w in want.items():
        assert not np.array_equal(got[k], before[k].numpy()), k
        np.testing.assert_allclose(got[k], w.numpy(), rtol=0, atol=1e-4, err_msg=k)
        assert np.mean(np.abs(got[k] - w.numpy()) <= 2e-6) >= 0.999, k


def test_one_ppo_minibatch_step_on_doom_frames_matches_jax():
    from tianshou_tpu.algorithm.modelfree.ppo import PPO as JPPO
    from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
    from tianshou_tpu.data.batch import Batch as JBatch
    from tianshou_tpu.env import core as jcore
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.env import core as tcore

    T, E, FEAT = 8, 4, 32  # N = 32 rows: one minibatch of 32
    kw = dict(gamma=0.99, gae_lambda=0.95, eps_clip=0.2, vf_coef=0.5, ent_coef=0.01)
    jalgo = JPPO(actor=JPixelActor32(6, FEAT), critic=JPixelCritic32(FEAT), action_space=jcore.Discrete(6),
                 optim=JAdam(lr=1e-3, max_grad_norm=0.5), **kw)
    jts = jax.jit(jalgo.init)(jax.random.key(0), jnp.zeros((4, 40, 60, 1), jnp.uint8))
    talgo = PPO(actor=vizdoom_ppo.PixelActor(6, FEAT, compute_dtype=torch.float32),
                critic=vizdoom_ppo.PixelCritic(FEAT, compute_dtype=torch.float32), action_space=tcore.Discrete(6),
                optim=AdamOptimizerFactory(lr=1e-3, max_grad_norm=0.5), **kw)
    tts = talgo.init("cpu")
    tts.model.load_state_dict(actor_critic_params_from_flax(_np(jts.params), tts.model))
    rng = np.random.default_rng(0)
    roll = dict(obs=_doom_frames(T * E, 1).reshape(T, E, 4, 40, 60, 1),
                obs_next=_doom_frames(T * E, 2).reshape(T, E, 4, 40, 60, 1),
                act=rng.integers(0, 6, (T, E)), rew=(rng.random((T, E)) < 0.2).astype(np.float32),
                terminated=np.zeros((T, E), bool), truncated=rng.random((T, E)) < 0.1)
    key = jax.random.key(5)
    jts2, jstats = jalgo.update_rollout(jts, JBatch(**{k: jnp.asarray(v) for k, v in roll.items()}), key,
                                        repeat=1, batch_size=T * E)
    perm = jax_perms(key, 1, T * E)
    assert tuple(perm.shape) == (1, 1, T * E)
    _, stats = talgo.update_rollout(tts, Batch(**{k: torch.from_numpy(v) for k, v in roll.items()}), None, 1, T * E,
                                    perm=perm)
    model = tts.model
    adam = adam_states(jts2)
    params = list(model.parameters())
    for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):  # after one step: the gradients themselves
        got = by_name(model, [tts.optim.state[p][ours] for p in params])
        for k, w in actor_critic_params_from_flax(_np(theirs), model).items():
            g, w = got[k].numpy(), w.numpy()
            # the actor's conv gradients come from a cotangent whose rows sum to zero (the softmax's), and carry
            # the float order's error at about 1e-3 of their norm; every other tensor at about 3e-5
            assert np.linalg.norm(g - w) <= 5e-3 * np.linalg.norm(w), (ours, k)
    # a first Adam step moves a weight by about lr * sign(g): where a gradient cancels to a few 1e-6, another float
    # order can flip its sign and the weight then differs by up to 2 lr
    for k, w in actor_critic_params_from_flax(_np(jts2.params), model).items():
        diff = np.abs(model.state_dict()[k].numpy() - w.numpy())
        assert diff.max() <= 2e-3, k
        assert np.mean(diff <= 2e-6) >= 0.995, k
    assert int(tts.step) == int(jts2.step) == 1
    jstats = dict(jstats.items())
    assert set(stats.keys()) == set(jstats.keys())
    for k in stats.keys():
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-4, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------
SCRIPTS = {"vizdoom/vizdoom_c51.py": ("OffPolicyTrainer", "c51", "C51"),
           "vizdoom/vizdoom_ppo.py": ("OnPolicyTrainer", "ppo", "PPO")}


@pytest.mark.parametrize("rel", list(SCRIPTS))
def test_the_scripts_build_the_jax_algorithm_and_trainer(rel, monkeypatch):
    """At the scripts' full settings; the rings' ``init`` is patched out (abstract on the JAX side), since the
    100,000-frame ring is compared by its layout."""
    import importlib

    from tianshou_tpu.data.buffer.base import ReplayBuffer as JReplayBuffer
    from tianshou_tpu_torch.data.buffer.base import ReplayBuffer

    trainer_cls, module, cls = SCRIPTS[rel]
    abstract_jax_init(monkeypatch, getattr(importlib.import_module(f"tianshou_tpu.algorithm.modelfree.{module}"), cls))
    jinit = JReplayBuffer.init
    monkeypatch.setattr(JReplayBuffer, "init", lambda self, ex: jax.eval_shape(lambda e: jinit(self, e), ex))
    monkeypatch.setattr(ReplayBuffer, "init", lambda self, ex, device=None: None)
    _capture(monkeypatch, getattr(jtrainer, trainer_cls), "run")
    (jt, jts, *_), _ = run_jax_script(rel, monkeypatch, lambda s: None)
    _capture(monkeypatch, getattr(ttrainer, trainer_cls), "run")
    (tt, tts, *_), _ = run_port_script(rel)
    assert_same_hyperparameters(jt.algo, tt.algo)
    assert_same_net_fields(jt.algo, tt.algo)
    assert_same_nets(jts, tts)
    assert_same_trainers(jt, tt)
    assert (tt.train_collector.venv.num_envs, tt.test_collector.venv.num_envs) == (16, 10)
    if trainer_cls == "OffPolicyTrainer":
        _eps_schedules_agree(tt.params, jt.params)
        assert (tt.buffer.capacity * tt.buffer.num_envs, tt.buffer.num_envs) == (100_000, 16)
        assert tt.algo.model.cnn.input_hw == (40, 60) and tt.algo.model.num_atoms == 51
    else:
        assert {type(n).__name__ for n in tts.model.values()} == {"PixelActor", "PixelCritic"}
        assert tts.model["critic"].w.shape == (512, 1) and not hasattr(tts.model["critic"], "head")


#: a tiny run of each script: ``train``'s other settings cut through ``functools.partial``
TINY = {"vizdoom/vizdoom_c51.py": (dict(num_envs=4, buffer_size=400, batch_size=8, start_steps=40),
                                   ["--epochs", "1", "--epoch-num-steps", "40"]),
        "vizdoom/vizdoom_ppo.py": (dict(num_envs=2, batch_size=64), ["--epochs", "1", "--epoch-num-steps", "256"])}


@pytest.mark.parametrize("rel", list(TINY))
def test_a_doom_script_trains_on_the_cpu_through_its_main(rel, monkeypatch, capsys):
    module = vizdoom_c51 if "c51" in rel else vizdoom_ppo
    cut, argv = TINY[rel]
    monkeypatch.setattr(module, "train", functools.partial(module.train, **cut))
    res = module.main(["--device", "cpu", *argv])
    assert res.epochs == 1 and res.gradient_step > 0 and res.env_step > 0
    assert math.isfinite(res.best_reward)
    assert all(p.device.type == "cpu" and bool(torch.isfinite(p).all()) for p in res.train_state.model.parameters())
    assert f"vizdoom {'C51' if 'c51' in rel else 'PPO'} D1_basic: best_reward=" in capsys.readouterr().out


#: the real game's branch over the stub: the host collectors and trainers over forked subprocess envs
HOST = {"vizdoom/vizdoom_c51.py": (dict(num_envs=2, buffer_size=200, batch_size=8, start_steps=20),
                                   ["--task", "D3_battle", "--epochs", "1", "--epoch-num-steps", "40"],
                                   "HostOffPolicyTrainer"),
        "vizdoom/vizdoom_ppo.py": (dict(num_envs=2, batch_size=32), ["--epochs", "1", "--epoch-num-steps", "256"],
                                   "HostOnPolicyTrainer")}


@pytest.mark.parametrize("rel", list(HOST))
def test_a_doom_script_trains_the_real_game_through_the_host_path(rel, monkeypatch):
    module = vizdoom_c51 if "c51" in rel else vizdoom_ppo
    cut, argv, trainer = HOST[rel]
    monkeypatch.setitem(sys.modules, "vizdoom", _stub_vizdoom())
    monkeypatch.setattr(module, "train", functools.partial(module.train, **cut))
    monkeypatch.setattr(module, "make_vizdoom_env", functools.partial(tenv.make_vizdoom_env, num_test_envs=2))
    ran = []
    run = getattr(ttrainer, trainer).run
    monkeypatch.setattr(getattr(ttrainer, trainer), "run", lambda self, *a: ran.append(self) or run(self, *a))
    res = module.main(["--device", "cpu", *argv])
    (t,) = ran
    assert type(t.train_collector).__name__ == "HostCollector"
    assert type(t.train_collector.venv).__name__ == "SubprocVectorEnv"
    assert res.epochs == 1 and res.gradient_step > 0 and res.env_step > 0 and math.isfinite(res.best_reward)
    assert all(bool(torch.isfinite(p).all()) for p in res.train_state.model.parameters())
    if "c51" in rel:  # the host ring: one [40, 60] frame a row, stacked to [4, 40, 60] at sample time
        assert tuple(res.buf_state.data["obs"].shape[2:]) == (40, 60) and t.buffer.ignore_obs_next
        assert res.train_state.model.head.out_features == 108 * 51  # the battle map's 108 button combinations


@pytest.mark.parametrize("module", [vizdoom_c51, vizdoom_ppo], ids=["c51", "ppo"])
def test_a_doom_script_refuses_a_missing_gpu(module):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
