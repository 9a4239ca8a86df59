"""``examples_torch/benchmark/seed_vmap.py``, the multi-seed trainer with the seeds stacked on the env axis, against
the JAX package's ``examples/benchmark/seed_vmap.py`` on the CPU.

- The seed axis against JAX: S = 2 seeds of SAC (16-wide nets, ``seed_vmap.py``'s other hyperparameters) on 4
  HalfCheetah envs a seed, T = 2, on the plain route of both packages. The JAX side rebuilds the script's programs
  (``prefill1`` and ``megastep1``, ``jax.vmap``-ped over the seeds, keys as the script makes them) and runs one
  prefill chunk and one megastep (8 updates a seed); their scans run as Python loops over the same keys, so that
  the env step compiles once for both (the JAX HalfCheetah step's compile is most of this test's 25-45 s). The
  port's :class:`SeedStack` gets JAX's start states and, per
  seed, each step's uniform prefill actions and SAC's action noise, drawn from that seed's JAX keys, and the same
  weights. The rings after the prefill and after the megastep's collect: observations, actions and rewards at
  rtol = atol 5e-3 (the physics tolerance of ``tests/test_torch_bench_configs.py``), terminations, truncations,
  cursors and sizes exactly. The updates run on JAX's ring handed over, with each update's draws of the JAX key
  (its rows, the target's and the actor's noise): every weight, target and Adam moment within atol 1e-3 of JAX's
  and 99.9% of each tensor within 2e-6 (``tests/test_torch_bench_configs.py``'s rule for 8 Adam steps at lr 1e-3),
  the step counts equal. The Adam moments are on the gradients' scale (up to 7.6 here), so their 2e-6 grows by
  1e-5 of the value (measured: every moment within 2.4e-6 of its value relatively, float32 rounding).
- Lane equality: every lane of an S = 3 run of ``run_multiseed`` equals a one-seed run of its seed bit for bit
  (weights, targets, every optimizer tensor and step count, and the test curve), for SAC and TD3 (whose
  exploration noise draws from the seed's generator) at a tiny size. The CPU's plain physics over 3 x 2 rows gives
  each row the bits of 2 rows alone (measured: max |diff| 0).
- The physics calls: one physics step per vector step over ``S * num_envs`` rows (train) or ``S * test_episodes``
  rows (test), counted at ``MujocoEnv``'s call of ``fused_step`` (on CPU tensors its plain version).
- ``main`` at a tiny size (the factories against the JAX factories: ``tests/test_torch_benchmark_scripts.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples_torch.benchmark import seed_vmap
from tests.test_torch_continuous_offpolicy import adam_moments, jax_state, port_state
from tianshou_tpu.algorithm.modelfree.sac import SAC as JSAC
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.data.collector import DeviceCollector as JCollector
from tianshou_tpu.env.core import VectorDeviceEnv as JVectorDeviceEnv
from tianshou_tpu.env.mujoco import HalfCheetah as JHalfCheetah
from tianshou_tpu.models import continuous as jcont
from tianshou_tpu_torch.algorithm.base import ActOut, Draws
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.mujoco import make
from tianshou_tpu_torch.models import continuous
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

S, E, T, SLOTS, BATCH, HID = 2, 4, 2, 8, 32, (16, 16)
OBS, A = 17, 6
N_UPDATES = T * E  # update_per_step 1
PHYS_TOL = dict(rtol=5e-3, atol=5e-3)
RING_FLOAT, RING_EXACT = ("obs", "act", "rew", "obs_next"), ("terminated", "truncated")
TINY = dict(epochs=2, epoch_num_steps=8, num_envs=2, chunk_len=2, start_steps=4, test_episodes=2, buffer_size=64,
            batch_size=4, device="cpu", env_overrides={"max_episode_steps": 6}, verbose=False)


def t(x):
    return torch.from_numpy(np.array(x))


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def lane(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# the JAX script's programs, rebuilt at the small size
# ---------------------------------------------------------------------------
def jax_run(seeds):
    """``seed_vmap.py``'s ``run_multiseed`` up to one prefill chunk and one megastep, vmapped over ``seeds``;
    returns what the port needs and what it is held to. The script's ``lax.scan``s over a chunk's keys and over the
    updates' keys run as Python loops over the same keys, and only the env step and ``algo.update`` are compiled
    (each once, so that the two chunks share one compile of the physics)."""
    env = JHalfCheetah()
    algo = JSAC(actor=jcont.ContinuousActorProbabilistic(hidden_sizes=HID, action_dim=A, conditioned_sigma=True),
                critic=jcont.ContinuousCritic(hidden_sizes=HID), action_space=env.action_space,
                policy_optim=JAdam(lr=1e-3), critic_optim=JAdam(lr=1e-3),
                alpha=0.2, tau=0.005, gamma=0.99, n_step_return_horizon=1)
    buffer = JVRB(total_size=E * SLOTS, buffer_num=E)
    example = JBatch(obs=jnp.zeros(OBS), act=jnp.zeros(A), rew=jnp.float32(0), terminated=jnp.bool_(False),
                     truncated=jnp.bool_(False), obs_next=jnp.zeros(OBS))
    venv = JVectorDeviceEnv(env, E)
    venv._step, venv._reset = jax.jit(venv._step), jax.jit(venv._reset)
    train_c = JCollector(venv, algo, buffer)
    update = jax.jit(lambda ts, bstate, key: algo.update(ts, buffer, bstate, key, BATCH)[:2])

    def init_seed(key):
        k1, k2 = jax.random.split(key)
        return algo.init(k1, jnp.zeros(OBS)), train_c.reset(k2), buffer.init(example)

    seed_keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))
    tss, cstates, bstates = jax.jit(jax.vmap(init_seed))(seed_keys)

    def collect(ts, cstate, bstate, key, random):
        for k in jax.random.split(key, T):
            (cstate, bstate), _ = train_c._step_fn(ts, (cstate, bstate), k, training=True, store=True,
                                                   keep_rollout=False, random=random)
        return cstate, bstate

    def prefill1(ts, cstate, bstate, key):
        return collect(ts, cstate, bstate, key, random=True)

    def megastep1(ts, cstate, bstate, key):
        k_c, k_u = jax.random.split(key)
        cstate, bstate = collect(ts, cstate, bstate, k_c, random=False)
        for k in jax.random.split(k_u, N_UPDATES):
            ts, bstate = update(ts, bstate, k)
        return ts, cstate, bstate

    def split_all(key):
        ks = jax.vmap(lambda k: jax.random.split(k, 2))(key)
        return ks[:, 0], ks[:, 1]

    keys = jax.vmap(jax.random.fold_in)(seed_keys, jnp.full(len(seeds), 7, jnp.uint32))
    keys, k_pre = split_all(keys)
    cstates_pre, bstates_pre = jax.vmap(prefill1)(tss, cstates, bstates, k_pre)
    keys, k_mega = split_all(keys)
    tss2, _, bstates2 = jax.vmap(megastep1)(tss, cstates_pre, bstates_pre, k_mega)

    def act_keys(key):  # _step_fn's k_act of each step of a chunk from ``key``
        return [jax.random.split(k, 4)[0] for k in jax.random.split(key, T)]

    @jax.jit
    def seed_draws(k_pre, k_mega, ring):
        """Seed i's draws: each prefill step's uniform actions, each megastep step's action noise (SAC's
        ``dist.sample``), and each update's rows and noise (``algo.update``'s k1, k2, k3)."""
        prefill = [jax.vmap(env.action_space.sample)(jax.random.split(k, E)) for k in act_keys(k_pre)]
        k_c, k_u = jax.random.split(k_mega)
        noise = [jax.random.normal(k, (E, A), jnp.float32) for k in act_keys(k_c)]
        updates = []
        for k in jax.random.split(k_u, N_UPDATES):
            k1, k2, k3 = jax.random.split(k, 3)
            updates.append((buffer.sample_indices(ring, k1, BATCH), jax.random.normal(k2, (BATCH, A)),
                            jax.random.normal(k3, (BATCH, A))))
        return prefill, noise, updates

    handed = []
    for i in range(len(seeds)):
        prefill, noise, updates = seed_draws(k_pre[i], k_mega[i], lane(bstates2, i))
        draws = [Draws(indices=t(idx).long(), target=t(k2), actor=t(k3)) for idx, k2, k3 in updates]
        handed.append(dict(prefill=[t(a) for a in prefill], noise=[t(n) for n in noise], draws=draws))
    return dict(tss=tss, cstates=cstates, bstates_pre=bstates_pre, tss2=tss2, bstates2=bstates2, handed=handed)


# ---------------------------------------------------------------------------
# the port with the JAX draws handed over
# ---------------------------------------------------------------------------
class HandedSAC(SAC):
    """SAC acting with handed standard normals (one ``[E, A]`` array a step) and updating with handed ``Draws``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.act_noise, self.draws = [], []

    def forward(self, ts, obs, generator=None, state=None, deterministic=False):
        if deterministic:
            return super().forward(ts, obs, generator, state, deterministic)
        act, _ = self._dist(ts.model, obs).from_noise(self.act_noise.pop(0))
        return ActOut(act=act, state=state, info=Batch())

    def update(self, ts, buffer, buf_state, generator, batch_size):
        return super().update(ts, buffer, buf_state, self.draws.pop(0), batch_size)


class HandedSpace:
    """An action space whose ``sample`` pops handed samples; everything else is the space's."""

    def __init__(self, space, samples):
        self.space, self.samples = space, samples

    def sample(self, num, generator, device):
        return self.samples.pop(0)

    def __getattr__(self, name):
        return getattr(self.space, name)


def _make_handed_sac(env):
    return HandedSAC(actor=continuous.ContinuousActorProbabilistic(HID, A, conditioned_sigma=True, input_dim=OBS),
                     critic=continuous.ContinuousCritic(HID, input_dim=OBS, action_dim=A),
                     action_space=env.action_space, policy_optim=AdamOptimizerFactory(lr=1e-3),
                     critic_optim=AdamOptimizerFactory(lr=1e-3), alpha=0.2, tau=0.005, gamma=0.99,
                     n_step_return_horizon=1)


def _assert_rings(stack, jrings, what):
    for i, bs in enumerate(stack.bss):
        ring = npy(lane(jrings, i))
        for k in RING_FLOAT:
            np.testing.assert_allclose(bs.data[k].numpy(), ring.data[k], **PHYS_TOL, err_msg=f"{what} seed {i} {k}")
        for k in RING_EXACT:
            np.testing.assert_array_equal(bs.data[k].numpy(), ring.data[k], err_msg=f"{what} seed {i} {k}")
        for k in ("cursor", "size"):
            np.testing.assert_array_equal(getattr(bs, k).numpy(), getattr(ring, k), err_msg=f"{what} seed {i} {k}")


def _assert_by_the_burst_rule(got: dict, want: dict, what: str, rel: float = 0.0):
    """Every value within atol 1e-3 of JAX's, and 99.9% of each tensor within 2e-6 (plus ``rel`` times the value:
    Adam's moments are on the gradients' scale, up to 7.6 here against weights of about 0.5)."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g, w = got[k].detach().numpy(), w.detach().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=f"{what} {k}")
        assert np.mean(np.abs(g - w) <= 2e-6 + rel * np.abs(w)) >= 0.999, f"{what} {k}"


def test_the_seed_axis_matches_the_jax_programs():
    seeds = [0, 1]
    want = jax_run(seeds)
    env = make("HalfCheetah")
    stack = seed_vmap.SeedStack(_make_handed_sac, env, seeds, E, T, N_UPDATES, BATCH, E * SLOTS, 2, "cpu")
    for i, (algo, ts) in enumerate(zip(stack.algos, stack.tss)):  # JAX's weights for seed i
        jts = npy(lane(want["tss"], i))
        ts.model.load_state_dict(actor_critic_params_from_flax(jts.params, ts.model))
        ts.target.load_state_dict(actor_critic_params_from_flax(jts.target_params, ts.target))
        algo.act_noise = list(want["handed"][i]["noise"])
        algo.draws = list(want["handed"][i]["draws"])
    # JAX's start states, seed i's envs in rows [i * E, (i + 1) * E)
    jc = npy(want["cstates"])
    for dst, src in ((stack.cstate.env_state.q, jc.env_state.q), (stack.cstate.env_state.qd, jc.env_state.qd),
                     (stack.cstate.env_state.t, jc.env_state.t), (stack.cstate.obs, jc.obs)):
        dst.copy_(t(src).reshape(dst.shape))
    # each step's uniform actions, seed by seed as the step draws them
    env.action_space = HandedSpace(env.action_space, [want["handed"][i]["prefill"][s] for s in range(T)
                                                      for i in range(S)])

    stack.prefill()
    assert env.action_space.samples == []
    _assert_rings(stack, want["bstates_pre"], "prefill")
    stack.collect()  # the megastep's collect
    assert all(algo.act_noise == [] for algo in stack.algos)
    _assert_rings(stack, want["bstates2"], "megastep collect")
    for i, bs in enumerate(stack.bss):  # the updates run on JAX's ring
        ring = npy(lane(want["bstates2"], i))
        for k in (*RING_FLOAT, *RING_EXACT):
            bs.data[k].copy_(t(ring.data[k]))
    stack.updates()
    for i, (algo, ts) in enumerate(zip(stack.algos, stack.tss)):
        assert algo.draws == []
        jts = lane(want["tss2"], i)
        assert int(ts.step) == int(jts.step) == N_UPDATES
        _assert_by_the_burst_rule(port_state(ts), jax_state(jts, ts), f"seed {i} weights")
        theirs, ours = adam_moments(jts, ts)
        _assert_by_the_burst_rule(ours, theirs, f"seed {i} Adam", rel=1e-5)


# ---------------------------------------------------------------------------
# lanes, physics calls, main
# ---------------------------------------------------------------------------
def _tensors(x, path=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _tensors(v, f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for k, v in enumerate(x):
            yield from _tensors(v, f"{path}/{k}")
    elif torch.is_tensor(x):
        yield path, x


@pytest.fixture
def physics_calls(monkeypatch):
    """The rows of every physics step ``MujocoEnv`` takes through ``fused_step``."""
    from tianshou_tpu_torch.env.mujoco import base

    rows = []
    step = base.fused_step

    def counted(model, q, *args, **kwargs):
        rows.append(q.shape[0])
        return step(model, q, *args, **kwargs)

    monkeypatch.setattr(base, "fused_step", counted)
    return rows


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_every_lane_equals_a_one_seed_run_of_its_seed(algo, tmp_path, physics_calls):
    seeds = [0, 1, 2]
    stacked = seed_vmap.run_multiseed(algo, "HalfCheetah", seeds, save_params=str(tmp_path / "s3.pt"), **TINY)
    # one physics step per vector step over every seed's rows (3 x 2): a prefill chunk of 2 steps, then 2 epochs
    # of 2 megasteps of 2 steps and a test of 6 steps (over 3 x 2 test envs)
    assert physics_calls == [6] * (2 + 2 * (2 * 2 + 6))
    assert [r["env_step"] for r in stacked] == [20] * 3
    payload = torch.load(tmp_path / "s3.pt")
    assert payload["seeds"] == seeds and payload["algo"] == algo and len(payload["tss"]) == 3
    for i, seed in enumerate(seeds):
        alone = seed_vmap.run_multiseed(algo, "HalfCheetah", [seed], save_params=str(tmp_path / "s1.pt"), **TINY)
        assert alone[0]["curve"] == stacked[i]["curve"] and alone[0]["best_reward"] == stacked[i]["best_reward"]
        got, want = dict(_tensors(payload["tss"][i])), dict(_tensors(torch.load(tmp_path / "s1.pt")["tss"][0]))
        assert got.keys() == want.keys() and len(got) > 20
        for k in got:
            assert torch.equal(got[k], want[k]), (seed, k)
    assert int(payload["tss"][0]["step"]) == 2 * 2 * 4  # 2 epochs of 2 megasteps of 4 updates


def test_the_physics_steps_once_per_vector_step_over_every_seed(physics_calls):
    """S = 2 seeds of 3 envs, 2 test envs a seed: the train steps over 6 rows, the test steps over 4."""
    env = make("HalfCheetah")
    env.max_episode_steps = 5
    stack = seed_vmap.SeedStack(seed_vmap._make_sac, env, [3, 4], 3, 2, 1, 4, 60, 2, "cpu")
    physics_calls.clear()
    stack.prefill()
    stack.megastep()
    rews = stack.test(5)
    assert physics_calls == [6] * 4 + [4] * 5
    assert rews.shape == (2,) and np.isfinite(rews).all()
    assert [int(bs.size.sum()) for bs in stack.bss] == [12, 12] and [int(ts.step) for ts in stack.tss] == [1, 1]


def test_main_trains_every_seed(monkeypatch, capsys):
    cut = {k: v for k, v in TINY.items() if k not in ("epochs", "epoch_num_steps", "device")}
    monkeypatch.setattr(seed_vmap, "run_multiseed", functools.partial(seed_vmap.run_multiseed, **cut))
    out = seed_vmap.main(["--algo", "ddpg", "--seeds", "5,6", "--epochs", "1", "--epoch-num-steps", "4",
                          "--device", "cpu"])
    assert [r["seed"] for r in out] == [5, 6]
    for r in out:
        assert np.isfinite(r["best_reward"]) and len(r["curve"]) == 1 and r["env_step"] == 8
        assert r["agent_steps_per_s"] > 0
    text = capsys.readouterr().out
    assert "seed 5: best" in text and "seed 6: best" in text
