"""Rank programs of ``tests/test_torch_mesh_families.py``, and the setups
both sides of it build (no JAX here: the ranks import only the port).

``python -m tests._torch_mesh_families_worker RDZV WORLD RANK OUT`` joins a
gloo group of ``WORLD`` ranks at ``RDZV`` (a ``file://`` URL), runs every
case of :data:`CASES` through the mesh steps and writes what the test
compares to ``OUT/families_rank{RANK}.pt``. A case that raises records its
traceback in place of its result, so that the other cases still run.

The test process computes each case's one-process composition meanwhile
(:func:`reference`): each env slice collected in turn with its rank's
generator, then the update over the joined rollout or ring with the update
generator. :func:`world_one` runs a case through the mesh step at world
size 1 and through the plain program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import traceback
from collections.abc import Callable
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from tests._torch_mesh_worker import join, plain, rank_generator, ring_record, update_generator
from tianshou_tpu_torch.utils.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
#: off-policy: envs, ring slots per env, steps, updates, batch (the JAX mesh test's sizes, tests/test_mesh.py:90-122)
OFF_E, OFF_SLOTS, OFF_T, OFF_UPDATES, OFF_BATCH = 16, 64, 16, 4, 32
#: on-policy: envs, steps, passes, batch; the trust-region cases take one pass of two minibatches
ON_E, ON_T, ON_REPEAT, ON_BATCH = 16, 8, 2, 32
#: the board cases: envs (host TicTacToe) and steps
BOARD_E, BOARD_T = 8, 8
H = (16, 16)  # the narrow hidden widths of every net


@dataclasses.dataclass
class Case:
    build: Callable[[], tuple]     # () -> (env, algo); the env is None for the host board cases
    on_policy: bool
    envs: int
    steps: int
    ring: Callable[[int], object] | None = None      # envs -> buffer (off-policy)
    example: Callable[[], object] | None = None      # one transition (off-policy)
    repeat: int = ON_REPEAT
    batch: int = ON_BATCH
    host: bool = False                               # TicTacToe on host collectors


# ---------------------------------------------------------------------------
# setups
# ---------------------------------------------------------------------------
def _adam(lr: float = 1e-3):
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory

    return AdamOptimizerFactory(lr=lr)


def _vector_example(obs, act):
    from tianshou_tpu_torch.data.batch import Batch

    return Batch(obs=obs, act=act, rew=torch.tensor(0.0), terminated=torch.tensor(False),
                 truncated=torch.tensor(False), obs_next=tree_map(torch.clone, obs))


def _pendulum_example():
    return _vector_example(torch.zeros(3), torch.zeros(1))


def _cartpole_example():
    return _vector_example(torch.zeros(4), torch.tensor(0))


def _uniform_ring(envs: int, **kw):
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer

    return VectorReplayBuffer(OFF_SLOTS * envs, envs, **kw)


def _continuous(kind: str):
    """``examples/mujoco/mujoco_{sac,td3,redq}.py``'s algorithm over Pendulum at narrow widths."""
    from tianshou_tpu_torch.algorithm.modelfree.redq import REDQ
    from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
    from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3
    from tianshou_tpu_torch.env.classic.pendulum import Pendulum
    from tianshou_tpu_torch.exploration.noise import GaussianNoise
    from tianshou_tpu_torch.models.continuous import (
        ContinuousActorDeterministic,
        ContinuousActorProbabilistic,
        ContinuousCritic,
        EnsembleCritic,
    )

    torch.manual_seed(0)
    env = Pendulum()
    common = dict(action_space=env.action_space, policy_optim=_adam(), critic_optim=_adam(), gamma=0.99, tau=0.005)
    if kind == "td3":
        return env, TD3(actor=ContinuousActorDeterministic(H, 1, input_dim=3),
                        critic=ContinuousCritic(H, input_dim=3, action_dim=1), exploration_noise=GaussianNoise(0.1),
                        policy_noise=0.2, noise_clip=0.5, update_actor_freq=2, **common)
    actor = ContinuousActorProbabilistic(H, 1, conditioned_sigma=True, input_dim=3)
    if kind == "sac":
        return env, SAC(actor=actor, critic=ContinuousCritic(H, input_dim=3, action_dim=1), alpha=0.2, **common)
    return env, REDQ(actor=actor, critic=EnsembleCritic(4, H, input_dim=3, action_dim=1), ensemble_size=4,
                     subset_size=2, alpha="auto", actor_delay=2, **common)


def _iqn():
    from tianshou_tpu_torch.algorithm.modelfree.iqn import IQN
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.models.discrete import ImplicitQuantileNetwork

    torch.manual_seed(0)
    env = CartPole()
    return env, IQN(model=ImplicitQuantileNetwork(H, 2, num_cosines=8, input_dim=4), action_space=env.action_space,
                    optim=_adam(), gamma=0.97, n_step_return_horizon=3, target_update_freq=2, eps_training=0.3,
                    sample_size=8, online_sample_size=4, target_sample_size=4)


def _goal_env():
    from tianshou_tpu_torch.env.classic.goal_reach import GoalReach

    return GoalReach(size=1.0, step_size=0.05, eps=0.05, max_episode_steps=60)


def _her_ddpg():
    """``tests/test_her.py:110-145``'s goal-conditioned DDPG at n = 3, its nets narrow."""
    from torch import nn

    from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
    from tianshou_tpu_torch.exploration.noise import GaussianNoise
    from tianshou_tpu_torch.models.mlp import MLP

    class GoalActor(nn.Module):
        def __init__(self) -> None:
            super().__init__()
            self.mlp = MLP(4, H, 2)

        def forward(self, obs):
            return torch.tanh(self.mlp(torch.cat([obs.observation, obs.desired_goal], dim=-1)))

    class GoalCritic(nn.Module):
        def __init__(self) -> None:
            super().__init__()
            self.mlp = MLP(6, H, 1)

        def forward(self, obs, act):
            return self.mlp(torch.cat([obs.observation, obs.desired_goal, act], dim=-1))[:, 0]

    torch.manual_seed(0)
    env = _goal_env()
    return env, DDPG(actor=GoalActor(), critic=GoalCritic(), action_space=env.action_space, policy_optim=_adam(),
                     critic_optim=_adam(), gamma=0.98, tau=0.005, exploration_noise=GaussianNoise(sigma=0.3),
                     action_scaling=False, n_step_return_horizon=3)


def _her_ring(envs: int):
    from tianshou_tpu_torch.data.buffer.her import HERVectorReplayBuffer

    return HERVectorReplayBuffer(OFF_SLOTS * envs, envs, compute_reward_fn=_goal_env().compute_reward, horizon=60,
                                 future_k=8.0)


def _her_example():
    from tianshou_tpu_torch.data.batch import Batch

    return _vector_example(Batch(observation=torch.zeros(2), achieved_goal=torch.zeros(2), desired_goal=torch.zeros(2)),
                           torch.zeros(2))


def _stacked_dqn():
    """DQN over the last 3 CartPole frames (``FrameStack``), the ring storing each frame once."""
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.wrappers import FrameStack
    from tianshou_tpu_torch.models.mlp import Net

    torch.manual_seed(0)
    env = FrameStack(CartPole(), 3)
    return env, DQN(model=Net(H, 2, input_dim=12), action_space=env.action_space, optim=_adam(), gamma=0.97,
                    n_step_return_horizon=3, target_update_freq=8, eps_training=0.3)


def _avail_ring(envs: int):
    return _uniform_ring(envs, stack_num=3, save_only_last_obs=True, sample_avail=True)


def _board_dqn():
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.env.core import Discrete
    from tianshou_tpu_torch.models.discrete import MaskedQNet

    return DQN(model=MaskedQNet(H, 9, input_dim=18), action_space=Discrete(9), optim=_adam(), gamma=0.9,
               n_step_return_horizon=1, target_update_freq=2, eps_training=0.2)


def _marl_off():
    from tianshou_tpu_torch.algorithm.multiagent.marl import MultiAgentOffPolicyAlgorithm
    from tianshou_tpu_torch.env.core import Discrete

    torch.manual_seed(0)
    return None, MultiAgentOffPolicyAlgorithm([_board_dqn(), _board_dqn()], action_space=Discrete(9))


def _board_example():
    from tianshou_tpu_torch.data.batch import Batch

    obs = Batch(agent_id=torch.tensor(0, dtype=torch.int32), obs=torch.zeros(3, 3, 2),
                mask=torch.ones(9, dtype=torch.bool))
    return Batch(obs=obs, act=torch.tensor(0), rew=torch.zeros(2), terminated=torch.tensor(False),
                 truncated=torch.tensor(False), obs_next=obs.map(torch.clone))


def _board_ring(envs: int):
    return _uniform_ring(envs)


def _pendulum_ac(kind: str):
    """NPG or TRPO (``examples/mujoco/mujoco_{npg,trpo}.py``), or GAIL over PPO, on Pendulum at narrow widths."""
    from tianshou_tpu_torch.algorithm.imitation.gail import GAIL
    from tianshou_tpu_torch.algorithm.modelfree.npg import NPG
    from tianshou_tpu_torch.algorithm.modelfree.trpo import TRPO
    from tianshou_tpu_torch.env.classic.pendulum import Pendulum
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    torch.manual_seed(0)
    env = Pendulum()
    nets = dict(actor=ContinuousActorProbabilistic(H, 1, input_dim=3),
                critic=ContinuousCritic(H, use_action=False, input_dim=3), action_space=env.action_space,
                optim=_adam(), gamma=0.99, gae_lambda=0.95, deterministic_eval=True)
    # three conjugate-gradient iterations: the ranks' sums run in another order than one process's, and ten
    # float32 iterations amplify that rounding to 1e-3 of the actor's weights on these rollouts
    if kind == "npg":
        return env, NPG(trust_region_size=0.5, optim_critic_iters=2, cg_iters=3, **nets)
    if kind == "trpo":
        return env, TRPO(max_kl=0.01, optim_critic_iters=2, cg_iters=3, **nets)
    rng = np.random.default_rng(3)
    expert_obs = rng.standard_normal((64, 3)).astype(np.float32)
    expert_act = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
    return env, GAIL(disc_net=ContinuousCritic(H, input_dim=3, action_dim=1), expert_obs=expert_obs,
                     expert_act=expert_act, disc_optim=_adam(), disc_update_num=2, eps_clip=0.2, **nets)


def _icm_ppo():
    from tianshou_tpu_torch.algorithm.modelbased.icm import ICMOnPolicyWrapper
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic, IntrinsicCuriosityModule

    torch.manual_seed(0)
    env = CartPole()
    ppo = PPO(actor=DiscreteActor(H, 2, input_dim=4), critic=DiscreteCritic(H, input_dim=4),
              action_space=env.action_space, optim=_adam(), advantage_normalization=True)
    return env, ICMOnPolicyWrapper(ppo, IntrinsicCuriosityModule((16,), 2, (16,), input_dim=4), optim=_adam(),
                                   lr_scale=1.0, reward_scale=0.1, forward_loss_weight=0.2)


def _psrl():
    from tianshou_tpu_torch.algorithm.modelbased.psrl import PSRL
    from tianshou_tpu_torch.env.classic.nchain import NChain

    env = NChain(n=5, slip=0.2)
    return env, PSRL(n_state=5, n_action=2, action_space=env.action_space, gamma=0.95, value_iterations=20,
                     rew_mean_prior=0.5, rew_std_prior=2.0)


def _marl_on():
    from torch import nn

    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.multiagent.marl import MultiAgentOnPolicyAlgorithm
    from tianshou_tpu_torch.env.core import Discrete
    from tianshou_tpu_torch.models.mlp import MLP

    class MaskedActor(nn.Module):
        def __init__(self) -> None:
            super().__init__()
            self.mlp = MLP(18, H, 9)

        def forward(self, obs):
            return torch.where(obs.mask, self.mlp(obs.obs.reshape(obs.obs.shape[0], -1)), -1e9)

    class BoardCritic(nn.Module):
        def __init__(self) -> None:
            super().__init__()
            self.mlp = MLP(18, H, 1)

        def forward(self, obs):
            return self.mlp(obs.obs.reshape(obs.obs.shape[0], -1))

    torch.manual_seed(0)
    agents = [PPO(actor=MaskedActor(), critic=BoardCritic(), action_space=Discrete(9), optim=_adam(3e-4), gamma=0.95,
                  ent_coef=0.01, deterministic_eval=True, action_scaling=False, advantage_normalization=True)
              for _ in range(2)]
    return None, MultiAgentOnPolicyAlgorithm(agents, action_space=Discrete(9))


def _off(build, ring, example, **kw) -> Case:
    return Case(build=build, on_policy=False, envs=OFF_E, steps=OFF_T, ring=ring, example=example, **kw)


CASES: dict[str, Case] = {
    "sac": _off(lambda: _continuous("sac"), _uniform_ring, _pendulum_example),
    "td3": _off(lambda: _continuous("td3"), _uniform_ring, _pendulum_example),
    "redq": _off(lambda: _continuous("redq"), _uniform_ring, _pendulum_example),
    "iqn": _off(_iqn, _uniform_ring, _cartpole_example),
    "her_ddpg": _off(_her_ddpg, _her_ring, _her_example),
    "sample_avail": _off(_stacked_dqn, _avail_ring, _cartpole_example),
    "marl_off": Case(build=_marl_off, on_policy=False, envs=BOARD_E, steps=BOARD_T, ring=_board_ring,
                     example=_board_example, host=True),
    "npg": Case(build=lambda: _pendulum_ac("npg"), on_policy=True, envs=ON_E, steps=ON_T, repeat=1, batch=64),
    "trpo": Case(build=lambda: _pendulum_ac("trpo"), on_policy=True, envs=ON_E, steps=ON_T, repeat=1, batch=64),
    "gail": Case(build=lambda: _pendulum_ac("gail"), on_policy=True, envs=ON_E, steps=ON_T),
    "icm_ppo": Case(build=_icm_ppo, on_policy=True, envs=ON_E, steps=ON_T),
    "psrl": Case(build=_psrl, on_policy=True, envs=ON_E, steps=ON_T),
    "marl_on": Case(build=_marl_on, on_policy=True, envs=BOARD_E, steps=BOARD_T, host=True),
}
#: the cases whose per-row noise each rank records (the draw fault of a rank's rows getting rank 0's numbers)
NOISE_CASES = ("sac", "td3")
#: the cases run again on a (dp 1, mp 2) mesh under ``tp_axis="mp"``: every weight the placement rule picks a
#: ``DTensor`` split over the two ranks, so that the natural-gradient step runs over sharded weights
TP_CASES = ("npg", "trpo")


# ---------------------------------------------------------------------------
# collectors and records
# ---------------------------------------------------------------------------
class HostSteps:
    """A host collector of TicTacToe boards behind the device collector's
    ``rollout``, the call the mesh steps make: ``n_steps`` vector steps into
    the given ring, or a time-major rollout."""

    def __init__(self, algo, envs: int, buffer, seed: int) -> None:
        from tianshou_tpu_torch.data.host_collector import HostCollector
        from tianshou_tpu_torch.env.tictactoe import TicTacToeEnv
        from tianshou_tpu_torch.env.venvs import DummyVectorEnv

        self.hc = HostCollector(DummyVectorEnv([TicTacToeEnv for _ in range(envs)]), algo, buffer, device="cpu")
        self.hc.reset(seed=seed)
        self.buffer = buffer
        self.venv = SimpleNamespace(num_envs=envs)

    def rollout(self, ts, cstate, buf_state, generator, n_steps: int, keep_rollout: bool = False):
        if keep_rollout:
            return SimpleNamespace(rollout=self.hc.collect_rollout(ts, generator, n_steps)[0])
        self.hc.buf_state = buf_state
        self.hc.collect(ts, generator, n_step=n_steps * self.venv.num_envs)
        return None


def collector(case: Case, env, algo, envs: int, buffer, rank: int, generator: torch.Generator):
    """(collector, collect state) of ``envs`` envs for data-parallel rank ``rank``."""
    if case.host:
        return HostSteps(algo, envs, buffer, seed=1000 * rank), None
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv

    coll = DeviceCollector(VectorDeviceEnv(env, envs, device="cpu"), algo, buffer)
    return coll, coll.reset(generator)


def state_record(ts) -> dict:
    """Every tensor of a train state (each agent's of a dispatcher): weights,
    target, step, carried state and optimizer state."""
    if isinstance(ts, dict):
        return {k: state_record(v) for k, v in ts.items()}
    opts = ts.optim if isinstance(ts.optim, dict) else {"optim": ts.optim}
    rec = {"params": plain(dict(ts.model.state_dict())), "step": int(ts.step), "extra": plain(dict(ts.extra)),
           "optim": {name: {i: plain(dict(s)) for i, s in opt.state_dict()["state"].items()}
                     for name, opt in opts.items()}}
    if ts.target is not None:
        rec["target"] = plain(dict(ts.target.state_dict()))
    return rec


@contextlib.contextmanager
def recorded_noise(into: list):
    """Every standard normal that SAC's and TD3's updates use, appended to ``into`` as ``(field, tensor)``."""
    from tianshou_tpu_torch.algorithm.modelfree import sac, td3

    saved = {m: m.standard_normal for m in (sac, td3)}

    def recording(fn):
        def draw(source, field, like):
            out = fn(source, field, like)
            into.append((field, out.clone()))
            return out

        return draw

    for module, fn in saved.items():
        module.standard_normal = recording(fn)
    try:
        yield into
    finally:
        for module, fn in saved.items():
            module.standard_normal = fn


def _seeds(name: str) -> tuple[int, int]:
    """(base of the rank generators, seed of the update generator) of case ``name``."""
    i = list(CASES).index(name)
    return 100 + 10 * i, 7 + i


def _join_ring(whole_state, slices: list) -> None:
    """The slices' rings written into the whole buffer's state in rank order."""
    tree_map(lambda dst, *xs: dst.copy_(torch.cat(xs)), whole_state.data, *[b.data for b in slices])
    for name in ("cursor", "size", "last_idx"):
        getattr(whole_state, name).copy_(torch.cat([getattr(b, name) for b in slices]))


# ---------------------------------------------------------------------------
# the three runs of a case
# ---------------------------------------------------------------------------
def rank_run(name: str, mesh, rank: int, world: int) -> dict:
    """Case ``name`` through its mesh step on this rank's slice of the envs."""
    from tianshou_tpu_torch.parallel.mesh import make_dp_offpolicy_train_step, make_dp_train_step, shard_buffer

    case = CASES[name]
    base, useed = _seeds(name)
    env, algo = case.build()
    ts = algo.init("cpu")
    g = rank_generator(rank, base)
    noise: list = []
    with recorded_noise(noise):
        if case.on_policy:
            coll, cstate = collector(case, env, algo, case.envs // world, None, rank, g)
            step = make_dp_train_step(algo, coll, mesh, case.steps, case.repeat, case.batch)
            ts, _, stats = step(ts, cstate, g, update_generator(useed))
            return {"ts": state_record(ts), "stats": plain(dict(stats)), "noise": noise}
        buffer = case.ring(case.envs)
        local = shard_buffer(buffer, mesh)
        coll, cstate = collector(case, env, algo, case.envs // world, local, rank, g)
        bs = local.init(case.example(), "cpu")
        step = make_dp_offpolicy_train_step(algo, coll, buffer, mesh, case.steps, OFF_UPDATES, OFF_BATCH)
        ts, _, bs, _, stats = step(ts, cstate, bs, g, update_generator(useed))
    return {"ts": state_record(ts), "stats": plain(dict(stats)), "ring": ring_record(bs), "noise": noise}


def tp_run(name: str, world: int) -> dict:
    """Case ``name`` through its on-policy mesh step under ``tp_axis="mp"`` on a (1, ``world``) mesh: one
    data-parallel slice, the whole envs on every rank, the weights placed by ``shard_params_tp``."""
    from torch.distributed.tensor import DTensor

    from tianshou_tpu_torch.parallel.mesh import make_dp_train_step, make_mesh_2d, shard_params_tp

    case = CASES[name]
    base, useed = _seeds(name)
    mesh = make_mesh_2d(world, mp=world)
    env, algo = case.build()
    ts = algo.init("cpu")
    shard_params_tp(ts.model, mesh, "mp", optim=ts.optim)
    sharded = [n for n, p in ts.model.named_parameters() if isinstance(p, DTensor) and not p.placements[-1].is_replicate()]
    g = rank_generator(0, base)
    coll, cstate = collector(case, env, algo, case.envs, None, 0, g)
    step = make_dp_train_step(algo, coll, mesh, case.steps, case.repeat, case.batch, tp_axis="mp")
    ts, _, stats = step(ts, cstate, g, update_generator(useed))
    return {"ts": state_record(ts), "stats": plain(dict(stats)), "sharded": sharded}


def reference(name: str, slices: int = WORLD) -> dict:
    """Case ``name`` in one process: each slice collected in turn with its
    rank's generator, then the update with the update generator over the
    joined rollout or ring."""
    case = CASES[name]
    base, useed = _seeds(name)
    env, algo = case.build()
    ts = algo.init("cpu")
    noise: list = []
    with recorded_noise(noise):
        if case.on_policy:
            parts = []
            for r in range(slices):
                g = rank_generator(r, base)
                coll, cstate = collector(case, env, algo, case.envs // slices, None, r, g)
                parts.append(coll.rollout(ts, cstate, None, g, case.steps, keep_rollout=True).rollout)
            rollout = tree_map(lambda *xs: torch.cat(xs, dim=1), *parts)
            ts, stats = algo.update_rollout(ts, rollout, update_generator(useed), case.repeat, case.batch)
            return {"ts": state_record(ts), "stats": plain(dict(stats)), "noise": noise}
        rings = []
        for r in range(slices):
            local = case.ring(case.envs // slices)
            g = rank_generator(r, base)
            coll, cstate = collector(case, env, algo, case.envs // slices, local, r, g)
            bs = local.init(case.example(), "cpu")
            coll.rollout(ts, cstate, bs, g, case.steps)
            rings.append(bs)
        whole = case.ring(case.envs)
        bs = whole.init(case.example(), "cpu")
        _join_ring(bs, rings)
        gu = update_generator(useed)
        stats = [algo.update(ts, whole, bs, gu, OFF_BATCH)[2] for _ in range(OFF_UPDATES)]
    return {"ts": state_record(ts), "stats": plain(dict(tree_map(lambda *xs: torch.stack(xs), *stats))),
            "rings": [ring_record(b) for b in rings], "noise": noise}


def world_one(name: str, mesh) -> list:
    """Case ``name`` at world size 1: the mesh step with no update generator,
    then the plain program (the collect, then the update on the same
    generator); every tensor of each, in the same order."""
    from tianshou_tpu_torch.parallel.mesh import make_dp_offpolicy_train_step, make_dp_train_step, shard_buffer

    case = CASES[name]
    base, _ = _seeds(name)
    runs = []
    for mesh_step in (True, False):
        env, algo = case.build()
        ts = algo.init("cpu")
        g = rank_generator(0, base)
        if case.on_policy:
            coll, cstate = collector(case, env, algo, case.envs, None, 0, g)
            if mesh_step:
                stats = make_dp_train_step(algo, coll, mesh, case.steps, case.repeat, case.batch)(ts, cstate, g)[2]
            else:
                out = coll.rollout(ts, cstate, None, g, case.steps, keep_rollout=True)
                stats = algo.update_rollout(ts, out.rollout, g, case.repeat, case.batch)[1]
            runs.append([state_record(ts), plain(dict(stats)), plain(cstate), g.get_state()])
            continue
        buffer = case.ring(case.envs)
        local = shard_buffer(buffer, mesh) if mesh_step else buffer
        coll, cstate = collector(case, env, algo, case.envs, local, 0, g)
        bs = local.init(case.example(), "cpu")
        if mesh_step:
            stats = make_dp_offpolicy_train_step(algo, coll, buffer, mesh, case.steps, OFF_UPDATES,
                                                 OFF_BATCH)(ts, cstate, bs, g)[4]
        else:
            coll.rollout(ts, cstate, bs, g, case.steps)
            stats = tree_map(lambda *xs: torch.stack(xs), *[algo.update(ts, buffer, bs, g, OFF_BATCH)[2]
                                                           for _ in range(OFF_UPDATES)])
        runs.append([state_record(ts), plain(dict(stats)), ring_record(bs), plain(cstate), g.get_state()])
    return runs


# ---------------------------------------------------------------------------
def spawn(tmp: Path, world: int = WORLD) -> list:
    """Start the ``world`` ranks; they meet at a file in ``tmp``."""
    import os
    import subprocess

    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-m", "tests._torch_mesh_families_worker", f"file://{tmp}/rdzv_families",
                              str(world), str(r), str(tmp)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def collect(procs: list, tmp: Path) -> list[dict]:
    """The ranks' records (:func:`tests._torch_mesh_worker.join`)."""
    return join(procs, "families", tmp)


def main(rdzv: str, world: int, rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from tianshou_tpu_torch.parallel.distributed import initialize
    from tianshou_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    initialize(rdzv, world, rank, device="cpu")
    mesh = make_mesh(world)
    record = {}
    for name in CASES:
        try:
            record[name] = rank_run(name, mesh, rank, world)
        except Exception:  # noqa: BLE001  (the case's test reports it; the other cases still run)
            record[name] = {"error": traceback.format_exc()}
            dist.barrier()  # a rank that raised before a collective meets the other again here
    for name in TP_CASES:
        try:
            record[f"{name}_tp"] = tp_run(name, world)
        except Exception:  # noqa: BLE001
            record[f"{name}_tp"] = {"error": traceback.format_exc()}
            dist.barrier()
    torch.save(record, f"{out_dir}/families_rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
