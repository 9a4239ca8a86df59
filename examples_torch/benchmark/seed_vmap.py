"""Several seeds of one off-policy agent trained at once, the seeds stacked on the env axis (the port of
``examples/benchmark/seed_vmap.py``).

The reference's table protocol needs >= 3 independent trials per row (the max test return per trial,
aggregated). The JAX script ``jax.vmap``s its whole training program (collect chunk, gradient burst, test
rollouts) over a leading seed axis, so that S agents train in one XLA program. The port's agents are stateful
modules with in-place optimizers and their own generators, which ``torch.func.vmap`` does not carry, so the seed
axis is explicit here, and only where the JAX program shares work, the envs (:class:`SeedStack`):

- Each seed is an ordinary agent: its weights from ``torch.manual_seed(seed)``, its own train state, Adam state,
  ring and ``torch.Generator`` seeded with the seed, as each JAX lane has its own key.
- One env batch of ``S * num_envs`` envs, seed i's rows ``[i * num_envs, (i + 1) * num_envs)``. Its resets and
  random actions draw seed i's rows from seed i's generator; its vector step is one physics step over all rows:
  one ``physics_fused`` launch on the card.
- The seed-stacked collect step (:meth:`SeedStack.step`, the vmapped ``_step_fn``): per vector step S policy
  forwards on their rows, one env step, S ring writes.
- The prefill chunk, the megastep (the collect chunk, then each seed's gradient burst) and the test rollout are
  each one program over all seeds: one CUDA graph on the card (a test of the env's horizon is ``TEST_CHUNK``-step
  replays of one), so the host's launches per megastep do not grow with S.

So lane i of a run equals a one-seed run of ``seeds[i]``: the same weights, the same draws from its generator in
the same order, its nets and updates at the same shapes, and a fused physics step that gives each env the same
bits whatever the number of envs beside it.

The hyperparameters are those of ``examples_torch/mujoco/mujoco_{sac,td3,ddpg,redq}.py`` (the reference protocol:
1 M steps, 256x256 nets, 10-episode tests per 20k-step epoch, a random prefill). ``seed_queue.py`` runs it for a
``"vmap"`` job.

    python examples_torch/benchmark/seed_vmap.py --algo sac --task HalfCheetah --seeds 0,1,2 [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse
import functools
import time

import numpy as np
import torch

from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import CollectState
from tianshou_tpu_torch.utils.graph import Graphed, GraphPool
from tianshou_tpu_torch.utils.tree import tree_map

#: vector steps of one test program; a test of the env's horizon replays it (and one program of the remainder)
TEST_CHUNK = 100


# ---------------------------------------------------------------------------
# algorithm factories (hyperparameters of the sibling example scripts)
# ---------------------------------------------------------------------------
def _make_sac(env, alpha=0.2):
    from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return SAC(
        actor=ContinuousActorProbabilistic(hidden_sizes=(256, 256), action_dim=nu, conditioned_sigma=True,
                                           input_dim=obs_dim),
        critic=ContinuousCritic(hidden_sizes=(256, 256), input_dim=obs_dim, action_dim=nu),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=1e-3),
        critic_optim=AdamOptimizerFactory(lr=1e-3),
        alpha=alpha, tau=0.005, gamma=0.99, n_step_return_horizon=1,
    )


def _make_td3(env, exploration_sigma=0.1, policy_noise=0.2):
    from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.exploration.noise import GaussianNoise
    from tianshou_tpu_torch.models.continuous import ContinuousActorDeterministic, ContinuousCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return TD3(
        actor=ContinuousActorDeterministic(hidden_sizes=(256, 256), action_dim=nu, input_dim=obs_dim),
        critic=ContinuousCritic(hidden_sizes=(256, 256), input_dim=obs_dim, action_dim=nu),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=3e-4),
        critic_optim=AdamOptimizerFactory(lr=3e-4),
        exploration_noise=GaussianNoise(sigma=exploration_sigma),
        policy_noise=policy_noise, noise_clip=0.5, update_actor_freq=2,
        tau=0.005, gamma=0.99, n_step_return_horizon=1,
    )


def _make_ddpg(env):
    from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.exploration.noise import GaussianNoise
    from tianshou_tpu_torch.models.continuous import ContinuousActorDeterministic, ContinuousCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return DDPG(
        actor=ContinuousActorDeterministic(hidden_sizes=(256, 256), action_dim=nu, input_dim=obs_dim),
        critic=ContinuousCritic(hidden_sizes=(256, 256), input_dim=obs_dim, action_dim=nu),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=1e-3),
        critic_optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.99, tau=0.005, exploration_noise=GaussianNoise(sigma=0.1),
    )


def _make_redq(env):
    from tianshou_tpu_torch.algorithm.modelfree.redq import REDQ
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, EnsembleCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return REDQ(
        actor=ContinuousActorProbabilistic(hidden_sizes=(256, 256), action_dim=nu, conditioned_sigma=True,
                                           input_dim=obs_dim),
        critic=EnsembleCritic(10, (256, 256), input_dim=obs_dim, action_dim=nu),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=1e-3),
        critic_optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.99, tau=0.005,
        ensemble_size=10, subset_size=2, alpha="auto", actor_delay=20,
    )


ALGOS = {"sac": _make_sac, "td3": _make_td3, "ddpg": _make_ddpg, "redq": _make_redq}
START_STEPS = {"sac": 10_000, "td3": 25_000, "ddpg": 25_000, "redq": 10_000}


# ---------------------------------------------------------------------------
# the seed-stacked programs
# ---------------------------------------------------------------------------
class SeedStack:
    """``len(seeds)`` agents, each an algorithm of ``make_algo(env)``, over one batch of ``S * num_envs`` envs of
    ``env`` (a MuJoCo-class env, whose step draws nothing), and ``S * test_envs`` test envs.

    Per seed: an algorithm and its train state (``make_algo`` and ``init`` after ``torch.manual_seed(seed)``, which
    draws its nets' weights, as a one-seed run of an example script draws them), a ring of ``buffer_size`` rows over
    ``num_envs`` sub-rings, and a generator seeded with the seed, from which everything of that seed is drawn.
    Programs over all seeds, each a :class:`Graphed` of one pool (its registered generators all S): ``prefill``
    (``chunk_len`` random steps into the rings), ``megastep`` (``chunk_len`` policy steps into the rings, then
    ``n_updates`` updates of each seed), and the test rollout (:meth:`test`)."""

    def __init__(self, make_algo, env, seeds, num_envs: int, chunk_len: int, n_updates: int, batch_size: int,
                 buffer_size: int, test_envs: int, device=None) -> None:
        if not seeds:
            raise ValueError("no seeds")
        self.env = env
        self.S, self.num_envs, self.test_envs = len(seeds), num_envs, test_envs
        self.chunk_len, self.n_updates, self.batch_size = chunk_len, n_updates, batch_size
        obs_dim, nu = env.observation_space.shape[0], env.action_space.shape[0]
        self.buffer = VectorReplayBuffer(total_size=buffer_size, buffer_num=num_envs)
        self.algos, self.tss, self.bss, self.gens = [], [], [], []
        for seed in seeds:
            dev, gen = setup(device, seed)  # seeds torch's global generator, which draws the nets' weights
            algo = make_algo(env)
            if algo.init_policy_state(1, dev) is not None:
                raise ValueError(f"{type(algo).__name__} carries a policy state, which the seed stack does not")
            self.algos.append(algo)
            self.tss.append(algo.init(dev))
            self.bss.append(self.buffer.init(transition_example(torch.zeros(obs_dim), torch.zeros(nu)), device=dev))
            self.gens.append(gen)
        self.device = dev
        self.cstate = self._fresh(num_envs)
        self.tstate = self._fresh(test_envs)
        rows = self.S * test_envs
        self.test_ret = torch.zeros(rows, dtype=torch.float32, device=dev)  # per env: the returns of its episodes
        self.test_done = torch.zeros(rows, dtype=torch.int64, device=dev)   # per env: its finished episodes
        self.pool = GraphPool(dev)
        self.prefill = Graphed(lambda: self.collect(random=True), self.pool, self.gens, name="prefill")
        self.megastep = Graphed(self._megastep, self.pool, self.gens, name="megastep")
        self._test_reset = Graphed(self._reset_test, self.pool, self.gens, name="test reset")
        self._test_chunks: dict[int, Graphed] = {}

    # -- the env batch ---------------------------------------------------
    def _reset_rows(self, n: int):
        """Fresh ``(env state, obs)`` of ``n`` envs a seed, seed i's rows drawn from seed i's generator."""
        parts = [self.env.reset(n, gen, self.device) for gen in self.gens]
        return tree_map(lambda *xs: torch.cat(xs), *parts)

    def _fresh(self, n: int):
        state, obs = tree_map(torch.clone, self._reset_rows(n))
        rows = self.S * n
        return CollectState(state, obs, None, torch.zeros(rows, dtype=torch.float32, device=self.device),
                            torch.zeros(rows, dtype=torch.int64, device=self.device))

    @torch.no_grad()
    def step(self, cs, n: int, training: bool, random: bool = False, store: bool = False):
        """One vector step of the ``S * n`` envs of ``cs`` (written in place): per seed its policy's actions
        (uniform ones with ``random``) on its rows, one env step over all rows, per seed a ring write (``store``),
        and the envs that finished reset from their seed's generator. Returns ``(done, emitted returns)`` over the
        rows (the returns 0 where no episode ended)."""
        acts, env_acts = [], []
        for i, (algo, ts, gen) in enumerate(zip(self.algos, self.tss, self.gens)):
            obs = cs.obs[i * n:(i + 1) * n]
            if random:  # warm-up prefill: uniform action-space samples, stored as raw actions
                env_act = self.env.action_space.sample(n, gen, self.device)
                act = algo.map_action_inverse(env_act)
            else:
                act = algo.forward(ts, obs, gen, deterministic=not training).act
                act = algo.exploration_noise(ts, act, obs, gen, training=training)
                env_act = algo.map_action(act)
            acts.append(act)
            env_acts.append(env_act)
        act = torch.cat(acts)
        out = self.env.step(cs.env_state, torch.cat(env_acts), None)  # one physics step over every seed's rows
        done = out.terminated | out.truncated
        if store:
            transition = Batch(obs=cs.obs, act=act, rew=out.reward, terminated=out.terminated,
                               truncated=out.truncated, obs_next=out.obs)
            for i, bs in enumerate(self.bss):
                self.buffer.add(bs, transition[i * n:(i + 1) * n])
        ep_rew = cs.ep_rew + out.reward
        ep_len = cs.ep_len + 1
        emitted = torch.where(done, ep_rew, 0.0)
        reset_state, reset_obs = self._reset_rows(n)

        def sel(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
            return torch.where(done.reshape(done.shape + (1,) * (new.dim() - done.dim())), new, old)

        new = CollectState(tree_map(sel, reset_state, out.state), sel(reset_obs, out.obs), None,
                           torch.where(done, 0.0, ep_rew), torch.where(done, 0, ep_len))
        tree_map(torch.Tensor.copy_, cs, new)
        return done, emitted

    # -- the programs ------------------------------------------------------
    def collect(self, random: bool = False) -> None:
        """``chunk_len`` vector steps of the train envs into the rings."""
        for _ in range(self.chunk_len):
            self.step(self.cstate, self.num_envs, training=True, random=random, store=True)

    def updates(self) -> None:
        """``n_updates`` gradient steps of each seed, on its ring, from its generator."""
        for algo, ts, bs, gen in zip(self.algos, self.tss, self.bss, self.gens):
            for _ in range(self.n_updates):
                algo.update(ts, self.buffer, bs, gen, self.batch_size)

    def _megastep(self) -> None:
        self.collect()
        self.updates()

    def _reset_test(self) -> None:
        state, obs = self._reset_rows(self.test_envs)
        tree_map(torch.Tensor.copy_, (self.tstate.env_state, self.tstate.obs), (state, obs))
        for t in (self.tstate.ep_rew, self.tstate.ep_len, self.test_ret, self.test_done):
            t.zero_()

    def _test_steps(self, steps: int) -> None:
        for _ in range(steps):
            done, emitted = self.step(self.tstate, self.test_envs, training=False)
            self.test_ret.add_(emitted)
            self.test_done.add_(done.to(torch.int64))

    def test(self, horizon: int) -> np.ndarray:
        """Each seed's mean return of the episodes its ``test_envs`` envs finish in ``horizon`` deterministic
        steps from a fresh reset (the JAX script's ``test1``): ``[S]`` float64."""
        self._test_reset()
        full, rest = divmod(horizon, TEST_CHUNK)
        for steps in [TEST_CHUNK] * full + ([rest] if rest else []):
            if steps not in self._test_chunks:
                self._test_chunks[steps] = Graphed(lambda steps=steps: self._test_steps(steps), self.pool,
                                                   self.gens, name=f"test chunk {steps}")
            self._test_chunks[steps]()
        ret = self.test_ret.view(self.S, self.test_envs).double().cpu().numpy()
        n = self.test_done.view(self.S, self.test_envs).cpu().numpy()
        return ret.sum(1) / np.maximum(n.sum(1), 1)


# ---------------------------------------------------------------------------
def run_multiseed(
    algo_name: str,
    task: str,
    seeds: list[int],
    epochs: int = 50,
    epoch_num_steps: int = 20_000,
    num_envs: int = 32,
    chunk_len: int = 4,
    update_per_step: float = 1.0,
    batch_size: int = 256,
    buffer_size: int = 1_000_000,
    start_steps: int | None = None,
    test_episodes: int = 10,
    verbose: bool = True,
    env_overrides: dict | None = None,
    algo_kwargs: dict | None = None,
    save_params: str | None = None,
    device=None,
) -> list[dict]:
    """Train ``len(seeds)`` agents at once; returns one result dict per seed: ``{seed, best_reward, env_step,
    curve: [(env_step, reward), ...], wall_s, agent_steps_per_s}``. ``save_params``: a file that receives the S
    train states (``torch.save``)."""
    from tianshou_tpu_torch.env.mujoco import make

    env = make(task)
    for k, v in (env_overrides or {}).items():  # e.g. {"substeps": 2} fidelity A/B
        setattr(env, k, v)
        if k == "contact_iterations":  # baked into the model at env init
            env.model.contact_iterations = int(v)
    make_algo = functools.partial(ALGOS[algo_name], **(algo_kwargs or {}))  # e.g. {"alpha": "auto"} sweeps
    if start_steps is None:
        start_steps = START_STEPS[algo_name]
    S = len(seeds)
    T = chunk_len
    n_updates = max(1, round(update_per_step * T * num_envs))
    stack = SeedStack(make_algo, env, seeds, num_envs, T, n_updates, batch_size, buffer_size, test_episodes, device)

    t0 = time.time()
    n_prefill = int(np.ceil(start_steps / (T * num_envs)))
    for _ in range(n_prefill):
        stack.prefill()
    steps_per_mega = T * num_envs
    megas_per_epoch = int(np.ceil(epoch_num_steps / steps_per_mega))
    best = np.full(S, -np.inf)
    curves: list[list] = [[] for _ in range(S)]
    env_step = n_prefill * steps_per_mega
    for epoch in range(1, epochs + 1):
        for _ in range(megas_per_epoch):
            stack.megastep()
        env_step += megas_per_epoch * steps_per_mega
        rews = stack.test(env.max_episode_steps)
        best = np.maximum(best, rews)
        for i in range(S):
            curves[i].append((env_step, float(rews[i])))
        if verbose:
            per_s = env_step * S / max(time.time() - t0, 1e-9)
            print(f"[seed_vmap {algo_name} {task}] epoch {epoch}: "
                  f"rewards {np.round(rews, 1).tolist()} best {np.round(best, 1).tolist()} "
                  f"({per_s:,.0f} agent-steps/s)", flush=True)
    wall = time.time() - t0
    if save_params:
        from tianshou_tpu_torch.utils.persistence import _ts_payload

        torch.save({"algo": algo_name, "task": task, "seeds": list(seeds),
                    "tss": [_ts_payload(ts) for ts in stack.tss]}, save_params)
        if verbose:
            print(f"[seed_vmap] saved final TrainStates -> {save_params}", flush=True)
    return [
        {"seed": int(s), "best_reward": float(best[i]), "env_step": int(env_step),
         "curve": curves[i], "wall_s": round(wall, 1),
         "agent_steps_per_s": round(env_step * S / wall, 1)}
        for i, s in enumerate(seeds)
    ]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--algo", choices=sorted(ALGOS), default="sac")
    p.add_argument("--task", default="HalfCheetah")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--epoch-num-steps", type=int, default=20_000)
    return add_device_arg(p)


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    out = run_multiseed(
        args.algo, args.task, [int(s) for s in args.seeds.split(",")],
        epochs=args.epochs, epoch_num_steps=args.epoch_num_steps, device=args.device,
    )
    for r in out:
        print(f"seed {r['seed']}: best {r['best_reward']:.1f}")
    return out


if __name__ == "__main__":
    main()
