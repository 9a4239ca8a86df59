"""The high-level API in the port (``tianshou_tpu_torch.highlevel``) against
the JAX package's (``tianshou_tpu.highlevel``).

- Every builder of ``highlevel/experiment.py`` (parametrised, with the
  configurations of ``tests/test_highlevel.py``): the port's
  ``_make_algo(env)`` builds the algorithm of the same class with the same
  hyper-parameters (every scalar attribute the JAX algorithm holds, exactly;
  the exploration noise's sigma), the same optimizers (each optimizer of the
  JAX algorithm against the port's factory of the same name: three steps of
  both on the same parameters and gradients, rtol 1e-6: rate, schedule and
  clipping alike) and the same nets (the JAX ``params`` and
  ``target_params`` load into the port's train state with every shape
  equal, ``models/convert.py:train_state_from_flax``). With those weights the
  deterministic forward on the same observations gives the same actions:
  discrete ones exactly (Q values at rtol 1e-6 / atol 1e-5), continuous ones at atol 1e-5
  (the tolerance of ``tests/test_torch_continuous_offpolicy.py`` and
  ``tests/test_torch_onpolicy.py``); IQN's fractions and BCQ's latent
  normals are JAX's draws, handed over as ``Draws``.
- Every ``Params`` class with its transformer chain resolves to the same
  keyword dicts (scalars exactly, optimizers as above, noise by sigma).
- The trainer parameters that ``Experiment.run`` assembles (recorded by
  patching each trainer's ``run`` in both packages) are the same in the
  device off-policy, on-policy and offline branches, the host off- and
  on-policy branches (``GymEnvFactory``) and the MARL branch: every field
  of the JAX dataclass, ``stop_fn`` / ``train_fn`` / ``test_fn`` evaluated
  at the same inputs.

- ``utils/space_info.py`` over the port's spaces and Gymnasium's gives the JAX
  package's infos.

The port's builders also run end to end: ``tests/test_torch_highlevel_runs.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tianshou_tpu.highlevel.experiment as jexp
import tianshou_tpu.highlevel.params as jpar
import tianshou_tpu.trainer.trainer as jtrainer
import tianshou_tpu_torch.highlevel.experiment as texp
import tianshou_tpu_torch.highlevel.params as tpar
import tianshou_tpu_torch.trainer.trainer as ttrainer
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.env.classic.cartpole import CartPole as JCartPole
from tianshou_tpu.env.classic.pendulum import Pendulum as JPendulum
from tianshou_tpu.env.tictactoe import TicTacToeEnv as JTicTacToe
from tianshou_tpu.env.wrappers import ContinuousToDiscrete as JC2D
from tianshou_tpu.highlevel import config as jcfg
from tianshou_tpu.highlevel import trainer as jhtr
from tianshou_tpu_torch.algorithm.base import Draws
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.classic.pendulum import Pendulum
from tianshou_tpu_torch.env.tictactoe import TicTacToeEnv
from tianshou_tpu_torch.env.wrappers import ContinuousToDiscrete
from tianshou_tpu_torch.highlevel import config as tcfg
from tianshou_tpu_torch.highlevel import trainer as thtr
from tianshou_tpu_torch.models.convert import train_state_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

B = 8
EXPERT = (np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32),
          np.random.default_rng(1).uniform(-1, 1, (64, 1)).astype(np.float32))

ENVS = {  # name: (JAX env factory, port env factory)
    "cartpole": (JCartPole, CartPole),
    "pendulum": (JPendulum, Pendulum),
    "bdqn": (lambda: JC2D(JPendulum(), 5), lambda: ContinuousToDiscrete(Pendulum(), 5)),
    "tictactoe": (JTicTacToe, TicTacToeEnv),
}


def configure(name: str, b, P):
    """The builder calls of each case, with ``P`` the package's params module."""
    if name == "DQN":
        b.with_dqn_params(gamma=0.97, n_step_return_horizon=3, target_update_freq=320, eps_training=0.3)
    elif name == "DQN_typed":
        b.with_dqn_params(P.DQNParams(lr=1e-3, eps_training=0.3, target_update_freq=100, n_step_return_horizon=3,
                                      lr_scheduler=P.LRSchedulerFactoryLinear(), max_grad_norm=1.0))
    elif name == "DQN_icm":
        b.with_dqn_params(eps_training=0.3).with_icm(feature_dim=16)
    elif name == "PPO":
        b.with_params(P.PPOParams(lr=3e-4, lr_scheduler=P.LRSchedulerFactoryLinear(), max_grad_norm=0.5))
    elif name == "SAC":
        b.with_params(P.SACParams(actor_lr=1e-3, critic_lr=1e-3, alpha=0.2, tau=0.005))
    elif name == "DDPG":
        b.with_params(P.DDPGParams(exploration_noise=0.2))
    elif name == "QRDQN":
        b.with_dqn_params(P.QRDQNParams(num_quantiles=32, eps_training=0.3))
    elif name == "FQF":
        b.with_dqn_params(P.FQFParams(num_fractions=16, eps_training=0.3))
    elif name == "Rainbow":
        b.with_dqn_params(P.RainbowParams(num_atoms=21, v_min=0, v_max=200, eps_training=0.3))
    elif name == "BDQN":
        b.with_dqn_params(eps_training=0.3, target_update_freq=100)
    elif name == "GAIL":
        b.with_expert_data(*EXPERT)
    elif name == "CQL":
        b.with_params(actor_lr=1e-4)
    elif name == "DiscreteCQL":
        b.with_params(num_quantiles=16, hidden_sizes=(32,))
    return b


CASES = {  # case: (builder class name, env, training config class name)
    "DQN": ("DQNExperimentBuilder", "cartpole", "OffPolicyTrainingConfig"),
    "DQN_typed": ("DQNExperimentBuilder", "cartpole", "OffPolicyTrainingConfig"),
    "DQN_icm": ("DQNExperimentBuilder", "cartpole", "OffPolicyTrainingConfig"),
    "PPO": ("PPOExperimentBuilder", "cartpole", "OnPolicyTrainingConfig"),
    "A2C": ("A2CExperimentBuilder", "cartpole", "OnPolicyTrainingConfig"),
    "Reinforce": ("ReinforceExperimentBuilder", "cartpole", "OnPolicyTrainingConfig"),
    "NPG": ("NPGExperimentBuilder", "pendulum", "OnPolicyTrainingConfig"),
    "TRPO": ("TRPOExperimentBuilder", "cartpole", "OnPolicyTrainingConfig"),
    "SAC": ("SACExperimentBuilder", "pendulum", "OffPolicyTrainingConfig"),
    "TD3": ("TD3ExperimentBuilder", "pendulum", "OffPolicyTrainingConfig"),
    "DDPG": ("DDPGExperimentBuilder", "pendulum", "OffPolicyTrainingConfig"),
    "REDQ": ("REDQExperimentBuilder", "pendulum", "OffPolicyTrainingConfig"),
    "C51": ("C51ExperimentBuilder", "cartpole", "OffPolicyTrainingConfig"),
    "IQN": ("IQNExperimentBuilder", "cartpole", "OffPolicyTrainingConfig"),
    "DiscreteSAC": ("DiscreteSACExperimentBuilder", "cartpole", "OffPolicyTrainingConfig"),
    "QRDQN": ("QRDQNExperimentBuilder", "cartpole", "OffPolicyTrainingConfig"),
    "FQF": ("FQFExperimentBuilder", "cartpole", "OffPolicyTrainingConfig"),
    "Rainbow": ("RainbowExperimentBuilder", "cartpole", "OffPolicyTrainingConfig"),
    "BDQN": ("BDQNExperimentBuilder", "bdqn", "OffPolicyTrainingConfig"),
    "GAIL": ("GAILExperimentBuilder", "pendulum", "OnPolicyTrainingConfig"),
    "CQL": ("CQLExperimentBuilder", "pendulum", "OfflineTrainingConfig"),
    "TD3BC": ("TD3BCExperimentBuilder", "pendulum", "OfflineTrainingConfig"),
    "BCQ": ("BCQExperimentBuilder", "pendulum", "OfflineTrainingConfig"),
    "ImitationLearning": ("ImitationLearningExperimentBuilder", "cartpole", "OfflineTrainingConfig"),
    "ImitationLearning_continuous": ("ImitationLearningExperimentBuilder", "pendulum", "OfflineTrainingConfig"),
    "DiscreteBCQ": ("DiscreteBCQExperimentBuilder", "cartpole", "OfflineTrainingConfig"),
    "DiscreteCQL": ("DiscreteCQLExperimentBuilder", "cartpole", "OfflineTrainingConfig"),
    "DiscreteCRR": ("DiscreteCRRExperimentBuilder", "cartpole", "OfflineTrainingConfig"),
    "MARL": ("MARLExperimentBuilder", "tictactoe", "OffPolicyTrainingConfig"),
}


def test_every_jax_builder_has_a_case_and_a_port_builder():
    jax_builders = {n for n, v in vars(jexp).items() if isinstance(v, type) and n.endswith("ExperimentBuilder")
                    and n != "ExperimentBuilder"}
    assert len(jax_builders) == 26
    assert {c[0] for c in CASES.values()} == jax_builders
    for n in jax_builders:
        assert issubclass(getattr(texp, n), texp.ExperimentBuilder), n
    assert set(jexp.__all__) == set(texp.__all__)
    assert set(jpar.__all__) == set(tpar.__all__)


def build(case: str, jax_side: bool):
    cls_name, env_name, tc = CASES[case]
    mod, P, cfg = (jexp, jpar, jcfg) if jax_side else (texp, tpar, tcfg)
    env_factory = ENVS[env_name][0 if jax_side else 1]
    kw = dict(config=cfg.ExperimentConfig(seed=0, persistence_enabled=False), training=getattr(cfg, tc)())
    if cls_name == "MARLExperimentBuilder":
        kw["n_agents"] = 2
    b = configure(case.split("_")[0] if case not in ("DQN_typed", "DQN_icm") else case,
                  getattr(mod, cls_name)(env_factory, **kw), P)
    env = env_factory()
    return b, env, b._make_algo(env)


# ---------------------------------------------------------------------------
# comparing algorithms
# ---------------------------------------------------------------------------
SCALARS = (bool, int, float, str, type(None))
#: arguments of the JAX ``Algorithm`` base (None unless given; nothing reads them) that the port's base never took
JAX_ONLY = {"observation_space", "lr_schedule"}
#: JAX attribute -> the port's name for it (BCQ keeps its actor optimizer as the DDPG base's)
ALIASES = {"actor_optim": "policy_optim"}


def _optimizer_steps(jtx, factory):
    """Three steps of the JAX optax transformation and of the port's factory
    on the same parameters and gradients (the gradient's norm above any clip)."""
    p0 = np.linspace(-1.0, 1.0, 7).astype(np.float32)
    grads = [np.linspace(3.0, -2.0, 7).astype(np.float32) * (i + 1) for i in range(3)]
    jp, state = jnp.asarray(p0), jtx.init(jnp.asarray(p0))
    for g in grads:
        upd, state = jtx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = factory.create([tp])
    for g in grads:
        tp.grad = torch.from_numpy(g)
        factory.step(opt)
    return tp.detach().numpy(), np.asarray(jp)


def assert_same_optimizer(jtx, factory, name):
    assert isinstance(jtx, optax.GradientTransformation), name
    got, want = _optimizer_steps(jtx, factory)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)


def assert_same_hyperparameters(jalgo, talgo, path="algo"):
    assert type(talgo).__name__ == type(jalgo).__name__, path
    jv, tv = vars(jalgo), vars(talgo)
    compared = 0
    for k, v in jv.items():
        if k in JAX_ONLY:
            assert v is None, f"{path}.{k}"
        elif isinstance(v, SCALARS):
            assert k in tv, f"{path}.{k} missing in the port"
            assert tv[k] == v and type(tv[k]) is type(v), (f"{path}.{k}", tv[k], v)
            compared += 1
        elif isinstance(v, tuple) and all(isinstance(x, SCALARS) for x in v):
            assert tuple(tv[k]) == v, f"{path}.{k}"
        elif isinstance(v, optax.GradientTransformation):
            assert_same_optimizer(v, tv[ALIASES.get(k, k)], f"{path}.{k}")
            compared += 1
        elif type(v).__name__ == "GaussianNoise":
            assert (tv[k].mu, tv[k].sigma) == (v.mu, v.sigma), f"{path}.{k}"
        elif k in ("wrapped", "algorithms"):
            for i, (a, b) in enumerate(zip(v if k == "algorithms" else [v], tv[k] if k == "algorithms" else [tv[k]])):
                assert_same_hyperparameters(a, b, f"{path}.{k}[{i}]")
            compared += 1
    assert compared > 0, path


def jax_obs(env_name: str, rng):
    if env_name == "tictactoe":
        mask = rng.random((B, 9)) < 0.6
        mask[:, 4] = True
        d = dict(agent_id=rng.integers(0, 2, B).astype(np.int32),
                 obs=rng.integers(0, 2, (B, 3, 3, 2)).astype(np.float32), mask=mask)
        return JBatch(**{k: jnp.asarray(v) for k, v in d.items()}), Batch(**{k: torch.as_tensor(v) for k, v in d.items()})
    dim = 4 if env_name == "cartpole" else 3
    x = rng.standard_normal((B, dim)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def obs_example(env_name: str):
    if env_name == "tictactoe":
        return JBatch(agent_id=jnp.int32(0), obs=jnp.zeros((3, 3, 2)), mask=jnp.ones(9, bool))
    return jnp.zeros(4 if env_name == "cartpole" else 3)


def port_draws(case: str, talgo, key):
    """What the port's forward draws, as the JAX forward draws it from ``key``."""
    if case == "IQN":
        return Draws(taus=torch.from_numpy(np.array(jax.random.uniform(key, (B, talgo.sample_size)))))
    if case == "BCQ":
        n = talgo.forward_sampled_times
        return Draws(decode=torch.from_numpy(np.array(jax.random.normal(key, (B * n, talgo.vae.latent_dim)))))
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("case", list(CASES))
def test_builder_makes_the_jax_algorithm_and_acts_alike(case):
    _, jenv, jalgo = build(case, True)
    _, tenv, talgo = build(case, False)
    assert_same_hyperparameters(jalgo, talgo)
    env_name = CASES[case][1]
    jts = jalgo.init(jax.random.key(0), obs_example(env_name))
    tts = train_state_from_flax(jts, talgo.init("cpu"))  # strict loads: every net's shapes equal
    n_jax = sum(x.size for x in jax.tree.leaves(jts.params if not isinstance(jts, dict) else
                                                 {k: v.params for k, v in jts.items()}))
    models = [tts.model] if not isinstance(tts, dict) else [v.model for v in tts.values()]
    assert sum(p.numel() for m in models for p in m.state_dict().values()) == n_jax
    jo, to = jax_obs(env_name, np.random.default_rng(2))
    key = jax.random.key(3)
    jout = jalgo.forward(jts, jo, key, deterministic=True)
    tout = talgo.forward(tts, to, port_draws(case, talgo, key), deterministic=True)
    ja, ta = np.asarray(jout.act), tout.act.numpy()
    assert ta.shape == ja.shape
    if talgo.is_discrete:
        np.testing.assert_array_equal(ta, ja)
        if "q" in tout.info:
            np.testing.assert_allclose(tout.info.q.numpy(), np.asarray(jout.info.q), rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-5)
        np.testing.assert_allclose(talgo.map_action(tout.act).numpy(), np.asarray(jalgo.map_action(jout.act)),
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Params and their transformer chains
# ---------------------------------------------------------------------------
PARAMS_CASES = [
    ("ReinforceParams", {}), ("A2CParams", {"max_grad_norm": 0.5}),
    ("PPOParams", {"lr_scheduler": "linear", "dual_clip": 3.0}), ("NPGParams", {"actor_step_size": 0.1}),
    ("TRPOParams", {"max_kl": 0.02}), ("DQNParams", {"lr_scheduler": "linear", "max_grad_norm": 1.0}),
    ("C51Params", {}), ("RainbowParams", {"num_atoms": 21}), ("QRDQNParams", {}), ("IQNParams", {}),
    ("FQFParams", {"fraction_lr": 1e-4}), ("BDQNParams", {}), ("DDPGParams", {"exploration_noise": 0.3}),
    ("TD3Params", {"actor_lr_scheduler": "linear"}), ("SACParams", {"alpha": "auto"}), ("DiscreteSACParams", {}),
    ("REDQParams", {"critic_lr_scheduler": "linear"}),
]


@pytest.mark.parametrize("name,overrides", PARAMS_CASES, ids=[c[0] for c in PARAMS_CASES])
def test_params_resolve_to_the_same_keywords(name, overrides):
    out = []
    for P, cfg in ((jpar, jcfg), (tpar, tcfg)):
        kw = {k: (P.LRSchedulerFactoryLinear() if v == "linear" else v) for k, v in overrides.items()}
        params = getattr(P, name)(**kw)
        training = cfg.OnPolicyTrainingConfig(max_epochs=3, epoch_num_steps=4096, num_train_envs=8)
        out.append(params.create_kwargs(P.ParamTransformerData(env=None, training=training)))
    jkw, tkw = out
    assert set(tkw) == set(jkw)
    for k, v in jkw.items():
        if isinstance(v, optax.GradientTransformation):
            assert_same_optimizer(v, tkw[k], k)
        elif type(v).__name__ == "GaussianNoise":
            assert (tkw[k].mu, tkw[k].sigma) == (v.mu, v.sigma), k
        else:
            assert tkw[k] == v and type(tkw[k]) is type(v), (k, tkw[k], v)


def test_linear_scheduler_factory_sees_the_same_horizon():
    for training in (jcfg.OffPolicyTrainingConfig(max_epochs=2, epoch_num_steps=1000),
                     jcfg.OnPolicyTrainingConfig(max_epochs=2, epoch_num_steps=4096, batch_size=64)):
        ttraining = getattr(tcfg, type(training).__name__)(**dataclasses.asdict(training))
        jsched = jpar.LRSchedulerFactoryLinear().create(1e-3, training)
        tsched = tpar.LRSchedulerFactoryLinear().create(1e-3, ttraining)
        assert tsched.total_updates > 1
        for count in (0, 1, tsched.total_updates // 2, tsched.total_updates - 1, tsched.total_updates + 3):
            np.testing.assert_allclose(float(tsched(torch.tensor(count))), float(jsched(count)), rtol=1e-6, atol=1e-12)


def test_config_and_callback_dataclasses_match():
    for name in ("ExperimentConfig", "TrainingConfig", "OnPolicyTrainingConfig", "OffPolicyTrainingConfig",
                 "OfflineTrainingConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)()), name
    ctx = types.SimpleNamespace()
    for name, args in (("EpochTrainCallbackDQNSetEps", (0, 100)), ("EpochTrainCallbackDQNEpsLinearDecay", (1, 250_000)),
                       ("EpochTestCallbackDQNSetEps", (1, None))):
        assert getattr(thtr, name)().callback(*args, ctx) == getattr(jhtr, name)().callback(*args, ctx), name
    for t in (None, 10.0):
        for env in (types.SimpleNamespace(reward_threshold=5.0), types.SimpleNamespace()):
            c = types.SimpleNamespace(env=env)
            for r in (4.0, 7.0, 12.0):
                assert (thtr.EpochStopCallbackRewardThreshold(t).should_stop(r, c)
                        == jhtr.EpochStopCallbackRewardThreshold(t).should_stop(r, c))


# ---------------------------------------------------------------------------
# the trainer parameters Experiment.run assembles
# ---------------------------------------------------------------------------
class _Recorded(Exception):
    pass


def record_params(monkeypatch, trainer_module, cls_name: str, sink: list):
    def run(self, *args, **kwargs):
        sink.append(self.params)
        raise _Recorded

    monkeypatch.setattr(getattr(trainer_module, cls_name), "run", run)


def assert_same_trainer_params(tparams, jparams):
    for f in dataclasses.fields(jparams):
        jv, tv = getattr(jparams, f.name), getattr(tparams, f.name)
        if f.name == "logger":
            assert type(tv).__name__ == type(jv).__name__
        elif f.name == "stop_fn":
            assert (tv is None) == (jv is None)
            if jv is not None:
                assert [tv(r) for r in (0.0, 150.0, 195.0, 500.0)] == [jv(r) for r in (0.0, 150.0, 195.0, 500.0)]
        elif f.name in ("train_fn", "test_fn"):
            assert (tv is None) == (jv is None), f.name
            if jv is not None:
                assert [tv(e, s) for e, s in ((1, 0), (2, 2500))] == [jv(e, s) for e, s in ((1, 0), (2, 2500))]
        elif callable(jv):
            assert callable(tv) or tv is None, f.name
        else:
            assert tv == jv, (f.name, tv, jv)


BRANCHES = {  # branch: (trainer class, builder case, training keywords)
    "off_policy": ("OffPolicyTrainer", "DQN", dict(max_epochs=3, epoch_num_steps=5000, buffer_size=2000,
                                                   num_train_envs=4, num_test_envs=3, start_timesteps=100,
                                                   stop_threshold=195, batch_size=32)),
    "on_policy": ("OnPolicyTrainer", "PPO", dict(max_epochs=2, epoch_num_steps=256, num_train_envs=4,
                                                 batch_size=64, collection_step_num_env_steps=32)),
    "offline": ("OfflineTrainer", "CQL", dict(max_epochs=2, update_step_num_gradient_steps_per_epoch=30,
                                              batch_size=64, num_test_envs=4, test_step_num_episodes=2)),
    "host_off_policy": ("HostOffPolicyTrainer", "DQN", dict(max_epochs=2, epoch_num_steps=400, buffer_size=2000,
                                                            num_train_envs=2, num_test_envs=2, start_timesteps=50)),
    "host_on_policy": ("HostOnPolicyTrainer", "PPO", dict(max_epochs=1, epoch_num_steps=256, num_train_envs=2,
                                                          num_test_envs=2, batch_size=64,
                                                          collection_step_num_env_steps=32)),
    "marl": ("HostOffPolicyTrainer", "MARL", dict(max_epochs=2, epoch_num_steps=600, buffer_size=800,
                                                  num_train_envs=2, num_test_envs=2, test_step_num_episodes=4,
                                                  batch_size=64, collection_step_num_env_steps=16,
                                                  update_step_num_gradient_steps_per_sample=0.25,
                                                  start_timesteps=128)),
}


def _offline_dataset(jax_side: bool):
    rng = np.random.default_rng(0)
    n = 64
    arrays = dict(obs=rng.standard_normal((n, 3)).astype(np.float32), act=rng.uniform(-1, 1, (n, 1)).astype(np.float32),
                  rew=rng.standard_normal(n).astype(np.float32), terminated=np.zeros(n, bool),
                  truncated=np.zeros(n, bool), obs_next=rng.standard_normal((n, 3)).astype(np.float32))
    if jax_side:
        from tianshou_tpu.data.buffer.base import ReplayBuffer as JRB
        from tianshou_tpu.utils.persistence import buffer_from_data as jfrom

        return jfrom(JRB, **arrays)
    from tianshou_tpu_torch.data.buffer.base import ReplayBuffer
    from tianshou_tpu_torch.utils.persistence import buffer_from_data

    return buffer_from_data(ReplayBuffer, **arrays, device="cpu")


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_experiment_run_assembles_the_jax_trainer_params(branch, monkeypatch):
    cls_name, case, training = BRANCHES[branch]
    recorded = {}
    for jax_side, trainer_mod, mod, cfg, P in ((True, jtrainer, jexp, jcfg, jpar), (False, ttrainer, texp, tcfg, tpar)):
        sink = recorded.setdefault(jax_side, [])
        record_params(monkeypatch, trainer_mod, cls_name, sink)
        builder_cls, env_name, tc_name = CASES[case]
        tc = getattr(cfg, tc_name)(**training)
        config = cfg.ExperimentConfig(seed=3, persistence_enabled=False)
        if branch.startswith("host"):
            henv = (__import__("tianshou_tpu.highlevel.env", fromlist=["GymEnvFactory"]) if jax_side else
                    __import__("tianshou_tpu_torch.highlevel.env", fromlist=["GymEnvFactory"]))
            env_factory = henv.GymEnvFactory("CartPole-v1")
        else:
            env_factory = ENVS[env_name][0 if jax_side else 1]
        kw = dict(n_agents=2) if case == "MARL" else {}
        b = configure(case, getattr(mod, builder_cls)(env_factory, config=config, training=tc, **kw), P)
        if branch == "offline":
            b.with_dataset(*_offline_dataset(jax_side))
        if branch == "off_policy":
            b.with_epoch_train_callback(getattr(jhtr if jax_side else thtr, "EpochTrainCallbackDQNEpsLinearDecay")(
                1.0, 0.1, 5000))
            b.with_epoch_test_callback(getattr(jhtr if jax_side else thtr, "EpochTestCallbackDQNSetEps")(0.0))
        exp = b.build()
        with pytest.raises(_Recorded):
            exp.run("recorded") if jax_side else exp.run("recorded", device="cpu")
    (jparams,), (tparams,) = recorded[True], recorded[False]
    assert type(tparams).__name__ == type(jparams).__name__
    assert_same_trainer_params(tparams, jparams)


def test_space_info_matches_jax():
    """``utils/space_info.py`` over the port's spaces and Gymnasium's, against the JAX package's over its own."""
    gym = pytest.importorskip("gymnasium")
    from tianshou_tpu.env.core import Box as JBox
    from tianshou_tpu.env.core import Discrete as JDisc
    from tianshou_tpu.utils import space_info as jsi
    from tianshou_tpu_torch.env.core import Box, Discrete
    from tianshou_tpu_torch.utils import space_info as tsi

    pairs = [(Discrete(5), JDisc(5)), (Box([-1.0, -2.0], [1.0, 3.0]), JBox([-1.0, -2.0], [1.0, 3.0])),
             (gym.spaces.Box(-2.0, 2.0, (3, 2)), gym.spaces.Box(-2.0, 2.0, (3, 2))),
             (gym.spaces.Discrete(7), gym.spaces.Discrete(7))]
    for tspace, jspace in pairs:
        for cls in ("ActionSpaceInfo", "ObservationSpaceInfo"):
            t, j = getattr(tsi, cls).from_space(tspace), getattr(jsi, cls).from_space(jspace)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), cls
    for tenv, jenv in ((CartPole(), JCartPole()), (Pendulum(), JPendulum())):
        t, j = tsi.SpaceInfo.from_env(tenv), jsi.SpaceInfo.from_env(jenv)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
