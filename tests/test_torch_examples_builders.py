"""What the port's example scripts build against what the JAX scripts build,
one script per runner: ``atari_rainbow`` and ``atari_ppo`` (``atari/_runner.py``),
``mujoco_sac`` and ``mujoco_ppo`` (their own ``train``), ``mujoco_trpo``
(``mujoco/_runner.py``), ``mujoco_sac_hl`` (``mujoco/_hl.py``),
``dqn_cartpole`` and ``cql_pendulum`` (``offline/_gather.py``). ``tests/test_torch_examples_builders_{atari,
mujoco,misc}.py`` hold every other script that builds a trainer the same way, through the helpers here
(``check_atari_script``, ``check_trained_script``, ``check_hl_script``).

Each side's ``__main__`` runs at its defaults (the JAX script through
``runpy``, the port's through ``main(["--device", "cpu"])``) while the
runner's ``run_*`` or the trainer's ``run`` is patched here to record what
the script built and stop. Held equal: the algorithm's class and every
scalar hyper-parameter it holds (γ, τ, n-step, α, atoms and support, target
period, ε, noise, ...), its optimizers (three steps on the same gradients:
rates and schedules), the nets' sizes (the sizes of their parameter
tensors), the replay's layout, the env counts and every trainer parameter,
``train_fn`` (the ε schedule) and ``stop_fn`` evaluated at a few steps
(``tests/test_torch_highlevel.py``'s comparisons). Nothing of ``examples/``
or ``tianshou_tpu/`` is edited.
"""

import dataclasses
import importlib
import runpy
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import tianshou_tpu.trainer.trainer as jtrainer
import tianshou_tpu_torch.trainer.trainer as ttrainer
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from examples_torch.atari import _runner as tr
from tests.test_torch_examples_cli import SIBLINGS, _jax_runner, port_module
from tests.test_torch_highlevel import assert_same_hyperparameters, assert_same_trainer_params

REPO = Path(__file__).resolve().parents[1]


class _Captured(Exception):
    pass


def _capture(monkeypatch, owner, name: str):
    """Patch ``owner.name`` to raise ``_Captured`` with its arguments (a method: ``self`` first)."""
    def record(*args, **kwargs):
        raise _Captured(args, kwargs)

    monkeypatch.setattr(owner, name, record)


def run_jax_script(rel: str, monkeypatch, patch, argv=()):
    """Run ``examples/<rel>``'s ``__main__`` with ``argv`` (none by default); ``patch(siblings)`` installs the
    captures (``siblings``: the script folder's ``_runner`` / ``_hl``, imported first). Returns the capture."""
    path = REPO / "examples" / rel
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    monkeypatch.syspath_prepend(str(path.parent))
    for name in SIBLINGS:
        monkeypatch.delitem(sys.modules, name, raising=False)
    try:
        siblings = {n: __import__(n) for n in SIBLINGS if (path.parent / f"{n}.py").is_file()}
        patch(siblings)
        with pytest.raises(_Captured) as got:
            runpy.run_path(str(path), run_name="__main__")
    finally:
        for name in SIBLINGS:
            sys.modules.pop(name, None)
    return got.value.args


def abstract_jax_init(monkeypatch, cls):
    """Make ``cls.init`` return the JAX train state's shapes and types (``jax.eval_shape``): the nets are
    compared by their sizes, and an abstract init skips compiling every initializer op by op."""
    init = cls.init
    monkeypatch.setattr(cls, "init", lambda self, key, example: jax.eval_shape(lambda k, e: init(self, k, e), key,
                                                                               example))


def run_port_script(rel: str, argv=("--device", "cpu")):
    with pytest.raises(_Captured) as got:
        port_module(rel).main(list(argv))
    return got.value.args


def jax_sizes(params) -> list[int]:
    return sorted(int(x.size) for x in jax.tree.leaves(params))


def port_sizes(module) -> list[int]:
    return sorted(p.numel() for p in module.state_dict().values())


def assert_same_nets(jts, tts):
    """The nets' parameter tensors have the same sizes: the JAX train state's ``params`` per top-level key
    against the port's train state's ``model`` entries (one net: the whole)."""
    jp = jts.params
    model = tts.model
    if hasattr(model, "keys") and isinstance(jp, dict) and set(jp) <= set(model.keys()):
        for key in jp:
            assert port_sizes(model[key]) == jax_sizes(jp[key]), key
    else:
        assert port_sizes(model) == jax_sizes(jp)


def assert_same_net_fields(jalgo, talgo):
    """Each flax net the JAX algorithm holds against the port's net of the same attribute name: every scalar or
    tuple field of the flax module that the port's module also keeps as an attribute (widths, heads, options)."""
    import flax.linen as fnn

    compared = 0
    for name, jnet in vars(jalgo).items():
        tnet = getattr(talgo, name, None)
        if not isinstance(jnet, fnn.Module) or tnet is None:
            continue
        for field in dataclasses.fields(jnet):
            value = getattr(jnet, field.name)
            if field.name in ("parent", "name") or not isinstance(value, (bool, int, float, str, tuple)):
                continue
            if hasattr(tnet, field.name):
                got = getattr(tnet, field.name)
                assert (tuple(got) if isinstance(value, tuple) else got) == value, (name, field.name, got, value)
                compared += 1
    return compared


def assert_same_buffer(jbuf, tbuf):
    assert type(tbuf).__name__ == type(jbuf).__name__
    for key in ("num_envs", "capacity", "stack_num", "save_only_last_obs", "ignore_obs_next", "alpha", "beta"):
        if hasattr(jbuf, key):
            assert getattr(tbuf, key) == getattr(jbuf, key), key


#: rewards at which the stop functions are held alike: every threshold of the scripts lies on this grid
REWARD_GRID = np.linspace(-2000.0, 2000.0, 16001)


def _num_envs(venv) -> int:
    """A device vector env's ``num_envs``, a host vector env's length."""
    return venv.num_envs if hasattr(venv, "num_envs") else len(venv)


def assert_same_trainers(jtrainer_obj, ttrainer_obj):
    assert type(ttrainer_obj).__name__ == type(jtrainer_obj).__name__
    assert_same_trainer_params(ttrainer_obj.params, jtrainer_obj.params)
    jstop, tstop = jtrainer_obj.params.stop_fn, ttrainer_obj.params.stop_fn
    if jstop is not None:
        assert [tstop(float(r)) for r in REWARD_GRID] == [jstop(float(r)) for r in REWARD_GRID]
    for name in ("train_collector", "test_collector"):
        jc, tc = getattr(jtrainer_obj, name, None), getattr(ttrainer_obj, name, None)
        assert (jc is None) == (tc is None), name
        if jc is not None:
            assert type(tc).__name__ == type(jc).__name__, name
            assert _num_envs(tc.venv) == _num_envs(jc.venv), name
            if hasattr(jc.venv, "env"):  # a device vector env: the env it steps
                assert type(tc.venv.env).__name__ == type(jc.venv.env).__name__, name
    if getattr(jtrainer_obj, "buffer", None) is not None:
        assert_same_buffer(jtrainer_obj.buffer, ttrainer_obj.buffer)


def _eps_schedules_agree(tparams, jparams):
    for step in (0, 2_500, 50_000, 99_999, 100_000, 400_000, 2_000_000):
        assert tparams.train_fn(1, step) == jparams.train_fn(1, step), step


# ---------------------------------------------------------------------------
# atari/_runner.py
# ---------------------------------------------------------------------------
ATARI = {"atari_rainbow": ("run_offpolicy", "OffPolicyTrainer"), "atari_ppo": ("run_onpolicy", "OnPolicyTrainer")}


@pytest.mark.parametrize("script", list(ATARI))
def test_atari_scripts_build_the_jax_algorithm_and_trainer(script, monkeypatch):
    check_atari_script(script, *ATARI[script], monkeypatch)


def check_atari_script(script: str, runner_fn: str, trainer_cls: str, monkeypatch):
    """``atari/<script>.py`` in both packages through its runner's ``runner_fn``: the parsed options, the
    algorithm and its nets, then the trainer of class ``trainer_cls`` that each runner assembles."""
    rel = f"atari/{script}.py"
    jargs, jkw = run_jax_script(rel, monkeypatch, lambda s: _capture(monkeypatch, s["_runner"], runner_fn))
    abstract_jax_init(monkeypatch, type(jargs[1]))
    tmod = port_module(rel)
    _capture(monkeypatch, tmod, runner_fn)
    targs, tkw = run_port_script(rel)
    (jns, jalgo), (tns, talgo) = jargs[:2], targs[:2]
    assert {**vars(jns), "device": "cpu"} == vars(tns)
    assert_same_hyperparameters(jalgo, talgo)
    assert_same_net_fields(jalgo, talgo)
    # the trainer each runner assembles (a small ring: its size is a CLI option, compared above)
    jns.buffer_size = tns.buffer_size = 16 * 10
    jr = _jax_runner()

    recorded = []
    for trainer_mod in (jtrainer, ttrainer):
        monkeypatch.setattr(getattr(trainer_mod, trainer_cls), "run",
                            lambda self, ts, *a: (recorded.append((self, ts)), (_ for _ in ()).throw(_Captured())))
    with pytest.raises(_Captured):
        (jr._run_offpolicy_device(jns, jalgo, 4.0) if trainer_cls == "OffPolicyTrainer" else jr.run_onpolicy(jns, jalgo))
    with pytest.raises(_Captured):
        if trainer_cls == "OffPolicyTrainer":
            tr._run_offpolicy_device(tns, talgo, 4.0, **tkw)
        else:
            tr.run_onpolicy(tns, talgo, **tkw)
    (jt, jts), (tt, tts) = recorded
    assert_same_nets(jts, tts)
    if script == "atari_rainbow":
        # the one departure: the port's Rainbow samples through a prioritized replay (alpha 0.6, beta 0.4)
        assert tkw == {"prioritized": True} and jkw == {}
        assert type(tt.buffer).__name__ == "PrioritizedReplayBuffer" and (tt.buffer.alpha, tt.buffer.beta) == (0.6, 0.4)
        assert (tt.buffer.num_envs, tt.buffer.capacity, tt.buffer.stack_num) == (
            jt.buffer.num_envs, jt.buffer.capacity, jt.buffer.stack_num)
        tt.buffer = None
        jt.buffer = None
        _eps_schedules_agree(tt.params, jt.params)
    assert_same_trainers(jt, tt)


# ---------------------------------------------------------------------------
# scripts that build their trainer themselves, and mujoco/_runner.py, mujoco/_hl.py
# ---------------------------------------------------------------------------
TRAINED = {  # script: (its trainer's class, the JAX algorithm's module and class)
    "mujoco/mujoco_sac.py": ("OffPolicyTrainer", "sac", "SAC"),
    "mujoco/mujoco_ppo.py": ("OnPolicyTrainer", "ppo", "PPO"),
    "mujoco/mujoco_trpo.py": ("OnPolicyTrainer", "trpo", "TRPO"),
    "discrete/dqn_cartpole.py": ("OffPolicyTrainer", "dqn", "DQN"),
}


@pytest.mark.parametrize("rel", list(TRAINED))
def test_scripts_build_the_jax_algorithm_and_trainer(rel, monkeypatch):
    trainer_cls, module, cls = TRAINED[rel]
    check_trained_script(rel, trainer_cls, f"tianshou_tpu.algorithm.modelfree.{module}:{cls}", monkeypatch)


def check_trained_script(rel: str, trainer_cls: str, jalgo: str, monkeypatch, argv=()):
    """``<rel>`` in both packages with the ``run`` of their trainer class ``trainer_cls`` captured, the JAX
    algorithm class ``jalgo`` (``module:Class``) initialized abstractly; ``argv`` after both scripts' names (and
    after the port's ``--device cpu``). Returns the two trainers and their train states."""
    module, cls = jalgo.split(":")
    abstract_jax_init(monkeypatch, getattr(importlib.import_module(module), cls))
    _capture(monkeypatch, getattr(jtrainer, trainer_cls), "run")
    (jt, jts, *_), _ = run_jax_script(rel, monkeypatch, lambda s: None, argv)
    _capture(monkeypatch, getattr(ttrainer, trainer_cls), "run")
    (tt, tts, *_), _ = run_port_script(rel, ("--device", "cpu", *argv))
    assert_same_hyperparameters(jt.algo, tt.algo)
    assert_same_net_fields(jt.algo, tt.algo)
    assert_same_nets(jts, tts)
    assert_same_trainers(jt, tt)
    return (jt, jts), (tt, tts)


def test_the_high_level_sac_script_builds_the_jax_experiment(monkeypatch, tmp_path):
    from tianshou_tpu.algorithm.modelfree.sac import SAC

    check_hl_script("mujoco/mujoco_sac_hl.py", "OffPolicyTrainer", SAC, monkeypatch, tmp_path)


def check_hl_script(rel: str, trainer_cls: str, jalgo_cls, monkeypatch, tmp_path):
    """``mujoco/<rel>`` in both packages through ``mujoco/_hl.py:run``: the parsed options, the builder's class,
    the training config, the params and every ``with_*`` factory; then the algorithm (JAX class ``jalgo_cls``),
    its nets and the trainer of class ``trainer_cls`` that each builder's experiment assembles."""
    monkeypatch.chdir(tmp_path)  # the experiment's persistence writes under ./log
    (jns, jbuilder_cls, jtraining), jkw = run_jax_script(rel, monkeypatch,
                                                         lambda s: _capture(monkeypatch, s["_hl"], "run"))
    tmod = port_module(rel)
    _capture(monkeypatch, tmod, "run")
    (tns, tbuilder_cls, ttraining), tkw = run_port_script(rel)
    assert {**vars(jns), "device": "cpu"} == vars(tns)
    assert tbuilder_cls.__name__ == jbuilder_cls.__name__
    assert type(ttraining).__name__ == type(jtraining).__name__
    assert dataclasses.asdict(ttraining) == dataclasses.asdict(jtraining)
    assert set(tkw) == set(jkw)
    assert dataclasses.asdict(tkw["params"]) == dataclasses.asdict(jkw["params"])
    factories = [key for key in jkw if key.startswith("with_")]
    for key in factories:
        assert vars(tkw[key]) == vars(jkw[key]), key
    # the builders' algorithms and the trainers their experiments assemble
    from examples_torch.mujoco import _hl as thl
    from tianshou_tpu.env.mujoco import make as jmake
    from tianshou_tpu.highlevel.config import ExperimentConfig as JExperimentConfig

    abstract_jax_init(monkeypatch, jalgo_cls)
    jb = jbuilder_cls(lambda: jmake(jns.task), JExperimentConfig(seed=jns.seed, watch=jns.watch), jtraining)
    jb.with_params(jkw["params"])
    for key in factories:
        getattr(jb, key)(jkw[key])
    tb = thl.build(tns, tbuilder_cls, ttraining, tkw["params"], **{k: v for k, v in tkw.items() if k != "params"})
    recorded = []
    for trainer_mod in (jtrainer, ttrainer):
        monkeypatch.setattr(getattr(trainer_mod, trainer_cls), "run",
                            lambda self, ts, *a: (recorded.append((self, ts)), (_ for _ in ()).throw(_Captured())))
    with pytest.raises(_Captured):
        jb.build().run("recorded")
    with pytest.raises(_Captured):
        tb.build().run("recorded", device="cpu")
    (jt, jts), (tt, tts) = recorded
    assert_same_hyperparameters(jt.algo, tt.algo)
    assert_same_net_fields(jt.algo, tt.algo)
    assert_same_nets(jts, tts)
    assert_same_trainers(jt, tt)


def test_the_offline_cql_script_builds_the_jax_algorithm_and_trainer(monkeypatch):
    """``offline/cql_pendulum.py``: the behavior run and the gathering stubbed on both sides (the run hands its
    train state back, the collect writes nothing), then the offline trainer recorded."""
    import tianshou_tpu.data.collector as jcollector
    import tianshou_tpu_torch.data.collector as tcollector
    from tianshou_tpu.algorithm.imitation.cql import CQL
    from tianshou_tpu.algorithm.modelfree.sac import SAC

    for trainer_mod, collector_mod in ((jtrainer, jcollector), (ttrainer, tcollector)):
        monkeypatch.setattr(trainer_mod.OffPolicyTrainer, "run",
                            lambda self, ts, *a: SimpleNamespace(best_reward=0.0, train_state=ts))
        monkeypatch.setattr(collector_mod.DeviceCollector, "collect", lambda self, ts, cs, bs, *a, **k: (cs, bs, None))
        _capture(monkeypatch, trainer_mod.OfflineTrainer, "run")
    for cls in (SAC, CQL):
        abstract_jax_init(monkeypatch, cls)
    rel = "offline/cql_pendulum.py"
    (jt, jts, *_), _ = run_jax_script(rel, monkeypatch, lambda s: None)
    (tt, tts, *_), _ = run_port_script(rel)
    assert_same_hyperparameters(jt.algo, tt.algo)
    assert_same_net_fields(jt.algo, tt.algo)
    assert_same_nets(jts, tts)
    assert_same_trainers(jt, tt)
