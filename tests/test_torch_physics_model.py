"""The port's MJCF loader and Model against the JAX package's: the port reads
its own packaged assets, the JAX package the installed gymnasium ones; every
numeric table must be equal exactly (both are numpy float64)."""

import dataclasses
import os

import numpy as np
import pytest

from tianshou_tpu.env.physics.mjcf import gym_asset_path
from tianshou_tpu.env.physics.mjcf import load_mjcf as jax_load
from tianshou_tpu_torch.env.physics import mjcf as tmjcf
from tianshou_tpu_torch.env.physics.model import ARRAY_FIELDS, SCALAR_FIELDS, model_from_arrays
from tianshou_tpu_torch.ops.kernels.physics_fused import TASK_ASSETS
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TASKS = sorted(TASK_ASSETS)


@pytest.fixture(scope="module")
def models():
    return {t: (jax_load(TASK_ASSETS[t]), tmjcf.load_mjcf(TASK_ASSETS[t])) for t in TASKS}


@pytest.mark.parametrize("task", TASKS)
def test_packaged_asset_is_the_gymnasium_file(task):
    with open(gym_asset_path(TASK_ASSETS[task]), "rb") as a, open(tmjcf.asset_path(TASK_ASSETS[task]), "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(tmjcf.asset_path(TASK_ASSETS[task])).endswith(os.path.join("env", "physics", "assets"))


@pytest.mark.parametrize("task", TASKS)
def test_model_tables_equal_exactly(models, task):
    jm, tm = models[task]
    for name in ARRAY_FIELDS:
        a, b = np.asarray(getattr(jm, name)), np.asarray(getattr(tm, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in SCALAR_FIELDS:
        assert getattr(jm, name) == getattr(tm, name), name
    assert jm.parent == tm.parent and jm.body_names == tm.body_names
    assert jm.floor_friction == tm.floor_friction and jm.floor_margin == tm.floor_margin
    assert jm.floor_solref == tm.floor_solref and jm.floor_solimp == tm.floor_solimp


@pytest.mark.parametrize("task", TASKS)
def test_joint_actuator_and_geom_tables_equal(models, task):
    jm, tm = models[task]
    assert len(jm.joints) == len(tm.joints) and len(jm.actuators) == len(tm.actuators)
    for a, b in zip(jm.joints, tm.joints):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in da:
            np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]), err_msg=f"joint {a.name}.{k}")
    for a, b in zip(jm.actuators, tm.actuators):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert len(jm.geoms) == len(tm.geoms)
    for a, b in zip(jm.geoms, tm.geoms):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in da:
            np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]), err_msg=f"geom {a.name}.{k}")


def jax_model_as_plain_data(jm):
    """The JAX package's Model as the plain dict/list form model_from_arrays takes."""
    fields = {k: np.asarray(getattr(jm, k)) for k in ARRAY_FIELDS}
    fields.update({k: getattr(jm, k) for k in SCALAR_FIELDS})
    fields.update(parent=list(jm.parent), body_names=list(jm.body_names))
    return fields, [dataclasses.asdict(j) for j in jm.joints], [dataclasses.asdict(a) for a in jm.actuators]


@pytest.mark.parametrize("task", TASKS)
def test_model_from_arrays_rebuilds_the_jax_model(models, task):
    jm, tm = models[task]
    built = model_from_arrays(*jax_model_as_plain_data(jm))
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(built, name)), np.asarray(getattr(tm, name)), err_msg=name)
    for name in SCALAR_FIELDS:
        assert getattr(built, name) == getattr(tm, name), name
    assert [dataclasses.asdict(j).keys() for j in built.joints] == [dataclasses.asdict(j).keys() for j in tm.joints]
    assert [j.q_idx for j in built.joints] == [j.q_idx for j in tm.joints]


def test_model_from_arrays_names_missing_fields():
    with pytest.raises(ValueError, match="missing fields"):
        model_from_arrays({"nq": 1}, [], [])


def test_unknown_asset_raises():
    with pytest.raises(FileNotFoundError):
        tmjcf.load_mjcf("no_such_model.xml")
    assert tmjcf.load_mjcf("humanoid.xml").nq == 23  # packaged since Humanoid was ported
