"""Articulated rigid-body physics on batched torch tensors (port of
``tianshou_tpu/env/physics``).

Forward kinematics is the only hand-written model function; Jacobians, mass
matrices, bias forces and contact-point accelerations come from evaluating it
over truncated Taylor values (:mod:`.jet`). Models are loaded from the
packaged Gymnasium MJCF assets (an MJCF subset parser in :mod:`.mjcf`), so
geometry, masses, gears, damping and joint limits match the benchmark
environments.
"""

from tianshou_tpu_torch.env.physics.dynamics import forward_kinematics, init_state, step
from tianshou_tpu_torch.env.physics.mjcf import load_mjcf
from tianshou_tpu_torch.env.physics.model import Model

__all__ = ["Model", "load_mjcf", "step", "forward_kinematics", "init_state"]
