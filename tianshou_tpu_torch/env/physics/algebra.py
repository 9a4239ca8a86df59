"""Rotation helpers for the physics core (quaternion / rotation-vector /
Rodrigues), the counterpart of ``tianshou_tpu/env/physics/algebra.py``.

Every function takes batched input: vectors ``[..., 3]``, quaternions
``[..., 4]`` (w, x, y, z), matrices ``[..., 3, 3]``. ``hat``,
``axis_angle_mat`` and ``rotvec_to_mat`` use only arithmetic that a
:class:`~tianshou_tpu_torch.env.physics.jet.Jet` also offers, so forward
kinematics can push tangents through them.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.env.physics.jet import Jet, stack

__all__ = ["quat_to_mat", "mat_to_quat", "rotvec_to_mat", "axis_angle_mat", "rotvec_to_quat", "vee", "hat"]

_EPS = 1e-9


def hat(v):
    """3-vectors ``[..., 3]`` -> skew matrices with ``hat(v) @ x == cross(v, x)``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = x * 0.0
    return stack([stack([o, -z, y], -1), stack([z, o, -x], -1), stack([-y, x, o], -1)], -2)


def vee(m):
    """Inverse of :func:`hat` for (possibly non-exactly) skew matrices ``[..., 3, 3]``."""
    return stack([m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]], -1) * 0.5


def _mm(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z) ``[..., 4]`` -> rotation matrices."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.clamp(w * w + x * x + y * y + z * z, min=_EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], -2)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> unit quaternions (w, x, y, z) in the ``w >= 0``
    hemisphere: all four candidates are built and the one with the largest
    pivot is taken."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    p = torch.stack([1.0 + tr, 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                     1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1)
    s = torch.sqrt(torch.clamp(p, min=_EPS))
    a, b, c = m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]
    d, e, f = m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1]
    s0, s1, s2, s3 = s.unbind(-1)
    cands = torch.stack([
        torch.stack([s0, a / s0, b / s0, c / s0], -1),
        torch.stack([a / s1, s1, d / s1, e / s1], -1),
        torch.stack([b / s2, d / s2, s2, f / s2], -1),
        torch.stack([c / s3, e / s3, f / s3, s3], -1),
    ], -2)
    idx = torch.argmax(p, dim=-1)
    q = 0.5 * torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4)).squeeze(-2)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.sign(q[..., :1] + _EPS)


def axis_angle_mat(axis: torch.Tensor, angle):
    """Rodrigues rotation about one static unit ``axis [3]`` by batched ``angle [...]``."""
    k = hat(axis)
    kk = k @ k
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    s, c = angle.sin(), angle.cos()
    return s[..., None, None] * k + (1.0 - c)[..., None, None] * kk + eye


def rotvec_to_mat(r):
    """Rotation vectors (exp map) ``[..., 3]`` -> rotation matrices, in the
    sinc-style Rodrigues form that stays smooth at ``r -> 0``. The same
    ``_EPS`` regularises it as in the JAX package, so values and derivatives
    agree there too."""
    t2 = (r * r).sum(-1)
    t = (t2 + _EPS).sqrt()
    k = hat(r)
    a = t.sin() / t
    b = (1.0 - t.cos()) / (t2 + _EPS)
    ref = r.v if isinstance(r, Jet) else r
    eye = torch.eye(3, dtype=ref.dtype, device=ref.device)
    return a[..., None, None] * k + b[..., None, None] * _mm(k, k) + eye


def rotvec_to_quat(r: torch.Tensor) -> torch.Tensor:
    t = torch.sqrt((r * r).sum(-1, keepdim=True) + _EPS)
    half = 0.5 * t
    return torch.cat([torch.cos(half), r * (torch.sin(half) / t)], -1)
