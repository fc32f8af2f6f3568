"""Quaternion / vector / SAT geometry helpers (port of
`madrona_basketball_tpu.maths`, maths.py:1-108).

float32 and branchless (`torch.where` instead of the C++ early returns of
src/helper.cpp).  Every function works on the last axis and broadcasts
over any leading axes (the world axis, the agent axis), where the JAX
package applies them to one world under `vmap`.  Quaternions are stored
(w, x, y, z), the reference's export order.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

F32 = torch.float32


@functools.lru_cache(maxsize=None)
def _cached(values: tuple, shape: tuple, device: str, dtype):
    return torch.tensor(values, dtype=dtype,
                        device=torch.device(device)).reshape(shape)


def const(values, device, dtype=F32) -> torch.Tensor:
    """A constant tensor, made once per (values, device, dtype): a host
    copy made inside a CUDA graph capture would fail, so the constants of
    a captured tick are made by its warm-up call.  Do not write to it."""
    a = np.asarray(values)
    return _cached(tuple(a.reshape(-1).tolist()), a.shape,
                   str(torch.device(device)), dtype)


def _vec(v, like: torch.Tensor):
    return v if isinstance(v, torch.Tensor) else const(v, like.device)


def quat_id(device="cpu"):
    return const([1.0, 0.0, 0.0, 0.0], device)


def quat_angle_axis(angle, axis):
    """Quat::angleAxis: `axis` (..., 3) unit length, `angle` (...) a
    float32 tensor in radians -> (..., 4)."""
    axis = _vec(axis, angle)
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_mul(a, b):
    """Hamilton product a * b (b's rotation first, then a's)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def cross(u, v):
    """u x v over the last axis, as `jnp.cross` computes it."""
    u0, u1, u2 = u.unbind(-1)
    v0, v1, v2 = v.unbind(-1)
    return torch.stack([u1 * v2 - u2 * v1, u2 * v0 - u0 * v2,
                        u0 * v1 - u1 * v0], dim=-1)


def quat_rotate(q, v):
    """Rotate v (..., 3) by the unit quaternion q (..., 4)
    (Quat::rotateVec)."""
    v = _vec(v, q)
    w = q[..., 0:1]
    u = q[..., 1:4]
    t = 2.0 * cross(u, v.expand_as(u))
    return v + w * t + cross(u, t)


def length2(v):
    return (v * v).sum(dim=-1)


def length(v):
    return torch.sqrt(length2(v))


def safe_normalize(v, eps=1e-30):
    """v / |v| guarded against a zero vector (which gives ~0)."""
    l2 = length2(v)
    return v * torch.where(l2 > 0.0,
                           1.0 / torch.sqrt(torch.clamp(l2, min=eps)),
                           0.0)[..., None]


def normalize_unsafe(v):
    """v / |v| exactly as madrona's normalize (inf / nan on zero)."""
    return v / length(v)[..., None]


def find_rotation_between_vectors(start, target):
    """The quaternion aligning `start` with `target` (src/helper.cpp:
    14-42): aligned -> identity, opposite -> 180 degrees about Z, else
    angle-axis about the normalized cross product."""
    start = _vec(start, target).expand_as(target)
    s = safe_normalize(start)
    t = safe_normalize(target)
    d = (s * t).sum(dim=-1)
    axis = safe_normalize(cross(s, t))
    general = quat_angle_axis(torch.acos(torch.clamp(d, -1.0, 1.0)), axis)
    opposite = quat_angle_axis(torch.full_like(d, math.pi),
                               _vec([0.0, 0.0, 1.0], d).expand_as(axis))
    out = torch.where((d < -0.999999)[..., None], opposite, general)
    return torch.where((d > 0.999999)[..., None],
                       quat_id(d.device).expand_as(out), out)


def project_rectangle(vertices, axis):
    """SAT projection of (..., 4, 3) vertices onto (..., 3) axes -> (min,
    max) (src/helper.cpp:85-100)."""
    projs = (vertices * axis[..., None, :]).sum(dim=-1)
    return projs.min(dim=-1).values, projs.max(dim=-1).values


def projections_overlap(p1_min, p1_max, p2_min, p2_max):
    """Strict-overlap test (src/helper.cpp:103-105)."""
    return (p1_max > p2_min) & (p2_max > p1_min)
