"""Quaternion / rotation utilities (wxyz convention), broadcasting over
leading axes — the torch form of neoplanner_tpu/core/frames.py:13-122."""

from __future__ import annotations

import torch


def quat_identity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (body -> world for an attitude)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrix (row-major, body->world)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    half = yaw * 0.5
    zeros = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def quat_from_accel_yaw(acc: torch.Tensor, yaw: torch.Tensor,
                        g: float = 9.81) -> torch.Tensor:
    """Differential-flatness attitude: body z aligns with thrust = acc + g e_z
    (traj_planner_node.py:667-698)."""
    thrust = acc + acc.new_tensor([0.0, 0.0, g])
    zb = thrust / (torch.linalg.vector_norm(thrust, dim=-1, keepdim=True) + 1e-9)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    xc = torch.stack([cy, sy, torch.zeros_like(cy)], dim=-1)
    yb = _cross(zb, xc)
    yb = yb / (torch.linalg.vector_norm(yb, dim=-1, keepdim=True) + 1e-9)
    xb = _cross(yb, zb)
    rot = torch.stack([xb, yb, zb], dim=-1)  # columns are body axes in world
    return matrix_to_quat(rot)


def matrix_to_quat(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz: the four Shepperd candidates, picked by
    the largest pivot (first on ties, as argmax)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 0.5
    w_big = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                         (m10 - m01) / (4 * qw)], dim=-1)
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 0.5
    x_big = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                         (m02 + m20) / (4 * qx)], dim=-1)
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 0.5
    y_big = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                         (m12 + m21) / (4 * qy)], dim=-1)
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 0.5
    z_big = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                         (m12 + m21) / (4 * qz), qz], dim=-1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([w_big, x_big, y_big, z_big], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4))).squeeze(-2)
    return quat_normalize(q)
