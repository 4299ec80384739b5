"""Quaternion and rigid-body helpers (counterpart of
``surtr_tpu/physics/rigid.py``).

Quaternions are (w, x, y, z), unit length; angular velocity is in the world
frame; inertia tensors are stored in the body frame, the world inverse
inertia is R I⁻¹ Rᵀ.
"""

from __future__ import annotations

import torch

from plainref.ops.linalg import dot3, sqrt_rn


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """q / |q|, the norm summed in component order (w, x, y, z) so that the
    result is the same on every device."""
    w, x, y, z = q.unbind(-1)
    n = sqrt_rn(((w * w + x * x) + y * y) + z * z)[..., None]
    return q / torch.clamp(n, min=1e-12)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) → (..., 3, 3) rotation matrix. Kernel B5 repeats this
    formula term for term."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """q ← normalize(q + dt/2 · (0, ω) ⊗ q)."""
    wq = torch.cat([torch.zeros_like(w[..., :1]), w], dim=-1)
    return quat_normalize(q + 0.5 * dt * quat_mul(wq, q))


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors by quaternions (broadcasting on leading dims)."""
    return dot3(quat_to_mat(q), v[..., None, :])


def world_inv_inertia(q: torch.Tensor, inv_I_body: torch.Tensor) -> torch.Tensor:
    """R I⁻¹ Rᵀ, each entry a three-term sum in ``dot3`` order."""
    R = quat_to_mat(q)
    RI = dot3(R[..., :, None, :], inv_I_body.transpose(-1, -2)[..., None, :, :])
    return dot3(RI[..., :, None, :], R[..., None, :, :])
