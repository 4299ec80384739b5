"""Camera and light transforms (counterpart of ``surtr_tpu/render/camera.py``).

The matrices are built on the CPU in float32 from host inputs, whatever
device renders with them: the caller copies them over, so a frame on the
card and its plain run on the CPU use the same bits and no host sync is
added. Conventions: perspective camera, directional-light ortho frustum fit
to a bounding sphere, NDC depth in [0, 1] (D3D style).

Every product is written out in a fixed order (``mat4``, ``dot3``) and every
square root is ``sqrt_rn``, so the result does not depend on the CPU's
vector unit.
"""

from __future__ import annotations

import torch

from plainref.ops.hull import _cross
from plainref.ops.linalg import dot3, sqrt_rn


def _vec(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).detach().cpu().reshape(-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-12), the norm summed in component order."""
    return v / torch.clamp(sqrt_rn(dot3(v, v)), min=1e-12)


def mat4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(4, 4) @ (4, 4), each entry (a0·b0 + a1·b1) + (a2·b2 + a3·b3), the
    order XLA:CPU sums a length-4 contraction in."""
    bt = b.T
    return ((a[:, None, 0] * bt[None, :, 0] + a[:, None, 1] * bt[None, :, 1])
            + (a[:, None, 2] * bt[None, :, 2] + a[:, None, 3] * bt[None, :, 3]))


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    eye, target, up = _vec(eye), _vec(target), _vec(up)
    f = normalize(target - eye)
    r = normalize(_cross(f, up))
    u = _cross(r, f)
    m = torch.eye(4, dtype=torch.float32)
    m[0, :3], m[1, :3], m[2, :3] = r, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -dot3(r, eye), -dot3(u, eye), dot3(f, eye)
    return m


def perspective(fov_deg, aspect, znear, zfar) -> torch.Tensor:
    """Right-handed, depth → [0, 1]. ``f`` in float32 as the JAX package
    computes it; the other entries are Python floats rounded once."""
    f = 1.0 / torch.tan(torch.deg2rad(torch.tensor(float(fov_deg))) / 2.0)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = f / float(aspect)
    m[1, 1] = f
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = znear * zfar / (znear - zfar)
    m[3, 2] = -1.0
    return m


def ortho(l, r, b, t, n, f) -> torch.Tensor:
    """Right-handed ortho, depth → [0, 1], from Python floats."""
    m = torch.eye(4, dtype=torch.float32)
    m[0, 0], m[0, 3] = 2.0 / (r - l), -(r + l) / (r - l)
    m[1, 1], m[1, 3] = 2.0 / (t - b), -(t + b) / (t - b)
    m[2, 2], m[2, 3] = 1.0 / (n - f), n / (n - f)
    return m


def light_view_proj(light_dir, center, radius: float) -> torch.Tensor:
    """Directional-light ortho frustum fit to a bounding sphere of
    ``radius`` about ``center``."""
    d = normalize(_vec(light_dir))
    center = _vec(center)
    eye = center - d * (2.0 * radius)
    up = (1.0, 0.0, 0.0) if abs(float(d[1])) > 0.95 else (0.0, 1.0, 0.0)
    view = look_at(eye, center, up)
    proj = ortho(-radius, radius, -radius, radius, 0.1, 4.0 * radius)
    return mat4(proj, view)


def camera_view_proj(eye, target, fov_deg, aspect, znear, zfar) -> torch.Tensor:
    """perspective(...) @ look_at(eye, target)."""
    return mat4(perspective(fov_deg, aspect, znear, zfar), look_at(eye, target))
