"""Contact prep with device dispatch (kernel B8, ``csrc/prep.cu``; replaces
``surtr_tpu/physics/prep_pallas.py`` ``_prep_kernel`` via
``prep_contacts_pallas``).

Single-piece bodies: row i is body i. C = K·M + G contact slots per row,
slot = m·K + k for pair slots, then G ground slots. Inputs (as the JAX
package lays them out):

  pt3 (Np, 3C)  [px | py | pz] contact points
  dh  (Np, 2C)  [depth | hit]
  pn3 (Np, 3K)  per-pair normals [nx | ny | nz] (ground slots get +y)
  btf (Np, 20K) per-pair partner fields, field-major:
                [xB(3) | inv_m | inv_I(9) | v0(3) | w0(3) | asleep]
  own (Np, 19)  [x(3) | v0(3) | w0(3) | inv_m | inv_I(9)]

Per slot: lever arms rA, rB; the effective mass 1/(kA + kB) of the normal
row; the restitution/Baumgarte target with the bounce threshold (no bias
against a sleeping partner); the pre-solve normal velocity vn0. Per row:
the mass-splitting scale 1/max(#hits, 1). Outputs, tight (no lane padding):

  rA, rB, n (Np, 3C) [x | y | z];  mt (Np, 2C) [m_eff | target];
  hs (Np, 2C) [hit | static];  scale (Np, 2) [inv_m·split, split];
  iAI (Np, 9) own world inverse inertia;  vn0 (Np, C)

``prep_contacts`` runs the plain version for CPU tensors and the kernel, or
raises, for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from surtr_tpu_torch import _build
from surtr_tpu_torch.physics.slots import expand_slots, slot_sum, tangent_basis

launches = 0  # kernel launches since the last reset (main-path proof)


def prep_contacts_reference(pt3, dh, pn3, btf, own, *, K: int, M: int, G: int, dt: float,
                            slop: float, baumgarte: float, restitution: float,
                            bounce_thr: float):
    """Plain version; every formula in the kernel's order."""
    Np = pt3.shape[0]
    C = K * M + G
    ptx, pty, ptz = pt3[:, :C], pt3[:, C : 2 * C], pt3[:, 2 * C :]
    dep, hit = dh[:, :C], dh[:, C:]
    ground = (torch.arange(C, device=pt3.device) >= K * M).to(pt3.dtype).expand(Np, C)
    nx = expand_slots(pn3[:, :K], M, G)
    ny = expand_slots(pn3[:, K : 2 * K], M, G) + ground
    nz = expand_slots(pn3[:, 2 * K :], M, G)

    bf = [expand_slots(btf[:, i * K : (i + 1) * K], M, G) for i in range(20)]
    xBx, xBy, xBz, iBm = bf[0], bf[1], bf[2], bf[3]
    iB = bf[4:13]
    vB0x, vB0y, vB0z, wB0x, wB0y, wB0z = bf[13:19]
    stat = torch.clamp(bf[19] + ground, max=1.0)
    live = 1.0 - stat

    o = [own[:, i : i + 1] for i in range(19)]
    ox, oy, oz, v0x, v0y, v0z, w0x, w0y, w0z, invm = o[:10]
    II = o[10:19]

    rAx, rAy, rAz = ptx - ox, pty - oy, ptz - oz
    rBx, rBy, rBz = ptx - xBx, pty - xBy, ptz - xBz

    cAx = rAy * nz - rAz * ny
    cAy = rAz * nx - rAx * nz
    cAz = rAx * ny - rAy * nx
    tAx = (II[0] * cAx + II[1] * cAy) + II[2] * cAz
    tAy = (II[3] * cAx + II[4] * cAy) + II[5] * cAz
    tAz = (II[6] * cAx + II[7] * cAy) + II[8] * cAz
    kA = ((invm + cAx * tAx) + cAy * tAy) + cAz * tAz
    cBx = rBy * nz - rBz * ny
    cBy = rBz * nx - rBx * nz
    cBz = rBx * ny - rBy * nx
    tBx = (iB[0] * cBx + iB[1] * cBy) + iB[2] * cBz
    tBy = (iB[3] * cBx + iB[4] * cBy) + iB[5] * cBz
    tBz = (iB[6] * cBx + iB[7] * cBy) + iB[8] * cBz
    kB = live * (((iBm + cBx * tBx) + cBy * tBy) + cBz * tBz)
    kn = kA + kB
    meff = torch.where((hit > 0.5) & (kn > 1e-12), 1.0 / torch.clamp(kn, min=1e-12), 0.0)

    vAx = v0x + (w0y * rAz - w0z * rAy)
    vAy = v0y + (w0z * rAx - w0x * rAz)
    vAz = v0z + (w0x * rAy - w0y * rAx)
    vBx = live * (vB0x + (wB0y * rBz - wB0z * rBy))
    vBy = live * (vB0y + (wB0z * rBx - wB0x * rBz))
    vBz = live * (vB0z + (wB0x * rBy - wB0y * rBx))
    vn0 = ((vAx - vBx) * nx + (vAy - vBy) * ny) + (vAz - vBz) * nz
    bounce = -restitution * torch.clamp(vn0 + bounce_thr, max=0.0)
    bias = (baumgarte / dt) * torch.clamp(torch.clamp(dep, min=0.0) - slop, min=0.0)
    sleeper = stat * (1.0 - ground)
    bias = bias * (1.0 - sleeper)
    targ = torch.maximum(bounce, bias)

    # Mass splitting: per-row hit count (a sum of 0/1, exact in any order).
    split = 1.0 / torch.clamp(torch.sum(hit, dim=1, keepdim=True), min=1.0)
    return (
        torch.cat([rAx, rAy, rAz], 1), torch.cat([rBx, rBy, rBz], 1), torch.cat([nx, ny, nz], 1),
        torch.cat([meff, targ], 1), torch.cat([hit, stat], 1),
        torch.cat([invm * split, split], 1), torch.cat(II, 1), vn0,
    )


def _kernel(pt3, dh, pn3, btf, own, K, M, G, dt, slop, baumgarte, restitution, bounce_thr):
    global launches
    Np = pt3.shape[0]
    C = K * M + G
    dev = pt3.device
    ins = [t.contiguous() for t in (pt3, dh, pn3, btf, own)]
    widths = (3 * C, 2 * C, 3 * K, 20 * K, 19)
    for t, w in zip(ins, widths):
        if t.dtype != torch.float32 or t.device != dev or t.shape != (Np, w):
            raise ValueError("prep kernel: float32 inputs (Np, 3C), (Np, 2C), (Np, 3K), "
                             "(Np, 20K), (Np, 19) on one device")
    e = lambda w: torch.empty((Np, w), dtype=torch.float32, device=dev)  # noqa: E731
    outs = [e(3 * C), e(3 * C), e(3 * C), e(2 * C), e(2 * C), e(2), e(9), e(C)]
    if Np == 0:
        return tuple(outs)
    fn = _build.bind("surtr_prep", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                     + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    rc = fn(*[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs], Np, K, M, G,
            float(slop), float(baumgarte / dt), float(-restitution), float(bounce_thr),
            _build.stream_ptr(dev))
    _build.check(rc, "surtr_prep")
    launches += 1
    return tuple(outs)


def prep_contacts(pt3, dh, pn3, btf, own, *, K: int, M: int, G: int, dt: float, slop: float,
                  baumgarte: float, restitution: float, bounce_thr: float):
    """The solver's tables from the contact slots: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if pt3.is_cuda:
        return _kernel(pt3, dh, pn3, btf, own, K, M, G, dt, slop, baumgarte, restitution,
                       bounce_thr)
    if pt3.device.type != "cpu":
        raise ValueError(f"prep_contacts: unsupported device {pt3.device}")
    return prep_contacts_reference(pt3, dh, pn3, btf, own, K=K, M=M, G=G, dt=dt, slop=slop,
                                   baumgarte=baumgarte, restitution=restitution,
                                   bounce_thr=bounce_thr)


def warm_preapply(v0, w0, lam0, tables, *, C: int):
    """The matched warm impulse λn·n̂ + λu·û + λv·v̂ applied to the start
    velocities before the accumulated-mode iterations, with the solver's
    own mass-splitting scales and tangent basis (the JAX package's
    ``prep_and_solve`` warm branch). lam0 (Np, C, 3); ``tables`` are B8's
    outputs. Returns (v0, w0, lam0 masked to hit slots). Plain PyTorch on
    both devices, summed in slot order."""
    rA, _, nrm, _, hs, scale, iAI = tables[:7]
    hit = hs[:, :C]
    lam0 = lam0 * (hit > 0.5).to(lam0.dtype)[..., None]
    nx, ny, nz = nrm[:, :C], nrm[:, C : 2 * C], nrm[:, 2 * C :]
    (ux, uy, uz), (vx, vy, vz) = tangent_basis(nx, ny, nz)
    ln, lu, lv = lam0[..., 0], lam0[..., 1], lam0[..., 2]
    ix = (ln * nx + lu * ux) + lv * vx
    iy = (ln * ny + lu * uy) + lv * vy
    iz = (ln * nz + lu * uz) + lv * vz
    rAx, rAy, rAz = rA[:, :C], rA[:, C : 2 * C], rA[:, 2 * C :]
    m_s, s_s = scale[:, 0:1], scale[:, 1:2]
    II = [iAI[:, i : i + 1] for i in range(9)]
    v0 = v0 + m_s * torch.cat([slot_sum(ix), slot_sum(iy), slot_sum(iz)], dim=1)
    tqx = slot_sum(rAy * iz - rAz * iy)
    tqy = slot_sum(rAz * ix - rAx * iz)
    tqz = slot_sum(rAx * iy - rAy * ix)
    w0 = w0 + s_s * torch.cat([(II[0] * tqx + II[1] * tqy) + II[2] * tqz,
                               (II[3] * tqx + II[4] * tqy) + II[5] * tqz,
                               (II[6] * tqx + II[7] * tqy) + II[8] * tqz], dim=1)
    return v0, w0, lam0
