"""Contact-solver iteration with device dispatch (kernel B9,
``csrc/solver.cu``; replaces ``surtr_tpu/physics/solver_pallas.py``
``_solver_iter_kernel`` via ``solve_packed``).

One outer Jacobi iteration, single-piece bodies (row i is body i): partner
velocities are read once from the previous iteration's state (chaotic
relaxation: own state updates every substep, partners once per outer
iteration); each of S substeps applies projected normal impulses toward the
prep target and Coulomb friction (μ) on every hit slot, sums them in slot
order and updates the row's v and w with the mass-splitting scales; finally
the island-wake flag spreads one hop over live hit contacts.

State ``vw`` (Np, 8) = [v(3) | w(3) | wake | 0]. The tables are B8's
outputs (``prep_cuda``). ``solve`` runs ceil(iters / substeps) iterations;
on CUDA tensors all of them are one cooperative kernel launch whose
iterations meet at a grid-wide barrier, each reading one state buffer and
writing the other, so no row sees a partner's update of the same
iteration; the tables and the partner index are checked and converted once
a solve. ``solve_warm`` is the accumulated-impulse mode of warm start: the
per-slot totals (Np, 3C) = [λn | λu | λv] ride along, ping-ponged like the
state. ``_variant`` picks the kernel from (K, C): the register kernel (16
lanes a row) up to K = 16 and C = 128, the shared one (a warp a row, its
tables, partner states and slot sums in shared memory) past it wherever a
row fits a block, the general one (a device scratch) only past that.
"""

from __future__ import annotations

import ctypes

import torch

from plainref import _build
from plainref.ops.linalg import sqrt_rn
from plainref.physics.slots import expand_slots, slot_sum, tangent_basis

launches = 0           # kernel launches since the last reset (main-path proof)
warm_launches = 0      # launches of the accumulated (warm-start) mode
general_launches = 0   # launches past the register kernel's shapes (K > 16 or C > 128), either mode
fallback_launches = 0  # of which the "general" variant's (rows past a block's shared memory)


def solver_iteration_reference(vw, pb, rA, rB, nrm, mt, hs, scale, iAI, *, K: int, M: int,
                               G: int, substeps: int, mu: float):
    """Plain version of one outer iteration: (Np, 8) state → (Np, 8)."""
    C = K * M + G
    split3 = lambda t: (t[:, :C], t[:, C : 2 * C], t[:, 2 * C :])  # noqa: E731
    rAx, rAy, rAz = split3(rA)
    rBx, rBy, rBz = split3(rB)
    nx, ny, nz = split3(nrm)
    meff, targ = mt[:, :C], mt[:, C:]
    hit, stat = hs[:, :C], hs[:, C:]
    pv = vw[pb.long()]                                   # (Np, K, 8)
    pvx, pvy, pvz, pwx, pwy, pwz, pwake = (expand_slots(pv[:, :, i], M, G) for i in range(7))
    live = 1.0 - stat
    vBx = live * (pvx + (pwy * rBz - pwz * rBy))
    vBy = live * (pvy + (pwz * rBx - pwx * rBz))
    vBz = live * (pvz + (pwx * rBy - pwy * rBx))
    m_s, s_s = scale[:, 0:1], scale[:, 1:2]
    II = [iAI[:, i : i + 1] for i in range(9)]
    v = [vw[:, i : i + 1] for i in range(3)]
    w = [vw[:, 3 + i : 4 + i] for i in range(3)]
    for _ in range(max(1, substeps)):
        vrx = (v[0] + (w[1] * rAz - w[2] * rAy)) - vBx
        vry = (v[1] + (w[2] * rAx - w[0] * rAz)) - vBy
        vrz = (v[2] + (w[0] * rAy - w[1] * rAx)) - vBz
        vn = (vrx * nx + vry * ny) + vrz * nz
        vtx = vrx - vn * nx
        vty = vry - vn * ny
        vtz = vrz - vn * nz
        vt_len = sqrt_rn((vtx * vtx + vty * vty) + vtz * vtz)
        inv_vt = 1.0 / torch.clamp(vt_len, min=1e-9)
        lam_n = torch.clamp(-(vn - targ) * meff, min=0.0)
        lam_t = torch.minimum(vt_len * meff, mu * lam_n)
        ix = hit * (lam_n * nx - lam_t * vtx * inv_vt)
        iy = hit * (lam_n * ny - lam_t * vty * inv_vt)
        iz = hit * (lam_n * nz - lam_t * vtz * inv_vt)
        sx, sy, sz = slot_sum(ix), slot_sum(iy), slot_sum(iz)
        tqx = slot_sum(rAy * iz - rAz * iy)
        tqy = slot_sum(rAz * ix - rAx * iz)
        tqz = slot_sum(rAx * iy - rAy * ix)
        dwx = s_s * ((II[0] * tqx + II[1] * tqy) + II[2] * tqz)
        dwy = s_s * ((II[3] * tqx + II[4] * tqy) + II[5] * tqz)
        dwz = s_s * ((II[6] * tqx + II[7] * tqy) + II[8] * tqz)
        v = [v[0] + m_s * sx, v[1] + m_s * sy, v[2] + m_s * sz]
        w = [w[0] + dwx, w[1] + dwy, w[2] + dwz]
    wake = torch.maximum(vw[:, 6:7], torch.amax(hit * live * pwake, dim=1, keepdim=True))
    return torch.cat(v + w + [wake, torch.zeros_like(wake)], dim=1)


def solver_iteration_warm_reference(vw, lam, pb, rA, rB, nrm, mt, hs, scale, iAI, *, K: int,
                                    M: int, G: int, substeps: int, mu: float):
    """Plain version of one outer iteration in the accumulated-impulse mode
    (warm start): ``lam`` (Np, 3C) = [λn | λu | λv] totals per slot; the
    normal clamp acts on λn, friction on (λu, λv) in the tangent basis,
    rescaled into the cone μ·λn. Returns ((Np, 8) state, (Np, 3C) lam)."""
    C = K * M + G
    split3 = lambda t: (t[:, :C], t[:, C : 2 * C], t[:, 2 * C :])  # noqa: E731
    rAx, rAy, rAz = split3(rA)
    rBx, rBy, rBz = split3(rB)
    nx, ny, nz = split3(nrm)
    meff, targ = mt[:, :C], mt[:, C:]
    hit, stat = hs[:, :C], hs[:, C:]
    acc_n, acc_u, acc_v = split3(lam)
    (ux, uy, uz), (wx, wy, wz) = tangent_basis(nx, ny, nz)
    pv = vw[pb.long()]                                   # (Np, K, 8)
    pvx, pvy, pvz, pwx, pwy, pwz, pwake = (expand_slots(pv[:, :, i], M, G) for i in range(7))
    live = 1.0 - stat
    vBx = live * (pvx + (pwy * rBz - pwz * rBy))
    vBy = live * (pvy + (pwz * rBx - pwx * rBz))
    vBz = live * (pvz + (pwx * rBy - pwy * rBx))
    m_s, s_s = scale[:, 0:1], scale[:, 1:2]
    II = [iAI[:, i : i + 1] for i in range(9)]
    v = [vw[:, i : i + 1] for i in range(3)]
    w = [vw[:, 3 + i : 4 + i] for i in range(3)]
    for _ in range(max(1, substeps)):
        vrx = (v[0] + (w[1] * rAz - w[2] * rAy)) - vBx
        vry = (v[1] + (w[2] * rAx - w[0] * rAz)) - vBy
        vrz = (v[2] + (w[0] * rAy - w[1] * rAx)) - vBz
        vn = (vrx * nx + vry * ny) + vrz * nz
        dlam = -(vn - targ) * meff
        lam_new = torch.clamp(acc_n + dlam, min=0.0) * hit
        lam_n = lam_new - acc_n
        vtu = (vrx * ux + vry * uy) + vrz * uz
        vtv = (vrx * wx + vry * wy) + vrz * wz
        lu = (acc_u - vtu * meff) * hit
        lv = (acc_v - vtv * meff) * hit
        tl = sqrt_rn(lu * lu + lv * lv)
        cone = mu * lam_new
        scl = torch.where(tl > cone, cone / torch.clamp(tl, min=1e-12), 1.0)
        lu, lv = lu * scl, lv * scl
        imp_u, imp_v = lu - acc_u, lv - acc_v
        acc_n, acc_u, acc_v = lam_new, lu, lv
        ix = hit * ((lam_n * nx + imp_u * ux) + imp_v * wx)
        iy = hit * ((lam_n * ny + imp_u * uy) + imp_v * wy)
        iz = hit * ((lam_n * nz + imp_u * uz) + imp_v * wz)
        sx, sy, sz = slot_sum(ix), slot_sum(iy), slot_sum(iz)
        tqx = slot_sum(rAy * iz - rAz * iy)
        tqy = slot_sum(rAz * ix - rAx * iz)
        tqz = slot_sum(rAx * iy - rAy * ix)
        dwx = s_s * ((II[0] * tqx + II[1] * tqy) + II[2] * tqz)
        dwy = s_s * ((II[3] * tqx + II[4] * tqy) + II[5] * tqz)
        dwz = s_s * ((II[6] * tqx + II[7] * tqy) + II[8] * tqz)
        v = [v[0] + m_s * sx, v[1] + m_s * sy, v[2] + m_s * sz]
        w = [w[0] + dwx, w[1] + dwy, w[2] + dwz]
    wake = torch.maximum(vw[:, 6:7], torch.amax(hit * live * pwake, dim=1, keepdim=True))
    return (torch.cat(v + w + [wake, torch.zeros_like(wake)], dim=1),
            torch.cat([acc_n, acc_u, acc_v], dim=1))


# The register variant keeps a row's slots in registers, up to 8 on each of
# 16 lanes, and gathers its K <= 16 partner states on lanes 0..K-1.
MAX_SLOTS = 128
MAX_K = 16
MAX_SMEM = 232448       # bytes of shared memory a Hopper block can use
VARIANTS = ("registers", "shared", "general")
GENERAL_BLOCKS = 2048   # CTAs of the general variant at most (its scratch: 8 · 9C floats each)


def _cover(n: int) -> int:
    """Floats of the 16-byte aligned cover of n floats starting anywhere."""
    return (n + 6) // 4 * 4


def shared_bytes(K: int, C: int, warm: bool) -> int:
    """Bytes of one row's shared state in the shared variant (a warp a row,
    ``shared_row_floats`` in csrc/solver.cu): the five B8 tables' aligned
    covers (rA, rB, n: 3C; mt, hs: 2C), scale and I⁻¹ (12), vB (3C), the K
    partner states (7 floats each) and indices, each rounded up to 4, the
    six staged components at a stride of C rounded up to an odd number of
    quads, and in warm mode the totals' cover (3C)."""
    r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    stride = (((C + 3) // 4) | 1) * 4
    floats = (3 * _cover(3 * C) + 2 * _cover(2 * C) + 12 + r4(3 * C) + r4(7 * K) + r4(K)
              + 6 * stride + (_cover(3 * C) if warm else 0))
    return 4 * floats


def _variant(K: int, C: int) -> str:
    """"registers" (today's kernel) for 1 <= K <= 16 and C = K·M + G <= 128;
    else "shared" (a warp a row, its tables, partner states and sums in
    shared memory) where a row's warm-mode state fits a block's shared
    memory; else "general" (slots re-read from device memory, totals and
    staged sums in a scratch): every shape the plain version takes has a
    variant."""
    if 1 <= K <= MAX_K and C <= MAX_SLOTS:
        return "registers"
    return "shared" if K >= 1 and shared_bytes(K, C, True) <= MAX_SMEM else "general"


def _solve_kernel(vw0, lam0, pb, tables, K, M, G, iters, substeps, mu):
    """All outer iterations in one launch (warm mode when ``lam0`` is
    given): the tables, the state and ``pb`` are checked and converted once
    a solve. Returns the final state (and totals)."""
    global launches, warm_launches, general_launches, fallback_launches
    warm = lam0 is not None
    Np = vw0.shape[0]
    C = K * M + G
    dev = vw0.device
    S = max(1, substeps)
    outer = (iters + S - 1) // S
    variant = _variant(K, C)
    general = variant == "general"
    widths = (3 * C, 3 * C, 3 * C, 2 * C, 2 * C, 2, 9)
    tabs = [t.contiguous() for t in tables]
    for t, wd in zip(tabs, widths):
        if t.dtype != torch.float32 or t.device != dev or t.shape != (Np, wd):
            raise ValueError("solver kernel: tables must be B8's float32 outputs on one device")
    v_in = vw0.contiguous()
    if v_in.dtype != torch.float32 or v_in.shape != (Np, 8):
        raise ValueError("solver kernel: state must be (Np, 8) float32")
    pbi = pb.to(torch.int32).contiguous()
    if pbi.shape != (Np, K) or pbi.device != dev:
        raise ValueError("solver kernel: partner index must be (Np, K) on the state's device")
    l_in = lbuf = None
    if warm:
        l_in = lam0.contiguous()
        if l_in.dtype != torch.float32 or l_in.shape != (Np, 3 * C) or l_in.device != dev:
            raise ValueError("solver kernel: accumulators must be (Np, 3C) float32")
    if Np == 0 or outer == 0:
        return (v_in, l_in) if warm else v_in
    buf = torch.empty((2, Np, 8), dtype=torch.float32, device=dev)
    if warm:
        lbuf = torch.empty((2, Np, 3 * C), dtype=torch.float32, device=dev)
    scratch, blocks = None, 0
    if general:
        blocks = min(-(-Np // 8), GENERAL_BLOCKS)
        scratch = torch.empty((blocks * 8 * 9 * C,), dtype=torch.float32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    ptrs = (v_in.data_ptr(), pbi.data_ptr(), *[t.data_ptr() for t in tabs],
            l_in.data_ptr() if warm else None, buf.data_ptr(),
            lbuf.data_ptr() if warm else None, Np, K, M, G, S, outer, float(mu))
    if variant == "shared":
        name = "surtr_solver_solve_shared"
        fn = _build.bind(name, [P] * 12 + [I] * 6 + [ctypes.c_float, P])
        rc = fn(*ptrs, _build.stream_ptr(dev))
    else:
        name = "surtr_solver_solve"
        fn = _build.bind(name, [P] * 12 + [I] * 6 + [ctypes.c_float, P, I, P])
        rc = fn(*ptrs, None if scratch is None else scratch.data_ptr(), blocks,
                _build.stream_ptr(dev))
    _build.check(rc, name)
    general_launches += variant != "registers"
    fallback_launches += general
    last = (outer - 1) % 2
    if warm:
        warm_launches += 1
        return buf[last], lbuf[last]
    launches += 1
    return buf[last]


def solve_reference(vw0, pb, tables, *, K: int, M: int, G: int, iters: int, substeps: int,
                    mu: float):
    """Plain version of ``solve`` (every iteration plain, on any device)."""
    S = max(1, substeps)
    vw = vw0
    for _ in range((iters + S - 1) // S):
        vw = solver_iteration_reference(vw, pb, *tables, K=K, M=M, G=G, substeps=S, mu=mu)
    return vw


def solve(vw0, pb, tables, *, K: int, M: int, G: int, iters: int, substeps: int, mu: float):
    """ceil(iters / substeps) outer iterations from state ``vw0``; ``tables``
    = (rA, rB, n, mt, hs, scale, iAI) from B8. Returns the final (Np, 8):
    one kernel launch for CUDA tensors, the plain version for CPU tensors."""
    if vw0.is_cuda:
        return _solve_kernel(vw0, None, pb, tables, K, M, G, iters, substeps, mu)
    if vw0.device.type != "cpu":
        raise ValueError(f"solve: unsupported device {vw0.device}")
    return solve_reference(vw0, pb, tables, K=K, M=M, G=G, iters=iters, substeps=substeps,
                           mu=mu)


def solve_warm_reference(vw0, lam0, pb, tables, *, K: int, M: int, G: int, iters: int,
                         substeps: int, mu: float):
    """Plain version of ``solve_warm`` (every iteration plain, on any device)."""
    S = max(1, substeps)
    vw, lam = vw0, lam0
    for _ in range((iters + S - 1) // S):
        vw, lam = solver_iteration_warm_reference(vw, lam, pb, *tables, K=K, M=M, G=G,
                                                  substeps=S, mu=mu)
    return vw, lam


def solve_warm(vw0, lam0, pb, tables, *, K: int, M: int, G: int, iters: int, substeps: int,
               mu: float):
    """``solve`` in the accumulated mode from accumulators ``lam0`` (Np, 3C)
    = [λn | λu | λv]. Returns ((Np, 8) state, (Np, 3C) accumulators): one
    kernel launch for CUDA tensors, the plain version for CPU tensors."""
    if vw0.is_cuda:
        return _solve_kernel(vw0, lam0, pb, tables, K, M, G, iters, substeps, mu)
    if vw0.device.type != "cpu":
        raise ValueError(f"solve_warm: unsupported device {vw0.device}")
    return solve_warm_reference(vw0, lam0, pb, tables, K=K, M=M, G=G, iters=iters,
                                substeps=substeps, mu=mu)
