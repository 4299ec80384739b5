"""Kernel B5's wide variant (``pack_wide_kernel`` in csrc/pack.cu) mirrored in
numpy on the CPU: each of a warp's 32 lanes folds the corners v = lane (mod
32) into its 13 direction and 3 axis intervals, five xor-shuffle steps
complete the folds, and a lane's NaN bits, OR-ed over the warp, make an
interval NaN. The mirror's ``fminf`` / ``fmaxf`` are the card's: a NaN
operand dropped, -0 below +0 (a probe on an NVIDIA H100 80GB HBM3).

The mirror equals the plain version (``transform_pack_owned_reference``)
bit for bit at Vh 40 and 130 (more corners than lanes, not a multiple of
32), with supports of +0 and -0 tied at an interval's end, an all-masked
hull, a dead piece, a negative owner and an owner past the last body; the
plain version orders the two zeros as the card's folds do (``torch.amin``
alone leaves the tie to its reduction order). On the same finite inputs it
agrees with the JAX package's ``transform_pack_pallas`` in interpret mode
within the tolerance of tests/test_torch_pack.py (1e-6 x the piece's scale;
XLA may contract products into FMAs). A NaN corner makes its piece's
intervals NaN in the plain version and in the mirror; the staged and direct
kernels' serial walk drops it (ROADMAP C17).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.physics.pack_pallas import transform_pack_pallas
from surtr_tpu_torch.ops.kdop import dop26_directions
from surtr_tpu_torch.physics import pack_cuda
from torch_threads import bounded_threads  # noqa: F401 (autouse)

F32 = np.float32
BIG = F32(3.4e38)


def card_fmin(a, b):
    """The card's ``fminf``: a NaN operand dropped, -0 below +0."""
    z = (a == 0) & (b == 0)
    neg = np.signbit(a) | np.signbit(b)
    return np.where(z, np.where(neg, F32(-0.0), F32(0.0)), np.fmin(a, b)).astype(F32)


def card_fmax(a, b):
    """The card's ``fmaxf``: a NaN operand dropped, +0 above -0."""
    z = (a == 0) & (b == 0)
    pos = ~np.signbit(a) | ~np.signbit(b)
    return np.where(z, np.where(pos, F32(0.0), F32(-0.0)), np.fmax(a, b)).astype(F32)


def world_corners(ins):
    """The kernel's world corners, each product and sum rounded in its order."""
    v = ins["piece_verts"].numpy()
    own = np.clip(ins["piece_owner"].numpy(), 0, ins["q"].shape[0] - 1)
    q, x = ins["q"].numpy()[own], ins["x"].numpy()[own]
    qw, qx, qy, qz = (q[:, i : i + 1] for i in range(4))
    xx, yy, zz, xy, xz, yz = qx * qx, qy * qy, qz * qz, qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    one, two = F32(1), F32(2)
    R = ((one - two * (yy + zz), two * (xy - wz), two * (xz + wy)),
         (two * (xy + wz), one - two * (xx + zz), two * (yz - wx)),
         (two * (xz - wy), two * (yz + wx), one - two * (xx + yy)))
    return [((r[0] * v[..., 0] + r[1] * v[..., 1]) + r[2] * v[..., 2]) + x[:, c : c + 1]
            for c, r in enumerate(R)]


def wide_fold(ins, margin):
    """(lod (Np, 13), hid (Np, 13), aabb (Np, 9)) as a warp of the wide
    kernel computes them."""
    px, py, pz = world_corners(ins)
    Np, Vh = px.shape
    d = dop26_directions(torch.float32, "cpu").numpy()
    s = (px[..., None] * d[:, 0] + py[..., None] * d[:, 1]) + pz[..., None] * d[:, 2]
    vals = np.concatenate([s, np.stack([px, py, pz], -1)], -1)          # (Np, Vh, 16)
    m = ins["piece_vmask"].numpy()
    pad = -Vh % 32
    vals = np.pad(vals, ((0, 0), (0, pad), (0, 0)))
    m = np.pad(m, ((0, 0), (0, pad)))
    vals = vals.reshape(Np, -1, 32, 16)                                  # corner v = 32 r + lane
    m = m.reshape(Np, -1, 32)[..., None]
    lo = np.full((Np, 32, 16), BIG, F32)
    hi = np.full((Np, 32, 16), -BIG, F32)
    nan = np.zeros((Np, 32, 16), bool)
    for r in range(vals.shape[1]):                                       # each lane's walk
        v = vals[:, r]
        lo = np.where(m[:, r], card_fmin(lo, v), lo)
        hi = np.where(m[:, r], card_fmax(hi, v), hi)
        nan |= m[:, r] & np.isnan(v)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):                                         # the xor tree
        lo = card_fmin(lo, lo[:, lanes ^ off])
        hi = card_fmax(hi, hi[:, lanes ^ off])
    nan = nan.any(1)                                                     # the OR of the bits
    lo = np.where(nan, F32(np.nan), lo[:, 0])
    hi = np.where(nan, F32(np.nan), hi[:, 0])
    alo, ahi = lo[:, 13:] - F32(margin), hi[:, 13:] + F32(margin)
    pv = ins["piece_valid"].numpy() & (ins["piece_owner"].numpy() >= 0)
    ctr = np.where(pv[:, None], (alo + ahi) * F32(0.5), BIG)
    return lo[:, :13], hi[:, :13], np.concatenate([alo, ahi, ctr], 1)


def serial_walk(ins):
    """lod (Np, 13) as the staged and direct kernels walk it: corner by
    corner with ``fminf``, which drops a NaN support."""
    px, py, pz = world_corners(ins)
    d = dop26_directions(torch.float32, "cpu").numpy()
    s = (px[..., None] * d[:, 0] + py[..., None] * d[:, 1]) + pz[..., None] * d[:, 2]
    m = ins["piece_vmask"].numpy()
    lo = np.full((s.shape[0], 13), BIG, F32)
    for v in range(s.shape[1]):
        lo = np.where(m[:, v, None], card_fmin(lo, s[:, v]), lo)
    return lo


def owned_inputs(Vh, F=26, Ne=3, Np=12, B=5, seed=3, nan=False):
    """Random pieces: owner 3 is -1, owner 4 past the last body, piece 1
    invalid, piece 2 with every corner masked; pieces 0, 5 and 6 on body 0
    at (-0, -0, -0) with the identity pose, each with a corner at (-0, -0,
    -0) and one at (+0, +0, +0) (world corners -0 and +0: supports tied at
    zero) and the other corners on one side of the origin, so that zero
    ends their intervals."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, B, Np).astype(np.int32)
    owner[3], owner[4] = -1, B + 3
    valid = rng.random(Np) > 0.2
    valid[1] = False
    vmask = rng.random((Np, Vh)) > 0.3
    vmask[2] = False
    q = rng.standard_normal((B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = (1, 0, 0, 0)
    x = rng.uniform(-5, 5, (B, 3)).astype(F32)
    x[0] = -0.0
    verts = rng.uniform(-1, 1, (Np, Vh, 3)).astype(F32)
    for i, (a, b, side) in {0: (3, 17, 1), 5: (17, 3, 1), 6: (33, 0, -1)}.items():
        owner[i], valid[i] = 0, True
        vmask[i] = True
        verts[i] = side * (np.abs(verts[i]) + F32(0.1))
        verts[i, a], verts[i, b] = -0.0, 0.0
    if nan:
        verts[7, 5, 1] = np.nan
        vmask[7, 5] = True
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a)).to(dt)  # noqa: E731
    return dict(piece_verts=t(verts), piece_vmask=t(vmask, torch.bool),
                piece_planes=t(rng.uniform(-1, 1, (Np, F, 4))),
                piece_pmask=t(rng.random((Np, F)) > 0.3, torch.bool),
                piece_edges=t(rng.uniform(-1, 1, (Np, Ne, 3))),
                piece_emask=t(rng.random((Np, Ne)) > 0.3, torch.bool),
                piece_owner=t(owner, torch.int32), piece_valid=t(valid, torch.bool), q=t(q),
                x=t(x))


def bits(a):
    return np.ascontiguousarray(a, F32).view(np.int32)


def same_bits(a, b):
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    return a.shape == b.shape and bool(((bits(a) == bits(b)) | (np.isnan(a) & np.isnan(b))).all())


def plain(ins, margin=0.02):
    packed, aabb = pack_cuda.transform_pack_owned_reference(*ins.values(), margin)
    Vh, F, Ne = (ins[k].shape[1] for k in ("piece_verts", "piece_planes", "piece_edges"))
    o = pack_cuda.pack_layout(Vh, F, Ne)[0]["lod"][0]
    return packed[:, o : o + 13].numpy(), packed[:, o + 13 : o + 26].numpy(), aabb.numpy()


@pytest.mark.parametrize("Vh", [40, 130])
def test_wide_fold_equals_the_plain_version(Vh):
    ins = owned_inputs(Vh)
    got, want = wide_fold(ins, 0.02), plain(ins)
    for name, g, w in zip(("lod", "hid", "aabb"), got, want):
        assert same_bits(g, w), name
    lod, hid = want[0], want[1]
    # Zero ends the intervals of pieces 0, 5 and 6 where +0 and -0 tie: the
    # minimum is -0 and the maximum +0 whichever corner comes first.
    for i in (0, 5):
        z = lod[i] == 0
        assert z.any() and np.signbit(lod[i][z]).all()
    z = hid[6] == 0
    assert z.any() and not np.signbit(hid[6][z]).any()
    assert (lod[2] == BIG).all() and (hid[2] == -BIG).all()           # every corner masked
    assert (want[2][2, :3] == BIG - F32(0.02)).all()
    assert (want[2][[1, 3], 6:] == BIG).all()                           # dead pieces' centers
    assert np.isfinite(want[2][0, 6:]).all()


def test_plain_version_orders_tied_zeros():
    """``torch.amin`` / ``amax`` alone leave a tie of -0 and +0 to the
    reduction order (the first on the CPU, one by position on the card):
    in two orders they do not give -0 (+0) both times; ``_amin`` /
    ``_amax`` do."""
    t = torch.as_tensor(np.stack([np.array([1.0, 0.0, -0.0, 2.0], F32),
                                  np.array([1.0, -0.0, 0.0, 2.0], F32)]))
    assert torch.signbit(pack_cuda._amin(t, 1)).all()
    assert not torch.signbit(pack_cuda._amax(-t, 1)).any()
    assert torch.signbit(torch.amin(t, 1)).tolist() != [True, True]
    assert torch.signbit(torch.amax(-t, 1)).tolist() != [False, False]


def test_wide_fold_matches_pallas_interpret(Vh=130):
    """The finite inputs through the JAX package's kernel (per-piece poses:
    the owners gathered, valid where the owner is not negative) against
    the mirror: intervals within 1e-6 x the piece's scale, BIG exactly."""
    ins = owned_inputs(Vh)
    own = torch.clamp(ins["piece_owner"], 0, ins["q"].shape[0] - 1).long()
    pvalid = ins["piece_valid"] & (ins["piece_owner"] >= 0)
    args = [ins[k] for k in ("piece_verts", "piece_vmask", "piece_planes", "piece_pmask",
                             "piece_edges", "piece_emask")]
    args += [ins["q"][own], ins["x"][own], pvalid]
    F, Ne = ins["piece_planes"].shape[1], ins["piece_edges"].shape[1]
    pT, ab = transform_pack_pallas(*[jnp.asarray(a.numpy()) for a in args], Vh=Vh, F=F, Ne=Ne,
                                   margin=0.02, interpret=True)
    o = pack_cuda.pack_layout(Vh, F, Ne)[0]["lod"][0]
    jp, jab = np.asarray(pT).T, np.asarray(ab).T
    lod, hid, aabb = wide_fold(ins, 0.02)
    scale = np.maximum(np.abs(jp[:, : 3 * Vh]).max(1, keepdims=True), 1.0)
    for g, w in ((lod, jp[:, o : o + 13]), (hid, jp[:, o + 13 : o + 26]), (aabb, jab)):
        big = np.abs(w) > 1e30
        np.testing.assert_array_equal(g[big], w[big])
        assert (np.where(big, 0.0, np.abs(g - w)) <= 1e-6 * scale).all()


def test_nan_corner_propagates_in_the_wide_fold_only():
    """A NaN coordinate of a live corner: the plain version's intervals of
    that piece are NaN (the rotation spreads it to every world coordinate:
    every direction and axis), and the mirror's are too; the serial walk of the staged and direct kernels
    keeps the other corners' minimum (ROADMAP C17)."""
    ins = owned_inputs(130, nan=True)
    got, want = wide_fold(ins, 0.02), plain(ins)
    for g, w in zip(got, want):
        assert same_bits(g, w)
    assert np.isnan(want[0][7]).all() and np.isnan(want[2][7, :6]).all()
    walk = serial_walk(ins)
    assert np.isfinite(walk[7]).all()
    keep = np.arange(12) != 7
    assert same_bits(walk[keep], want[0][keep])
