"""Kernel B5's plain version (``pack_cuda.transform_pack_reference``, the CPU
side of ``csrc/pack.cu``) against the JAX package's
``transform_pack_pallas`` in interpret mode, on a randomly rotated and
translated 27-cube lattice with a dead piece.

Tolerances: the mask columns exactly (copies of the scene's masks); every
other value within 1e-6 × the piece's scale, its largest world coordinate
and at least 1 (XLA may contract the rotation's products into FMAs, one
rounding fewer than the port's mul-then-add); BIG sentinels exactly.

B5's entry ``transform_pack_owned`` (the owner gather and valid mask
inside) equals, bit for bit, the per-piece-pose plain version at the poses
the step's former glue gathered, on compound ownership with -1 owners, an
owner past the last body, invalid pieces and a piece with no valid corner.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.config import PhysicsConfig as JPhysicsConfig
from surtr_tpu.fracture.types import PieceSet as JPieceSet
from surtr_tpu.physics.pack_pallas import transform_pack_pallas
from surtr_tpu.physics.rigid import quat_normalize as j_quat_normalize
from surtr_tpu.physics.scene import build_scene as j_build_scene
from surtr_tpu.types import ConvexPoly as JConvexPoly
from surtr_tpu_torch import workload
from surtr_tpu_torch.physics import pack_cuda
from surtr_tpu_torch.physics.pack_cuda import pack_layout
from torch_threads import bounded_threads  # noqa: F401 (autouse)


def j_cube_pieces(offsets):
    """The JAX package's PieceSet of ``workload.cube_pieces(offsets)``."""
    tp = workload.cube_pieces(offsets)
    return JPieceSet(
        convex=JConvexPoly(*(jnp.asarray(getattr(tp.convex, f).numpy())
                             for f in ("face_verts", "n_verts", "planes"))),
        **{f: jnp.asarray(getattr(tp, f).numpy())
           for f in ("mesh", "mesh_valid", "valid", "group", "tag")})


def _lattice_inputs():
    """(numpy inputs of the pack, margin) for 27 rotated, translated cubes."""
    rng = np.random.default_rng(21)
    n = 27
    jp = j_cube_pieces(workload.lattice_offsets(n))
    cfg = JPhysicsConfig(single_piece_bodies=True, max_hull_verts=8)
    sc = j_build_scene(jp, cfg, max_bodies=n)
    q = np.asarray(j_quat_normalize(jnp.asarray(rng.standard_normal((n, 4)).astype(np.float32))))
    x = np.asarray(sc.bodies.x) + rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    pvalid = np.ones(n, bool)
    pvalid[5] = False
    vmask = np.asarray(sc.piece_vmask).copy()
    vmask[7, 3:] = False              # a piece with part of its pool masked
    ins = dict(
        piece_verts=np.asarray(sc.piece_verts), piece_vmask=vmask,
        piece_planes=np.asarray(sc.piece_planes), piece_pmask=np.asarray(sc.piece_pmask),
        piece_edges=np.asarray(sc.piece_edges), piece_emask=np.asarray(sc.piece_emask),
        q_own=q, x_own=x, pvalid=pvalid,
    )
    return ins, cfg.contact_slop * 4.0


@pytest.fixture(scope="module")
def packs():
    ins, margin = _lattice_inputs()
    Vh, F, Ne = ins["piece_verts"].shape[1], ins["piece_planes"].shape[1], ins["piece_edges"].shape[1]
    pT, ab = transform_pack_pallas(*[jnp.asarray(v) for v in ins.values()], Vh=Vh, F=F, Ne=Ne,
                                   margin=margin, interpret=True)
    got = pack_cuda.transform_pack_reference(*[torch.as_tensor(np.array(v)) for v in ins.values()],
                                             margin)
    return ins, (Vh, F, Ne), got, (np.asarray(pT).T, np.asarray(ab).T)


def test_pack_masks_exact(packs):
    ins, (Vh, F, Ne), got, want = packs
    offs, D = pack_layout(Vh, F, Ne)
    assert got[0].shape == (27, D) == want[0].shape
    for name in ("wm", "pm", "em"):
        o, n = offs[name]
        np.testing.assert_array_equal(got[0][:, o : o + n].numpy(), want[0][:, o : o + n], err_msg=name)


@pytest.mark.parametrize("table", ["packed", "aabb"])
def test_pack_values_match(packs, table):
    ins, (Vh, F, Ne), got, want = packs
    i = 0 if table == "packed" else 1
    g, w = got[i].numpy(), want[i]
    big = np.abs(w) > 1e30
    np.testing.assert_array_equal(g[big], w[big])          # BIG sentinels
    scale = np.maximum(np.abs(want[0][:, : 3 * Vh]).max(1, keepdims=True), 1.0)
    err = np.where(big, 0.0, np.abs(g - w))
    assert (err <= 1e-6 * scale).all(), float((err / scale).max())


def test_dead_piece_center_is_big(packs):
    _, _, got, _ = packs
    assert (got[1][5, 6:9] == torch.tensor(3.4e38, dtype=torch.float32)).all()
    assert torch.isfinite(got[1][:5, 6:9]).all()


def _bits_equal(a, b):
    """Bit for bit, NaN against NaN."""
    return a.shape == b.shape and bool(
        ((a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))).all())


def _owned_inputs(Vh=8, F=8, Ne=3, Np=40, B=12):
    """Random pieces of compound bodies: owners shared, some -1, one past
    the last body; invalid pieces; a piece with every corner masked."""
    rng = np.random.default_rng(23)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    owner = rng.integers(0, B, Np).astype(np.int32)
    owner[::7] = -1
    owner[5] = B + 2
    valid = rng.random(Np) > 0.2
    vmask = rng.random((Np, Vh)) > 0.3
    vmask[9] = False
    q = rng.standard_normal((B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        piece_verts=f(rng.uniform(-1, 1, (Np, Vh, 3))), piece_vmask=torch.as_tensor(vmask),
        piece_planes=f(rng.uniform(-1, 1, (Np, F, 4))),
        piece_pmask=torch.as_tensor(rng.random((Np, F)) > 0.3),
        piece_edges=f(rng.uniform(-1, 1, (Np, Ne, 3))),
        piece_emask=torch.as_tensor(rng.random((Np, Ne)) > 0.3),
        piece_owner=torch.as_tensor(owner), piece_valid=torch.as_tensor(valid),
        q=f(q), x=f(rng.uniform(-5, 5, (B, 3))),
    )


@pytest.mark.parametrize("Vh,F,Ne", [(8, 8, 3), (64, 32, 0)])
def test_owned_pack_equals_pack_at_gathered_poses(Vh, F, Ne):
    """The step's entry (owner gather inside) against the per-piece-pose
    call with the old step glue's gathers, bit for bit, on the CPU."""
    ins = _owned_inputs(Vh, F, Ne)
    margin = 0.02
    before = pack_cuda.launches
    got = pack_cuda.transform_pack_owned(*ins.values(), margin)
    assert pack_cuda.launches == before      # CPU tensors: the plain version, no launch
    owner, valid, q, x = ins["piece_owner"], ins["piece_valid"], ins["q"], ins["x"]
    own = torch.clamp(owner, 0, q.shape[0] - 1).long()
    pvalid = valid & (owner >= 0)
    args = [ins[k] for k in ("piece_verts", "piece_vmask", "piece_planes", "piece_pmask",
                             "piece_edges", "piece_emask")]
    want = pack_cuda.transform_pack_reference(*args, q[own], x[own], pvalid, margin)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    assert (got[1][:, 6][~pvalid] == torch.tensor(3.4e38)).all()     # dead pieces' centers
    assert (got[1][:, 6][pvalid] < 1e30).all()
