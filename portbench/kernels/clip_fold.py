"""B1, the plane fold (``csrc/clip_fold.cu``): every live cut plane of a
polytope against each of its live face-loop vertices (side test, cut point,
emission: 6 operations)."""

MODULE = "surtr_tpu_torch.ops.clip_cuda"
ATTR = "_kernel"   # (poly, planes, plane_mask, tol)


def ops(args, kwargs) -> float:
    poly, _, plane_mask = args[:3]
    verts = poly.n_verts.clamp_min(0).sum(-1).double()
    return float((plane_mask.sum(-1).double() * verts).sum()) * 6
