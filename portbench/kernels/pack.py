"""B5, the transform and pack (``csrc/pack.cu``): per piece its pose, its
Vh corners transformed and folded into the 26-DOP, its F planes and Ne
edges."""

MODULE = "surtr_tpu_torch.physics.pack_cuda"
ATTR = "_kernel"   # (piece_verts (Np, Vh, 3), vmask, planes (Np, F, 4), pmask, edges (Np, Ne, 3), ...)


def ops(args, kwargs) -> float:
    Np, Vh = args[0].shape[:2]
    F, Ne = args[2].shape[1], args[4].shape[1]
    return float(Np * (45 + Vh * (24 + 13 * 7) + F * 21 + Ne * 15))
