"""B4, the refit planes (``csrc/refit.cu``), on the pool's parts: every
live point (three corners a valid triangle, each valid cap vertex) through
4 extreme-point passes and 4 slab passes, 8 operations each."""

MODULE = "surtr_tpu_torch.ops.refit_cuda"
ATTR = "_parts_kernel"   # (tris (N, T, 3, 3), tri_mask (N, T), caps (N, C, 3), cap_mask (N, C))


def ops(args, kwargs) -> float:
    _, tri_mask, _, cap_mask = args[:4]
    return (3.0 * float(tri_mask.sum()) + float(cap_mask.sum())) * 8 * 8.0
