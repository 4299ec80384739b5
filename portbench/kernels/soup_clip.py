"""B10, the pooled soup clip (``csrc/soup_clip.cu``): per valid lane with a
cell, the context test of its three corners against each live plane of its
cell (18 operations). The fold's own steps depend on where each polygon
empties and are left out, so this bound is low."""

MODULE = "surtr_tpu_torch.ops.soup_clip_cuda"
ATTR = "_kernel"   # (tri_corners, valid, cell_id, cell_planes, cell_pmask, S, tol)


def ops(args, kwargs) -> float:
    _, valid, cell, planes, pmask = args[:5]
    C = planes.shape[0]
    inside = (cell >= 0) & (cell < C)
    live = pmask[cell.long().clamp(0, max(C - 1, 0))].sum(1) * (valid & inside)
    return float(live.sum()) * 18 if C else 0.0
