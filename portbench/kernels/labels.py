"""B3, the island labels (``csrc/labels.cu``): what any labelling needs,
whichever variant runs: per soup 18 operations a triangle slot (its corner
keys) and 36 a valid triangle (hash, compare, first union)."""

MODULE = "surtr_tpu_torch.ops.labels_cuda"
ATTR = "_kernel"   # (corners (N, T, 3, 3), tri_valid (N, T), tol, iters)


def ops(args, kwargs) -> float:
    corners, valid = args[:2]
    N, T = corners.shape[:2]
    return 18.0 * N * T + 36.0 * float(valid.sum())
