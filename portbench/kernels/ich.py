"""B2, the limited incremental hull (``csrc/ich.cu``): per insertion, every
live point against the current faces (``limit`` insertions of up to
2·max(limit, 4) + 4 faces, 6 operations a test)."""

MODULE = "surtr_tpu_torch.ops.hull_cuda"
ATTR = "_kernel"   # (points (B, N, 3), mask (B, N), limit, F, batched)


def ops(args, kwargs) -> float:
    mask, limit = args[1], int(args[2])
    return float(mask.sum()) * limit * (2 * max(limit, 4) + 4) * 6.0
