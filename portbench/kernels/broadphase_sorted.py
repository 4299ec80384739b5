"""B12, the Morton window sweep (``csrc/broadphase_sorted.cu``, with its
glue): per valid piece, 2·window candidates (test, distance, top-K insert:
25 operations)."""

MODULE = "surtr_tpu_torch.physics.broadphase_cuda"
ATTR = "_sorted_launch"   # (centers, lo, hi, owner, valid, K, window)


def ops(args, kwargs) -> float:
    valid, window = args[4], int(args[6])
    return float(valid.sum()) * 2 * window * 25.0
