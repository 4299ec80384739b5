"""B6, the exact sweep (``csrc/broadphase_exact.cu``, with its key and pack
glue): bytes only; the overlap tests its inputs need are not counted, so
this bound is low."""

MODULE = "surtr_tpu_torch.physics.broadphase_cuda"
ATTR = "_exact_kernel"   # (centers, lo, hi, owner, valid, K)


def ops(args, kwargs) -> float:
    return 0.0
