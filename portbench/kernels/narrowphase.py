"""B7, the narrowphase (``csrc/narrowphase.cu``): per candidate pair the
relative pose, both hulls' face and edge-direction tests and the manifold
(every pair is computed, hit or not)."""

MODULE = "surtr_tpu_torch.physics.narrowphase_cuda"
ATTR = "_kernel"   # (packed, pidx, pok, Vh, F, Ne, M, slop)


def ops(args, kwargs) -> float:
    _, pidx, _, Vh, F, Ne, M = args[:7]
    per_pair = (13 * 7 + 2 * F * Vh * 8 + Ne * Ne * (28 + Vh * 14) + Vh * 14
                + M * (2 * Vh + 12) + 30)
    return float(pidx.numel() * per_pair)
