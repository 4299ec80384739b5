"""B8, the contact prep (``csrc/prep.cu``): 95 operations a contact slot,
K·M pair slots and G ground slots a row."""

MODULE = "surtr_tpu_torch.physics.prep_cuda"
ATTR = "_kernel"   # (raw, pidx, g_pts, gd, g_hit, x, v0, w0, inv_m, inv_I, asleep_in, K, M, G, ...)


def ops(args, kwargs) -> float:
    K, M, G = args[11:14]
    return float(args[1].shape[0] * (K * M + G) * 95.0)
