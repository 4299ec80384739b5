"""B9, the contact solver (``csrc/solver.cu``): per row, per outer
iteration, each substep's pass over its C contact slots (75 operations a
slot, 120 in the accumulated mode) and the slots' set-up."""

MODULE = "surtr_tpu_torch.physics.solver_cuda"
ATTR = "_solve_kernel"   # (vw0, lam0, pb, tables, K, M, G, iters, substeps, mu)


def ops(args, kwargs) -> float:
    vw0, lam0, _, _, K, M, G, iters, substeps = args[:9]
    C = K * M + G
    S = max(1, substeps)
    outer = (iters + S - 1) // S
    per_slot = 75.0 if lam0 is None else 120.0
    return float(outer * vw0.shape[0] * (S * C * per_slot + C * 3))
