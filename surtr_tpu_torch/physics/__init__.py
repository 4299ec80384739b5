"""Rigid-body dynamics (counterpart of ``surtr_tpu/physics``): scene
construction and the single-piece fast path of the step, with kernels B5
(pack), B7 (narrowphase), B8 (contact prep) and B9 (solver iteration)."""
