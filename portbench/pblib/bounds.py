"""The bound arithmetic, frozen from ``chip_smoke.py`` (its ``nbytes`` and
``bound``, and the data-sheet peaks beside them): the least time the card
could take over a kernel call is the larger of the bytes it must move (each
input byte read once, each output byte written once) at the memory rate and
the float operations its inputs need at the FP32 rate."""

from __future__ import annotations

import dataclasses
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM FP32 outside the tensor cores (NVIDIA data sheet)


def nbytes(obj) -> int:
    """Bytes of every tensor in ``obj`` (tuples, lists, dicts, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(nbytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(nbytes(o) for o in obj.values())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Seconds: the larger of the bytes at the memory rate and the
    operations at the FP32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, which
    every reading of a peak's share stands beside."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    out = smi.stdout.strip()
    return out.splitlines()[0] if smi.returncode == 0 and out else "unknown"
