"""Per-phase timing (counterpart of ``surtr_tpu/profiling.py``; the reference's
QPC TIMER macros around each fracture phase).

``PhaseTimer`` times named phases on the host clock, fenced by a
``torch.cuda.synchronize`` of every CUDA device whose tensors the phase left
in its holder (the JAX package fences with ``jax.block_until_ready``).
``trace`` records one call under ``torch.profiler`` and exports a Chrome
trace. ``fence_sum`` is the value a truncated stage (``profile_stage``)
returns.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _tensors(obj):
    """Every tensor in nested dataclasses, dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, name))


def fence_sum(*trees) -> torch.Tensor:
    """The stage fence of a truncated run (``profile_stage``): the sum of
    every element of every tensor in ``trees``, bools and integers as 0/1
    and their values, taken in float64 and rounded once to a float32 0-d
    tensor, so that its value does not depend on the device's reduction
    order (the JAX package's ``_psum``)."""
    parts = [torch.sum(t.double()) for t in _tensors(list(trees))]
    dev = parts[0].device if parts else None
    return sum(parts, torch.zeros((), dtype=torch.float64, device=dev)).to(torch.float32)


def fence(obj) -> None:
    """Wait for the work behind every CUDA tensor in ``obj``: one
    ``torch.cuda.synchronize`` per device they lie on."""
    for dev in {t.device for t in _tensors(obj) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Wall-clock phase timer with device fencing.

    Usage:
        t = PhaseTimer()
        with t.phase("ApplyFracture") as h:
            h["out"] = prepare_fracture(...)
        t.report()
    """

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            fence(list(holder.values()))
            self.times[name].append((time.perf_counter() - t0) * 1e3)

    def medians(self):
        import numpy as np

        return {k: float(np.median(v)) for k, v in self.times.items()}

    def report(self) -> str:
        lines = [
            f"{k:<24s} {sum(v)/len(v):8.3f} ms (n={len(v)})"
            for k, v in self.times.items()
        ]
        return "\n".join(lines)


def trace(fn, *args, path: str = "surtr_trace.json"):
    """Record one call of ``fn(*args)`` under ``torch.profiler`` (CPU and,
    where available, CUDA activities) and export a Chrome trace to ``path``.

    Returns (output, kernel records): the profiler can drop device records
    late in a long process, so the count of CUDA kernel records it kept is
    returned with the output for the caller to check."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn(*args)
        fence(out)
    prof.export_chrome_trace(path)
    kernels = sum(1 for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    return out, kernels
