"""Per-phase timing and the program's spans (counterpart of
``surtr_tpu/profiling.py``; the reference's QPC TIMER macros around each
fracture phase).

``PhaseTimer`` times named phases on the host clock, fenced by a
``torch.cuda.synchronize`` of every CUDA device whose tensors the phase left
in its holder (the JAX package fences with ``jax.block_until_ready``).
``trace`` records one call under ``torch.profiler`` and exports a Chrome
trace. ``fence_sum`` is the value a truncated stage (``profile_stage``)
returns.

``span(name)`` marks a stage of the program. It is on exactly while
torch.profiler is recording, and costs one boolean test otherwise. When
on, it opens the profiler range ``surtr.<name>`` (so the trace's idle gaps
and device operations fall under the program's stages) and keeps a record:
its host interval (``time.perf_counter_ns``), a CUDA event pair on the
current stream, read on demand for its device milliseconds (the host's
where CUDA is not initialised), and the host-device synchronisations made
while it is the innermost open span (``torch.cuda.set_sync_debug_mode``
"warn" for the outermost span's extent, its warnings counted). A span
opened with none open is a call; an ``inner`` span (a kernel
launcher's) is kept only inside an open call and never opens one. ``calls()`` returns
the last ``RING`` calls, each the list of its spans in the order they
opened.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import types
import warnings
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 64          # calls kept by the span record
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class SpanRecord:
    """One closed span: ``parent`` is the index of the enclosing span in the
    same call (-1 for the call's own); ``syncs`` counts the synchronisations
    made while this span was the innermost open one."""

    name: str
    parent: int
    t0_ns: int
    t1_ns: int = 0
    syncs: int = 0
    events: tuple | None = None   # (start, end) torch.cuda.Event, or None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    @property
    def device_ms(self) -> float:
        """Milliseconds between the span's two events on the device's clock
        (waits for the end event); the host's where no event was taken."""
        if self.events is None:
            return self.host_ms
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


_RING = deque(maxlen=RING)    # finished calls, oldest first
# The open call (spans run on the program's one host thread): the indices of
# its open spans, outermost first, its spans in the order they opened, its _Call.
_OPEN = types.SimpleNamespace(stack=[], spans=[], call=None)


class _Call:
    """What the outermost span of a call holds while it is open: the sync
    debug mode to restore and the warnings caught since it opened."""

    def __init__(self):
        self.cuda = torch.cuda.is_initialized()
        self.catcher = warnings.catch_warnings(record=True)
        self.log = self.catcher.__enter__()
        warnings.simplefilter("always")
        self.seen = 0
        self.mode = None
        if self.cuda:
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def syncs(self) -> int:
        """Synchronisations warned of since the last call of this."""
        new = self.log[self.seen:]
        self.seen = len(self.log)
        return sum(1 for w in new if SYNC_WARNING in str(w.message))

    def close(self):
        if self.cuda:
            torch.cuda.set_sync_debug_mode(self.mode)
        self.catcher.__exit__(None, None, None)
        for w in self.log:   # every other warning goes on to the caller's filters
            if SYNC_WARNING not in str(w.message):
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno,
                                       source=w.source)


class _Span:
    """A recording span (``span`` while the profiler records)."""

    __slots__ = ("name", "rec", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function("surtr." + self.name)
        self.range.__enter__()
        st = _OPEN
        if not st.stack:
            st.spans, st.call = [], _Call()
        else:
            st.spans[st.stack[-1]].syncs += st.call.syncs()
        rec = SpanRecord(self.name, st.stack[-1] if st.stack else -1, 0)
        st.stack.append(len(st.spans))
        st.spans.append(rec)
        self.rec = rec
        if st.call.cuda:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        rec.t0_ns = time.perf_counter_ns()

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        self.range.__exit__(*exc)
        st = _OPEN
        rec.syncs += st.call.syncs()
        st.stack.pop()
        if not st.stack:
            call, st.call = st.call, None
            call.close()
            _RING.append(st.spans)
            st.spans = []
        return False


_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether torch.profiler is recording now."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, inner: bool = False):
    """A stage of the program (module docstring): a shared no-op unless
    torch.profiler is recording. An ``inner`` span is kept only inside an
    open call and never opens one of its own."""
    if not recording() or (inner and not _OPEN.stack):
        return _OFF
    return _Span(name)


def spanned(name: str, inner: bool = False):
    """Decorator: each call of the function inside ``span(name, inner)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, inner):
                return fn(*args, **kwargs)
        return call
    return wrap


def calls() -> list:
    """The last ``RING`` calls recorded, oldest first, each a list of
    ``SpanRecord`` with the call's own span first; not cleared."""
    return list(_RING)


def clear_calls() -> None:
    """Empty the record of calls."""
    _RING.clear()


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
