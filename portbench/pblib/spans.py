"""The program's own spans (``surtr_tpu_torch.profiling.span``), read after a
traced run: the ``prepare`` calls recorded while torch.profiler ran, each a
list of span records (name, parent index, host interval, device ms, syncs).

The window matches ``tracing.read_trace``'s: the calls after the first,
unless there is only one. A reading is None unless that window holds as
many calls as the trace's events (a program that keeps no spans, or missed
some, reads nothing rather than a wrong mean)."""

from __future__ import annotations

import sys

PROGRAM = "surtr_tpu_torch.profiling"
TOP = "prepare"
KERNEL = "kernel."


def window(rec):
    """The recorded ``prepare`` calls of the profiled window, or None."""
    calls = getattr(sys.modules.get(PROGRAM), "calls", None)
    p = rec.profile
    if calls is None or not p or not p.get("events"):
        return None
    top = [c for c in calls() if c[0].name == TOP]
    top = top[1:] if len(top) > 1 else top
    return top if len(top) == p["events"] else None


def per_event(rec, value):
    """The mean over the window's calls of ``value(call)``; None when the
    window is None or ``value`` finds nothing in some call."""
    calls = window(rec)
    if calls is None:
        return None
    vals = [value(c) for c in calls]
    if any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def stage_ms(rec, name: str):
    """Device ms an event in the spans named ``name``."""
    def value(call):
        got = [s.device_ms for s in call if s.name == name]
        return sum(got) if got else None
    return per_event(rec, value)


def kernel_ms(rec):
    """Device ms an event in the ``kernel.*`` spans (the outermost of any
    nested ones)."""
    def value(call):
        return sum(s.device_ms for s in call if s.name.startswith(KERNEL)
                   and not (s.parent >= 0 and call[s.parent].name.startswith(KERNEL)))
    return per_event(rec, value)


def syncs(rec):
    """Host-device synchronisations an event, over every span of the call."""
    return per_event(rec, lambda call: sum(s.syncs for s in call))
