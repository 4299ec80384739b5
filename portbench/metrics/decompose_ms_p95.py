"""``decompose_ms_p95``: the 95th percentile of every event's latency in the
window, host clock, ms (each event ends in a device synchronise)."""

from pblib.stats import percentile


def read(rec):
    return percentile(rec.latencies, 95) * 1e3 if rec.latencies else None
