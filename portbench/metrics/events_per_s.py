"""``events_per_s``: events completed over the whole window, by the host
clock."""

from pblib.stats import rate


def read(rec):
    return rate(rec.completed, rec.window_s)
