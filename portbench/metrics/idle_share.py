"""``idle_share.<cell>``: the share of the profiled window (first event's
start to last event's end) in which no operation ran on the device, %."""


def read(rec):
    p = rec.profile
    if not p or not p.get("window_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
