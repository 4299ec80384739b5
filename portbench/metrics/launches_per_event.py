"""``launches_per_event.<cell>``: device operations (kernels, copies,
sets) in the profiled events' trace, per event. The harness prints beside
it the launches the program's own counters saw, since torch.profiler can
drop late device records."""


def read(rec):
    p = rec.profile
    return p["device_records"] / p["events"] if p and p.get("events") else None
