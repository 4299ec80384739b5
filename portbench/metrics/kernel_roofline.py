"""``kernel_roofline.<cell>``: the port's kernel calls in the profiled
events, the sum of their bounds (``kernels/<name>.py``, ``pblib/bounds``)
over the sum of their device time (the device operations launched inside
each call), %. It reads the same whatever kernel does the work, and
nothing where no kernel call was traced."""


def read(rec):
    p = rec.profile
    if not p or not rec.bounds:
        return None
    timed = p.get("kernel_calls", [])
    if [n for n, _ in timed] != [n for n, _ in rec.bounds]:
        return None
    t = sum(s for _, s in timed)
    return 100.0 * sum(b for _, b in rec.bounds) / t if t > 0 else None
