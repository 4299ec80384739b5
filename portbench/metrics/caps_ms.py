"""``caps_ms.<cell>``: ms an event in the exact caps (``cap_fans_batch``,
fenced), over the traced run's fenced events."""

SPANS = {"caps": ("surtr_tpu_torch.fracture.pipeline", "cap_fans_batch")}


def read(rec):
    if not rec.span_calls.get("caps") or not rec.fenced_events:
        return None
    return rec.span_s["caps"] * 1e3 / rec.fenced_events
