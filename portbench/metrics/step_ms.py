"""``step_ms.<cell>``: ms an event in the physics step (the Scene's
``physics_step``, fenced), over the traced run's fenced events."""

SPANS = {"step": ("surtr_tpu_torch.scene", "physics_step")}


def read(rec):
    if not rec.span_calls.get("step") or not rec.fenced_events:
        return None
    return rec.span_s["step"] * 1e3 / rec.fenced_events
