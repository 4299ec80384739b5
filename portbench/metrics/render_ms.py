"""``render_ms.<cell>``: ms an event in the shadow-mapped render (the
Scene's ``render_pieces_frame``, fenced), over the traced run's fenced
events."""

SPANS = {"render": ("surtr_tpu_torch.scene", "render_pieces_frame")}


def read(rec):
    if not rec.span_calls.get("render") or not rec.fenced_events:
        return None
    return rec.span_s["render"] * 1e3 / rec.fenced_events
