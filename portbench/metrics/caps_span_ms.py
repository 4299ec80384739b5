"""``caps_span_ms.<cell>``: device ms an event in the program's span
``surtr.caps`` around ``cap_fans_batch`` (the exact caps), unfenced, from
the profiled events' span records (``pblib/spans.py``); ``caps_ms`` times
the same call fenced in the window."""

from pblib import spans


def read(rec):
    return spans.stage_ms(rec, "caps")
