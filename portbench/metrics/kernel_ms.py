"""``kernel_ms.<cell>``: device ms an event in the program's
``surtr.kernel.<name>`` spans (one around each call of a hand-written
kernel's launcher) under ``prepare``, from the profiled events' span
records (``pblib/spans.py``)."""

from pblib import spans


def read(rec):
    return spans.kernel_ms(rec)
