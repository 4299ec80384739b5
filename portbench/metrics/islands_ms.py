"""``islands_ms.<cell>``: device ms an event in the program's span
``surtr.islands`` of ``prepare_fracture``: the parity grid and the island
split (B3); from the profiled events' span records (``pblib/spans.py``)."""

from pblib import spans


def read(rec):
    return spans.stage_ms(rec, "islands")
