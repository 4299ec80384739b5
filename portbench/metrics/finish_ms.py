"""``finish_ms.<cell>``: device ms an event in the program's span
``surtr.finish`` of ``prepare_fracture``: the occupancy test, the exact
caps, the refit (B4) and its fold (B1); from the profiled events' span
records (``pblib/spans.py``)."""

from pblib import spans


def read(rec):
    return spans.stage_ms(rec, "finish")
