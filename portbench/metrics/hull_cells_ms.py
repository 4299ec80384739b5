"""``hull_cells_ms.<cell>``: device ms an event in the program's span
``surtr.hull_cells`` of ``prepare_fracture``: seeds to the device, the ICH
(B2), the box, the ACH (B1), the cell planes and the patterns; from the
profiled events' span records (``pblib/spans.py``)."""

from pblib import spans


def read(rec):
    return spans.stage_ms(rec, "hull_cells")
