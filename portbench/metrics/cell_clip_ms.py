"""``cell_clip_ms.<cell>``: device ms an event in the program's span
``surtr.cell_clip`` of ``prepare_fracture``: the two-pass Voronoi fold of
the ACH (B1 twice); from the profiled events' span records
(``pblib/spans.py``)."""

from pblib import spans


def read(rec):
    return spans.stage_ms(rec, "cell_clip")
