"""``pack_ms.<cell>``: device ms an event in the program's span ``surtr.pack``
of ``prepare_fracture``: the volumes and the pack of the candidates into
pieces; from the profiled events' span records (``pblib/spans.py``)."""

from pblib import spans


def read(rec):
    return spans.stage_ms(rec, "pack")
