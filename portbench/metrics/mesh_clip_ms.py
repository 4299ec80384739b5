"""``mesh_clip_ms.<cell>``: device ms an event in the program's span
``surtr.mesh_clip`` of ``prepare_fracture``: the active planes and the mesh
clip (the pooled pair clip, B10); from the profiled events' span records
(``pblib/spans.py``)."""

from pblib import spans


def read(rec):
    return spans.stage_ms(rec, "mesh_clip")
