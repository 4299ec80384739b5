"""``syncs_per_event.<cell>``: host-device synchronisations an event that
the program counted inside ``prepare`` (CUDA's sync debug mode while its
spans record), from the profiled events' span records
(``pblib/spans.py``)."""

from pblib import spans


def read(rec):
    return spans.syncs(rec)
