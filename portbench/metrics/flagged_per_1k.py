"""Rows K1 flagged for repair per 1,000 queries of the window's stream
(the program's counters ``rows_flagged`` and ``queries``)."""

from portbench.metrics._stream import window_stream


def read(rec):
    stream = window_stream(rec)
    if stream is None:
        return None
    c = stream["counters"]
    return 1e3 * c.get("rows_flagged", 0) / c["queries"]
