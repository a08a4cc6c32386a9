"""Host milliseconds a batch that the window's stream spends repairing
the rows K1 flagged, over every batch (the program's span
``stream.repair``)."""

from portbench.metrics._stream import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "stream.repair")
