"""Host milliseconds a batch that the repairs of the window's stream wait
on the device's stream: their host reads and uploads (the program's span
``repair.sync``)."""

from portbench.metrics._stream import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "repair.sync")
