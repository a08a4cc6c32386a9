"""Host milliseconds a batch that the window's stream spends launching a
batch: the pinned copy, the query's τ and λ, the scan's enqueue, the
result copies and the event (the program's span ``stream.launch``)."""

from portbench.metrics._stream import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "stream.launch")
