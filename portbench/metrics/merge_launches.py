"""K3's float32 launches a batch of the window's stream (the program's
counter ``k3.f32`` over ``batches``): 1.0 while K3 serves every batch, as
in a "merge" session; a binned session's stream counts only the repair's
fallbacks.

A program that launched K3 in the run but records no ``k3.f32`` has no
such counter, and gives None; a run that launched no K3 (the plain
versions on a CPU) reads 0.
"""

from portbench.metrics._stream import window_stream

LAUNCHES = "topk.merge_topk_partial.launches"


def read(rec):
    stream = window_stream(rec)
    if stream is None:
        return None
    c = stream["counters"]
    if "k3.f32" not in c and rec.get("counters", {}).get(LAUNCHES, 0):
        return None
    return c.get("k3.f32", 0) / c["batches"]
