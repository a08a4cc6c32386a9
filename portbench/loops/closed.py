"""The closed loop: ``search_stream`` is fed an endless run of full
batches of ``batch`` queries taken in order from the query pool (which
holds whole batches, cycling), ``depth`` in flight, until ``seconds``
have passed; the batches in flight are then drained.  The rate is every
query answered over the wall time from the first batch to the last
result.
"""

from __future__ import annotations

import time

import numpy as np

from .. import trace

clock = time.perf_counter


def run(session, pool: np.ndarray, params: dict, seconds: float,
        seed: int, tracer, sync, log=print) -> dict:
    b = int(params["batch"])
    n_batches = pool.shape[0] // b
    if n_batches < 1 or pool.shape[0] % b:
        raise ValueError("the pool must hold whole batches")
    batches = [pool[i * b:(i + 1) * b] for i in range(n_batches)]
    t_after, t_len = int(params["trace_after"]), int(params["trace_batches"])
    kept, keep_n = [], int(params["keep_batches"])
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    t0 = clock()
    deadline = t0 + seconds

    def feed():
        i = 0
        while clock() < deadline:
            if i == t_after:
                tracer.start(sync)
            elif i == t_after + t_len:
                tracer.stop(sync)
            yield batches[i % n_batches]
            i += 1

    stream = session.search_stream(feed())
    done = 0
    while True:
        with trace.span("batch"):
            try:
                s, ids = next(stream)
            except StopIteration:
                break
        slot = done if done < keep_n else int(rng.integers(0, done + 1))
        if slot < keep_n:
            rows = (done % n_batches) * b + np.arange(b)
            item = (rows, np.array(s), np.array(ids))
            if slot < len(kept):
                kept[slot] = item
            else:
                kept.append(item)
        done += 1
    t1 = clock()
    tracer.stop(sync)
    return {"seconds": t1 - t0, "queries": done * b, "requests": done,
            "failed": 0, "stretch_queries": [b] * min(t_len, max(
                0, done - t_after)),
            "served": {"query_rows": np.concatenate([k[0] for k in kept]),
                       "scores": np.concatenate([k[1] for k in kept]),
                       "ids": np.concatenate([k[2] for k in kept])}}
