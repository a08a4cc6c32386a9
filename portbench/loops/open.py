"""The open loop: requests of ``sizes[0]``..``sizes[1]`` queries
(uniform) arrive as a Poisson process of ``rate_per_s``.  One server
takes them in order, each through its own ``search_stream([q])`` on a
session of ``batch``; a request that
comes due while the server is busy waits.  Latency runs from when a
request was due to when its results are on the host; service from when
the server took it.  The arrivals and sizes are one fixed draw
(``schedule_seed``) that the run's seed only reorders, so every seed
offers the same work.  Requests take consecutive rows of the query pool,
cycling.
"""

from __future__ import annotations

import math
import time

import numpy as np

from .. import trace

clock = time.perf_counter


def sleep_until(t: float) -> None:
    while True:
        d = t - clock()
        if d <= 0:
            return
        if d > 0.002:
            time.sleep(d - 0.001)


def arrivals(params: dict, seconds: float, seed: int) -> tuple:
    """(due seconds from the window's start, query counts) of every
    request due before ``seconds``."""
    rate = float(params["rate_per_s"])
    lo, hi = (int(v) for v in params["sizes"])
    n = int(math.ceil(rate * seconds * 1.3)) + 64
    base = np.random.default_rng(int(params["schedule_seed"]))
    gaps = base.exponential(1.0, n)
    sizes = base.integers(lo, hi + 1, n)
    run = np.random.default_rng(int(seed) % (2 ** 63))
    gaps, sizes = gaps[run.permutation(n)], sizes[run.permutation(n)]
    due = np.cumsum(gaps) / rate
    keep = due < seconds
    return due[keep], sizes[keep]


def run(session, pool: np.ndarray, params: dict, seconds: float,
        seed: int, tracer, sync, log=print) -> dict:
    due_rel, sizes = arrivals(params, seconds, seed)
    offsets = (np.cumsum(sizes) - sizes) % pool.shape[0]
    rows = [(o + np.arange(s)) % pool.shape[0]
            for o, s in zip(offsets, sizes)]
    queries = [np.ascontiguousarray(pool[r]) for r in rows]
    t_after, t_len = int(params["trace_after"]), int(params["trace_requests"])
    n = len(queries)
    lat, svc = np.full(n, math.nan), np.full(n, math.nan)
    late = np.full(n, math.nan)
    results = [None] * n
    t0 = clock() + 0.01
    stop_at = t0 + seconds + float(params.get("drain_s", 60))
    served = 0
    for i in range(n):
        if i == t_after:
            tracer.start(sync)
        elif i == t_after + t_len:
            tracer.stop(sync)
        due = t0 + due_rel[i]
        idle = clock() < due
        if idle:
            with trace.span("wait"):
                sleep_until(due)
        start = clock()
        if start > stop_at:
            break
        with trace.span("request"):
            out = list(session.search_stream([queries[i]]))
        end = clock()
        lat[i], svc[i] = end - due, end - start
        if idle:
            late[i] = start - due
        results[i] = out[0]
        served += 1
    t1 = clock()
    tracer.stop(sync)
    lateness = late[np.isfinite(late)]
    if lateness.size:
        log(f"generator: {lateness.size} requests found the server idle; "
            f"started late by median {np.median(lateness) * 1e3:.4f} ms, "
            f"max {lateness.max() * 1e3:.4f} ms")
    pick = np.random.default_rng(int(seed) % (2 ** 63)).permutation(served)
    take, count = [], 0
    for i in pick:
        if count >= int(params["keep_queries"]):
            break
        take.append(int(i))
        count += int(sizes[i])
    take.sort()
    return {"seconds": t1 - t0, "queries": int(sizes[:served].sum()),
            "requests": n, "failed": n - served,
            "latency_s": lat[:served].tolist(),
            "wait_s": (lat - svc)[:served].tolist(),
            "due_s": due_rel[:served].tolist(),
            "service_s": svc[:served].tolist(),
            "stretch_queries": sizes[t_after:t_after + t_len].tolist()
            if served > t_after else [],
            "served": {"query_rows": np.concatenate([rows[i] for i in take]),
                       "scores": np.concatenate([results[i][0]
                                                 for i in take]),
                       "ids": np.concatenate([results[i][1] for i in take])}}
