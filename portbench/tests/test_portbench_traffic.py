"""The traffic generator: open-loop due times and latency arithmetic
against a fake server, and the closed loop's counts."""

import importlib
import time

import numpy as np
import pytest

open_loop = importlib.import_module("portbench.loops.open")
closed_loop = importlib.import_module("portbench.loops.closed")


class Off:
    """A tracer that records nothing."""

    def start(self, sync=None):
        pass

    def stop(self, sync=None):
        pass


class FakeSession:
    """Answers each batch after ``service`` seconds with ids equal to the
    queries' first value."""

    def __init__(self, service=0.0, k=3):
        self.service, self.k, self.batches = service, k, 0

    def search_stream(self, batches):
        for qb in batches:
            self.batches += 1
            end = time.perf_counter() + self.service
            while time.perf_counter() < end:
                pass
            ids = np.repeat(qb[:, :1].astype(np.int64), self.k, axis=1)
            yield np.ones((len(qb), self.k)), ids


OPEN = {"rate_per_s": 200, "sizes": [1, 16], "schedule_seed": 7,
        "trace_after": 10**9, "trace_requests": 1, "keep_queries": 10**6,
        "drain_s": 5}


def test_arrivals_offer_the_rate_and_the_same_work_to_every_seed():
    a_due, a_sz = open_loop.arrivals(OPEN, 20.0, 1)
    b_due, b_sz = open_loop.arrivals(OPEN, 20.0, 2)
    again, _ = open_loop.arrivals(OPEN, 20.0, 1)
    assert np.array_equal(a_due, again)
    assert not np.array_equal(a_due, b_due)
    assert np.all(np.diff(a_due) >= 0) and a_due[-1] < 20.0
    assert len(a_due) == pytest.approx(4000, rel=0.1)
    assert len(b_due) == pytest.approx(len(a_due), rel=0.05)
    assert a_sz.min() >= 1 and a_sz.max() <= 16
    assert a_sz.mean() == pytest.approx(8.5, rel=0.05)


def test_open_loop_times_from_due_and_queues_behind_a_busy_server(
        monkeypatch):
    due = np.array([0.0, 0.001, 0.002, 0.15])
    monkeypatch.setattr(open_loop, "arrivals",
                        lambda params, seconds, seed: (due, np.array(
                            [1, 2, 3, 4])))
    pool = np.arange(40, dtype=np.float32).reshape(10, 4)
    lines = []
    out = open_loop.run(FakeSession(0.03), pool, OPEN, 1.0, 5, Off(),
                            lambda: None, lines.append)
    lat, svc = np.array(out["latency_s"]), np.array(out["service_s"])
    assert out["requests"] == 4 and out["failed"] == 0
    assert np.all(svc >= 0.03)
    # each request starts when it is due or when the one before it is
    # done, whichever is later; its latency runs from when it was due
    # (an idle server's start may trail its due time by the sleep's
    # wake-up, which the run reports as the generator's lateness)
    done = due + lat
    start = done - svc
    ready = np.maximum(due, np.r_[0.0, done[:-1]])
    assert np.all(start >= ready - 1e-6)
    assert start[1:3] == pytest.approx(ready[1:3], abs=0.002)
    assert np.all(start - ready < 0.02)
    # waits: none, behind one, behind two, none (the server is idle again)
    wait = np.array(out["wait_s"])
    assert wait[0] < 0.02 and wait[3] < 0.02
    assert wait[2] > wait[1] > 0.02
    assert out["queries"] == 10
    assert "2 requests found the server idle" in lines[0]
    # requests take consecutive pool rows, wrapping around
    assert sorted(out["served"]["query_rows"].tolist()) == \
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]
    ids = out["served"]["ids"][:, 0]
    assert np.array_equal(ids, pool[out["served"]["query_rows"], 0])


def test_closed_loop_counts_every_query_and_keeps_a_sample():
    pool = np.arange(64 * 5, dtype=np.float32).reshape(64 * 5 // 4, 4)
    params = {"batch": 16, "trace_after": 10**9, "trace_batches": 1,
              "keep_batches": 3}
    fake = FakeSession(0.002)
    out = closed_loop.run(fake, pool, params, 0.2, 9, Off(),
                              lambda: None)
    assert out["requests"] == fake.batches > 10
    assert out["queries"] == 16 * fake.batches
    rows = out["served"]["query_rows"]
    assert len(rows) == 3 * 16
    assert np.array_equal(out["served"]["ids"][:, 0], pool[rows, 0])
    qps = harness_reader("qps.glove100")({"traffic": {"kind": "closed"},
                                 "window": out})
    assert qps == pytest.approx(out["queries"] / out["seconds"])


def harness_reader(name):
    from portbench import harness
    return harness.reader(name)
