"""The trace reduction: busy time is the union of device intervals."""

import pytest

from portbench import trace


def test_union_merges_overlaps_and_keeps_holes():
    got = trace.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 11), (4, 4)])
    assert got == [(0, 3), (5, 9), (10, 11)]


def test_reduce_counts_overlapping_streams_once():
    device = [("k1", 1.0, 3.0), ("copy", 2.0, 4.0), ("k1", 6.0, 7.0),
              ("k3", 6.5, 7.5), ("k1", 9.5, 12.0)]
    spans = [("stretch", 0.0, 10.0), ("batch", 0.0, 5.0),
             ("batch", 5.0, 10.0), ("wait", 7.5, 9.0)]
    r = trace.reduce(device, spans)
    assert r["window_s"] == pytest.approx(10.0)
    # [1, 4] + [6, 7.5] + [9.5, 10] clipped to the stretch
    assert r["busy_s"] == pytest.approx(3.0 + 1.5 + 0.5)
    assert trace.idle_share(r) == pytest.approx(0.5)
    ops = dict((n, v) for n, v in r["device_ops"])
    assert ops == pytest.approx({"k1": 2.0 + 1.0 + 0.5, "copy": 2.0,
                                 "k3": 1.0})
    # holes [0, 1], [4, 6], [7.5, 9.5], longest first, each labelled by
    # the innermost span the host was in when it began
    assert r["idle_gaps"] == [["batch", pytest.approx(2.0)],
                              ["wait", pytest.approx(2.0)],
                              ["batch", pytest.approx(1.0)]]


def test_idle_share_needs_device_work():
    r = trace.reduce([], [("stretch", 0.0, 1.0)])
    assert trace.idle_share(r) is None
    assert trace.idle_share(None) is None
