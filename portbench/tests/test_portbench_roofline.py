"""Roofline counts from shapes."""

import pytest

from portbench import roofline

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_scan_work_counts_the_algorithm():
    ops, nbytes = roofline.scan_work(2048, 1_183_514, 100)
    assert ops == 2 * 2048 * 1_183_514 * 100
    assert nbytes == 4 * (1_183_514 * 100 + 2048 * 100)


def test_batch_scan_is_bound_by_operations_and_small_one_by_bytes():
    big = roofline.least_seconds(*roofline.scan_work(2048, 1_183_514, 100),
                                 H100)
    assert big == pytest.approx(2 * 2048 * 1_183_514 * 100 / 494.7e12)
    small = roofline.least_seconds(*roofline.scan_work(4, 1_183_514, 100),
                                   H100)
    assert small == pytest.approx(4 * (1_183_514 * 100 + 400) / 3.35e12)


def test_scan_share_in_percent_and_silent_without_a_known_card():
    rec = {"trace": {"busy_s": 0.02}, "device_kind": "NVIDIA H100 80GB HBM3",
           "config": {"rows": 1_000_000, "features": 768},
           "window": {"stretch_queries": [2048]}}
    need = 2 * 2048 * 1e6 * 768 / 494.7e12
    assert roofline.scan_share(rec) == pytest.approx(100 * need / 0.02)
    assert roofline.scan_share({**rec, "device_kind": "cpu"}) is None
    assert roofline.scan_share({**rec, "trace": None}) is None
