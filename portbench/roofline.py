"""Peaks of the card and the least time a piece of work can take.

The work is the algorithm's, counted from shapes, whatever kernel runs:
an exact λ-aware scan of B queries over an N × F float32 corpus is
2·B·N·F operations (one multiply and one add per feature of each pair)
and reads the corpus and the queries once, N·F·4 + B·F·4 bytes.  The
least time is the larger of the operations over the dense TF32 peak (the
fastest float32-input rate the card has) and the bytes over the memory
bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet, dense rates at 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "tf32_flops": 494.7e12,
        "fp32_flops": 66.9e12,
        "bf16_flops": 989.4e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(kind: str) -> dict:
    """The peak table of the card named ``kind``; KeyError for a card
    the table lacks (a share against an unknown peak means nothing)."""
    return PEAKS[kind]


def scan_work(queries: int, n: int, f: int) -> tuple:
    """(operations, bytes) of an exact scan of ``queries`` queries over an
    n × f float32 corpus."""
    return 2.0 * queries * n * f, 4.0 * (n * f + queries * f)


def least_seconds(ops: float, n_bytes: float, peak: dict) -> float:
    """The least time ``ops`` TF32-rate operations moving ``n_bytes`` can
    take on the card of ``peak``."""
    return max(ops / peak["tf32_flops"], n_bytes / peak["hbm_bytes_per_s"])


def scan_least_seconds(batches, n: int, f: int, peak: dict) -> float:
    """Sum of the least times of a sequence of scans, one per batch, each
    given by the number of queries it asked."""
    return sum(least_seconds(*scan_work(q, n, f), peak) for q in batches)


def scan_share(rec) -> float:
    """Percent of the traced stretch's busy time that its scans need at
    least; None without a trace, a busy card or a known peak."""
    tr = rec.get("trace")
    kind = rec.get("device_kind")
    if not tr or tr["busy_s"] <= 0 or kind not in PEAKS:
        return None
    cfg = rec["config"]
    need = scan_least_seconds(rec["window"]["stretch_queries"],
                              int(cfg["rows"]), int(cfg["features"]),
                              PEAKS[kind])
    return 100.0 * need / tr["busy_s"]
