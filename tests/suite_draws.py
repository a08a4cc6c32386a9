"""The seeded draws of the JAX package's kernel suites, as numpy arrays.

tests/test_pallas_kernels.py, tests/test_bin_repair.py and
tests/test_energy_approx.py draw their shapes and data from numpy
generators with fixed seeds.  This module replays those draws in the
suites' own rng order, so that the port's CPU suites
(tests/test_torch_kernel_suite.py and its neighbours), its card tests
(tests/test_torch_cuda_suites.py) and chip_smoke.py's phase [16] run the
kernels on the same inputs.  The Pallas layout knobs a JAX draw also
picks (tile, query block, lane split, pre-reduce) are drawn and dropped:
the port's engine picks its own layout.

Numpy only: chip_smoke.py loads this file on a machine without JAX."""

from __future__ import annotations

import numpy as np


def data(n, f, b, seed=0):
    """test_pallas_kernels.py _data: (q (b, f), qlam (b,), x (n, f),
    xlam (n,)), float32."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (b, f)).astype(np.float32),
            rng.uniform(0, 1, (b,)).astype(np.float32),
            rng.uniform(0.1, 1.0, (n, f)).astype(np.float32),
            rng.uniform(0, 1, (n,)).astype(np.float32))


def energy_data(n, g, b, seed=0):
    """test_pallas_kernels.py _energy_data: (zq, qlam, z, xlam), float32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, g)).astype(np.float32),
            rng.uniform(0, 1, (b,)).astype(np.float32),
            rng.normal(size=(n, g)).astype(np.float32),
            rng.uniform(0, 1, (n,)).astype(np.float32))


def approx_data(n, g, b, seed=0, clustered=False):
    """test_energy_approx.py _data: (zq, qlam, z, lam), float32."""
    rng = np.random.default_rng(seed)
    if clustered:
        cents = rng.normal(size=(16, g)) * 2
        z = (cents[rng.integers(0, 16, n)]
             + rng.normal(0, 0.5, (n, g))).astype(np.float32)
        zq = (z[rng.integers(0, n, b)] * 1.02).astype(np.float32)
    else:
        z = rng.normal(size=(n, g)).astype(np.float32)
        zq = rng.normal(size=(b, g)).astype(np.float32)
    lam = rng.uniform(0, 1, n).astype(np.float32)
    qlam = rng.uniform(0, 1, b).astype(np.float32)
    return zq, qlam, z, lam


def k1_fuzz():
    """test_binned_topk_fuzz_shapes_and_k (test_pallas_kernels.py:290-327):
    yields (trial, n, f, b, k, alpha); its data is data(n, f, b,
    seed=trial)."""
    rng = np.random.default_rng(99)
    for trial in range(8):
        n = int(rng.integers(300, 4000))
        f = int(rng.choice([8, 17, 32, 96]))
        b = int(rng.integers(1, 7))
        k = int(rng.choice([1, 3, 11, 29]))
        alpha = float(rng.uniform(0.0, 1.0))
        rng.choice([256, 512]), rng.choice([2, 4, 8])
        lane_split = int(rng.choice([1, 2, 4]))
        _pre = bool(rng.random() < 0.5) and lane_split > 1
        yield trial, n, f, b, min(k, n), alpha


def k1_deep():
    """test_binned_topk_deep_split_deep_depth_fuzz (:329-365): yields
    (trial, n, f, b, k, alpha, depth); its data is data(n, f, b,
    seed=100 + trial)."""
    rng = np.random.default_rng(7)
    for trial in range(6):
        n = int(rng.integers(600, 5000))
        f = int(rng.choice([16, 64, 128]))
        b = int(rng.choice([4, 8]))
        k = int(rng.choice([3, 10, 11]))
        alpha = float(rng.uniform(0.0, 1.0))
        rng.choice([256, 512]), rng.choice([8, 16])
        depth = int(rng.choice([3, 4]))
        yield trial, n, f, b, k, alpha, depth


# test_binned_topk_kband_matches_xla (:403-445): data(2048, 32, 3, seed=k)
KBAND = (64, 100, 128)


def anchor():
    """test_binned_topk_alpha1_bitwise_cosine_anchor (:674-692): (q, ql,
    x, xl) at n = 4096, F = 16, B = 4, served at α = 1, k = 5."""
    rng = np.random.default_rng(41)
    n, f, b = 4096, 16, 4
    x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    xl = rng.uniform(0, 1, (n,)).astype(np.float32)
    q = rng.uniform(0.1, 1.0, (b, f)).astype(np.float32)
    ql = rng.uniform(0, 1, (b,)).astype(np.float32)
    return q, ql, x, xl


# The merge top-k cases (test_fused_topk_*, :21-72) as (n, f, b, k, alpha,
# seed): k past a tile's tail, the query chunking and the wide rows.
MERGE_CASES = ((1000, 64, 4, 8, 0.9, 0), (2048, 64, 4, 8, 0.9, 0),
               (777, 64, 4, 8, 0.9, 0), (512, 32, 130, 5, 0.7, 0),
               (600, 1024, 700, 6, 0.8, 3), (300, 16, 2, 20, 1.0, 0))


def k6_fuzz():
    """test_binned_energy_fuzz_shapes_and_k (:607-641): yields (trial, n,
    g, b, k, wl, wd); its data is energy_data(n, g, b, seed=100 +
    trial)."""
    rng = np.random.default_rng(17)
    for trial in range(8):
        n = int(rng.integers(300, 4000))
        g = int(rng.choice([8, 17, 48, 96]))
        b = int(rng.integers(1, 7))
        k = int(rng.choice([1, 3, 11, 29]))
        wl = float(rng.uniform(0.0, 2.0))
        wd = float(rng.uniform(0.0, 2.0))
        rng.choice([256, 512]), rng.choice([2, 4, 8])
        lane_split = int(rng.choice([1, 2, 4]))
        _pre = bool(rng.random() < 0.5) and lane_split > 1
        yield trial, n, g, b, min(k, n), wl, wd


# test_approx_certified_rows_match_chunked_oracle (test_energy_approx.py:
# 101-123) as (n, k, clustered); its data is approx_data(n, 24, 6,
# seed=n, clustered=clustered), served at w_λ = 1, w_D = 0.5.
APPROX_CASES = ((3000, 8, False), (2048, 10, True), (777, 5, False))


def depth_for(k: int) -> int:
    """The bin depth both packages give k (pallas_bintopk.py:61-73)."""
    return 2 if k <= 4 else (3 if k <= 48 else 4)


def storms(seed=123, trials=8):
    """test_strided_repair_fuzz_full_equality (test_bin_repair.py:264-313):
    yields (trial, q, ql, x, xl, alpha, k, stride, n_storms), the storms
    planted at the JAX draw's bin stride."""
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        n = int(rng.integers(1500, 6000))
        f = int(rng.choice([8, 24, 48]))
        b = int(rng.integers(1, 5))
        k = int(rng.choice([4, 8, 13]))
        tile = int(rng.choice([256, 512]))
        lane_split = int(rng.choice([1, 2, 4]))
        _pre = bool(rng.random() < 0.5) and lane_split > 1
        stride = tile // lane_split
        depth = depth_for(k)
        alpha = float(rng.choice([1.0, 0.9, 0.7]))
        q = rng.uniform(0.1, 1.0, (b, f)).astype(np.float32)
        x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
        n_storms = int(rng.integers(1, 4))
        for _ in range(n_storms):
            binpos = int(rng.integers(0, stride))
            qi = int(rng.integers(0, b))
            copies = depth + 1 + int(rng.integers(0, 3))
            for j in range(copies):
                g = binpos + j * stride
                if g < n:
                    x[g] = q[qi]
        ql = rng.uniform(0, 1, (b,)).astype(np.float32)
        xl = rng.uniform(0, 1, (n,)).astype(np.float32)
        yield trial, q, ql, x, xl, alpha, k, stride, n_storms


def tau_rows():
    """The τ selection draws, float32: test_bisect_tau_duplicates_and_
    signed_zero (:694-717, heavy duplicates, an all-equal row, signed
    zeros across the median, odd and even counts) and the rows of
    test_fused_select_tau_sublane_layouts_match_lane (:643-671, F = 24,
    64, 128 with NaN and an all-inf row).  Yields (name, rows)."""
    rng = np.random.default_rng(31)
    f = 32
    x = rng.choice([-2.0, -0.5, 0.25, 1.5, 3.0], size=(700, f)) \
        .astype(np.float32)
    x[5, :] = 7.0
    x[9, : f // 2] = -0.0
    x[9, f // 2:] = 0.0
    x[12, ::3] = np.nan
    yield "duplicates_signed_zero", x
    rng = np.random.default_rng(29)
    for f in (24, 64, 128):
        x = rng.normal(size=(700, f)).astype(np.float32)
        x[3, 5] = np.nan
        x[17, :] = np.inf
        yield f"layouts_f{f}", x
