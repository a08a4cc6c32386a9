"""Incremental clustering with optimal-K heuristics.

PyTorch-package counterpart of ``arrowspace_tpu.clustering`` (reference:
clustering.rs:30-928), limited to what the seeded build runs.  Optimal-K
runs on ≤1000 sampled rows (NumPy) and the seeded incremental pass is
order-dependent, so both stay on the host: the pass runs in the native
C++ library (``native``), with the numpy scan as its plain version.  The
downstream Laplacian and λτ stages consume the resulting X×F centroid
matrix on the index's device.

Semantics kept from the reference:
- fixed default seed 128 (clustering.rs:30);
- Two-NN intrinsic-dimension estimate on a ≤500 sample
  (clustering.rs:101-164);
- k bounds: k_min = max(ceil(sqrt(N/10)), 2),
  k_max = min(F, N/10, 5·ID, sqrt(N)) then max(k_min+1) and min(N/2)
  (clustering.rs:75-98);
- Calinski–Harabasz sweep with penalty 0.8·k·ln N, 3 seeded trials per k,
  coarse step then fine-tune, ties prefer larger k (clustering.rs:167-310);
- radius = 1.5 × p90 of within-cluster d², with inter-centroid fallback
  (clustering.rs:384-492);
- incremental pass: new centroid iff d² > radius·0.5 and under cap;
  running-mean assignment iff d² <= radius; soft-outlier at radius ×1.5
  after saturation; drop otherwise (clustering.rs:547-910);
- sampling ratio in (0.325, 0.89) outside test mode
  (clustering.rs:896-900).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .config import is_test_mode
from .utils.log import get_logger

logger = get_logger("arrowspace.clustering")

CLUSTERING_SEED = 128  # clustering.rs:30

__all__ = ["CLUSTERING_SEED", "Assignments", "compute_optimal_k",
           "estimate_intrinsic_dimension", "calinski_harabasz_score",
           "compute_threshold_from_pilot", "kmeans_lloyd",
           "run_incremental_clustering_with_sampling"]


class Assignments:
    """Per-row cluster ids with ``None`` for dropped rows, the
    reference's ``Vec<Option<usize>>`` (clustering.rs:547), over an int64
    array with a -1 sentinel (``.array``): a 1M-element list of ints
    would cost a Python object per row."""

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = np.asarray(array, dtype=np.int64)

    def __len__(self) -> int:
        return self.array.shape[0]

    def __iter__(self):
        for v in self.array.tolist():
            yield None if v < 0 else v


def kmeans_lloyd(rows, k: int, max_iter: int, seed: int) -> np.ndarray:
    """Seeded Lloyd's k-means returning 0-indexed assignments
    (reference: clustering.rs:505-531, via smartcore KMeans).  Init picks
    k distinct rows uniformly at random; empty clusters keep their
    previous centroid."""
    x = np.asarray(rows, dtype=np.float64)
    if x.size == 0:
        return np.zeros((0,), dtype=np.int64)
    n = x.shape[0]
    k = min(k, n)
    if k == 0:
        return np.zeros((0,), dtype=np.int64)
    rng = np.random.default_rng(np.uint64(seed))
    init_idx = rng.choice(n, size=k, replace=False)
    centroids = x[init_idx].copy()

    assignments = np.zeros(n, dtype=np.int64)
    sq = np.sum(x * x, axis=1)
    for it in range(max_iter):
        d2 = (sq[:, None] - 2.0 * x @ centroids.T
              + np.sum(centroids * centroids, axis=1)[None, :])
        new_assignments = np.argmin(d2, axis=1)
        if it > 0 and np.array_equal(new_assignments, assignments):
            break
        assignments = new_assignments
        counts = np.bincount(assignments, minlength=k)
        sums = np.zeros((k, x.shape[1]))
        np.add.at(sums, assignments, x)
        nonempty = counts > 0
        centroids[nonempty] = sums[nonempty] / counts[nonempty, None]
    return assignments


def calinski_harabasz_score(rows, assignments, k: int) -> float:
    """CH index (reference: clustering.rs:313-381)."""
    x = np.asarray(rows, dtype=np.float64)
    a = np.asarray(assignments)
    n = x.shape[0]
    if k <= 1 or k >= n:
        return 0.0
    global_centroid = x.mean(axis=0)

    valid = a < k
    av = a[valid]
    xv = x[valid]
    counts = np.bincount(av, minlength=k)
    sums = np.zeros((k, x.shape[1]))
    np.add.at(sums, av, xv)
    nonempty = counts > 0
    centroids = np.zeros((k, x.shape[1]))
    centroids[nonempty] = sums[nonempty] / counts[nonempty, None]

    bgss = float(np.sum(
        counts[nonempty, None] * (centroids[nonempty] - global_centroid) ** 2))
    wgss = float(np.sum((xv - centroids[av]) ** 2))
    if wgss < 1e-10:
        return 0.0
    return (bgss / (k - 1)) / (wgss / (n - k))


def estimate_intrinsic_dimension(rows, n: int, f: int,
                                 base_seed: int) -> int:
    """Two-NN ratio estimator (reference: clustering.rs:101-164), as
    blocked host distance tiles: one (chunk, N) float32 tile per product,
    which is ample for a nearest-neighbour ratio."""
    if n < 10:
        return min(f, 2)
    sample_size = min(n, 500)
    rng = np.random.default_rng(np.uint64((base_seed + 1) % 2 ** 64))
    indices = rng.permutation(n)[:sample_size]

    x32 = np.asarray(rows, dtype=np.float32)
    sq = np.sum(x32 * x32, axis=1)
    ratios = []
    chunk = 256
    for s0 in range(0, len(indices), chunk):
        sel = indices[s0:s0 + chunk]
        d2 = sq[sel][:, None] - 2.0 * (x32[sel] @ x32.T) + sq[None, :]
        d2[np.arange(len(sel)), sel] = np.inf
        d2 = np.maximum(d2, 0.0)
        part = np.partition(d2, 1, axis=1)[:, :2]
        two = np.sqrt(np.sort(part, axis=1).astype(np.float64))
        ok = two[:, 0] > 1e-12
        ratios.extend((two[ok, 1] / two[ok, 0]).tolist())
    if not ratios:
        return min(f, 3)
    mean_ratio = float(np.mean(ratios))
    ident = 1.0 / math.log(mean_ratio) if mean_ratio > 1.001 else float(f)
    id_clamped = int(np.clip(round(ident), 1, f))
    logger.debug("Two-NN mean ratio: %.4f, estimated ID: %d",
                 mean_ratio, id_clamped)
    return id_clamped


def _step1_bounds(rows, n: int, f: int, base_seed: int):
    """(k_min, k_max, id) (reference: clustering.rs:75-98)."""
    id_est = estimate_intrinsic_dimension(rows, n, f, base_seed)
    k_min = max(math.ceil(math.sqrt(n / 10.0)), 2)
    k_max = max(min(f, n // 10, 5 * id_est, int(n ** 0.5)), k_min + 1)
    k_max = min(k_max, n // 2)
    return k_min, k_max, id_est


def _best_ch_for_k(rows, k: int, base_seed: int, mult: int) -> float:
    best = 0.0
    for trial in range(3):
        trial_seed = (base_seed + k * mult + trial) % 2 ** 64
        assignments = kmeans_lloyd(rows, k, 20, trial_seed)
        best = max(best, calinski_harabasz_score(rows, assignments, k))
    return best


def _step2_calinski_harabasz(rows, k_min: int, k_max: int,
                             base_seed: int) -> int:
    """CH sweep with penalty and fine-tune (reference:
    clustering.rs:167-310)."""
    n = len(rows)
    if n < 10:
        return k_min
    k_range = k_max - k_min
    k_step = 1 if k_range <= 5 else (2 if k_range <= 15 else 3)
    k_candidates = list(range(k_min, k_max + 1, k_step))
    penalty = 0.8

    def penalized(k, mult):
        score = _best_ch_for_k(rows, k, base_seed, mult)
        return score - penalty * k * math.log(n)

    k_scores = [(k, penalized(k, 1000)) for k in k_candidates
                if 2 <= k < n]
    if not k_scores:
        return k_min
    # max by score; ties prefer larger k (clustering.rs:229-241)
    best_k, best_score = max(k_scores, key=lambda t: (t[1], t[0]))

    if k_step > 1:
        fine_range = [best_k - (k_step - 1), best_k - 1, best_k,
                      min(best_k + 1, k_max), min(best_k + k_step - 1, k_max)]
        fine_range = sorted({k for k in fine_range
                             if k_min <= k <= k_max and k < n
                             and k not in k_candidates})
        fine_scores = [(k, penalized(k, 10000)) for k in fine_range]
        if fine_scores:
            fine_k, fine_score = max(fine_scores, key=lambda t: (t[1], t[0]))
            if fine_score > best_score:
                best_k, best_score = fine_k, fine_score

    logger.debug("Best K=%d with penalized score=%.4f", best_k, best_score)
    return best_k if best_k < k_max else k_max


def compute_threshold_from_pilot(rows, k: int, base_seed: int) -> float:
    """radius = 1.5·p90(within-cluster d²), with inter-centroid fallback
    (reference: clustering.rs:384-492)."""
    x = np.asarray(rows, dtype=np.float64)
    assignments = kmeans_lloyd(rows, k, 20, (base_seed + 100000) % 2 ** 64)

    counts = np.bincount(assignments, minlength=k)
    centroids = np.zeros((k, x.shape[1]))
    np.add.at(centroids, assignments, x)
    nonempty = counts > 0
    centroids[nonempty] /= counts[nonempty, None]

    valid = assignments < k
    dists = np.sum((x[valid] - centroids[assignments[valid]]) ** 2, axis=1)
    if dists.size == 0:
        logger.warning("No distances computed; using default radius 1.0")
        return 1.0

    dists_sorted = np.sort(dists)
    p90_idx = min(int(math.ceil(dists_sorted.size * 0.9)),
                  dists_sorted.size - 1)
    percentile_90 = float(dists_sorted[p90_idx])

    ne_idx = np.nonzero(nonempty)[0]
    if ne_idx.size >= 2:
        cne = centroids[ne_idx]
        csq = np.sum(cne * cne, axis=1)
        inter_m = csq[:, None] - 2.0 * cne @ cne.T + csq[None, :]
        iu = np.triu_indices(ne_idx.size, 1)
        min_inter = float(np.maximum(inter_m[iu], 0.0).min())
        has_inter = True
    else:
        min_inter = float("inf")
        has_inter = False

    ratio = percentile_90 / min_inter \
        if (math.isfinite(min_inter) and min_inter > 0.0) else 1.0

    if percentile_90 < 1e-8 or ratio < 0.01:
        if has_inter:
            return max(min_inter * 0.15, 1e-6)
        return 1e-6
    return max(percentile_90 * 1.5, 1e-6)


def compute_optimal_k(rows, n: int, f: int,
                      seed_override: Optional[int] = None
                      ) -> Tuple[int, float, int]:
    """(K, radius, intrinsic_dim) (reference: clustering.rs:36-72)."""
    logger.info("Computing optimal K for clustering: N=%d, F=%d", n, f)
    base_seed = seed_override if seed_override is not None \
        else CLUSTERING_SEED

    k_min, k_max, id_est = _step1_bounds(rows, n, f, base_seed)

    sample_size = min(n, 1000)
    if n > sample_size:
        rng = np.random.default_rng(np.uint64(base_seed))
        idxs = rng.permutation(n)[:sample_size]
        sampled = [rows[i] for i in idxs]
    else:
        sampled = list(rows)

    k_optimal = _step2_calinski_harabasz(sampled, k_min, k_max, base_seed)
    radius = compute_threshold_from_pilot(sampled, k_optimal, base_seed)
    return k_optimal, radius, id_est


def run_incremental_clustering_with_sampling(
    builder, rows, nfeatures: int, max_clusters: int, radius: float,
    sampler,
) -> Tuple[np.ndarray, Assignments, List[int]]:
    """One-pass incremental clustering (reference: clustering.rs:547-910).

    Seeded builds (and unseeded ones below 4096 rows) run the ordered
    sequential scan in the native library (``native``; it raises if it
    cannot be built or loaded).  The unseeded chunked relaxation is not
    ported yet (ROADMAP.md, queue 1: unseeded chunked clustering).
    Returns (centroids X×F, assignments, sizes)."""
    if not builder.deterministic_clustering and len(rows) >= 4096:
        raise NotImplementedError(
            "unseeded clustering of >= 4096 rows takes the chunked "
            "relaxation, which arrowspace_torch does not port yet (see "
            "ROADMAP.md queue 1, 'unseeded chunked clustering'); build "
            "with seed=... instead")
    from .native import native_incremental_clustering
    cent, assign, sizes = native_incremental_clustering(
        builder, rows, nfeatures, max_clusters, radius, sampler)
    if builder.sampling is not None:
        _check_sampling_ratio(sampler, len(assign))
    return cent, Assignments(assign), sizes


def _check_sampling_ratio(sampler, nrows: int) -> None:
    """The reference's runtime bound on the kept share of rows
    (clustering.rs:896-900), off in test mode."""
    sampled, discarded = sampler.get_stats()
    ratio = sampled / nrows if nrows else 0.0
    logger.debug("Inline sampling complete: %d kept (%.2f%%), %d discarded",
                 sampled, ratio * 100.0, discarded)
    if not is_test_mode():
        assert 0.325 < ratio < 0.89, (
            f"sampling_rate not in the interval 0.325..0.875 but {ratio}")


def _incremental_clustering_numpy(builder, rows, nfeatures, max_clusters,
                                  radius, sampler):
    """The ordered scan in plain NumPy: the native scan's plain version,
    which the tests hold it against.  Assignments are a list with None
    for dropped rows."""
    x = np.asarray(rows, dtype=np.float64)
    nrows = x.shape[0]
    logger.info("Starting incremental clustering with inline sampling "
                "(max_clusters=%d, radius=%.4f)", max_clusters, radius)

    sampling_enabled = builder.sampling is not None

    # Pre-allocated centroid buffer; `n_c` live centroids.
    cent = np.zeros((max_clusters, nfeatures), dtype=np.float64)
    counts = np.zeros(max_clusters, dtype=np.int64)
    n_c = 0
    assignments: List[Optional[int]] = [None] * nrows
    relax_factor = 1.5

    for row_idx in range(nrows):
        row = x[row_idx]

        # PHASE 1: snapshot distance (sequential => snapshot == current)
        if n_c == 0:
            best_idx, best_d2 = 0, float("inf")
        else:
            d2 = np.sum((cent[:n_c] - row[None, :]) ** 2, axis=1)
            best_idx = int(np.argmin(d2))
            best_d2 = float(d2[best_idx])

        if sampling_enabled:
            if not sampler.should_keep(row, best_d2, n_c, max_clusters):
                continue

        # First centroid special case
        if n_c == 0:
            cent[0] = row
            counts[0] = 1
            assignments[row_idx] = 0
            n_c = 1
            continue

        # PHASE 3: decision on snapshot distance
        if n_c < max_clusters and best_d2 > radius * 0.5:
            cent[n_c] = row
            counts[n_c] = 1
            assignments[row_idx] = n_c
            n_c += 1
        elif best_d2 <= radius:
            # running-mean assignment (recomputed against current state)
            d2 = np.sum((cent[:n_c] - row[None, :]) ** 2, axis=1)
            bi = int(np.argmin(d2))
            k_new = counts[bi] + 1
            cent[bi] += (row - cent[bi]) / k_new
            counts[bi] = k_new
            assignments[row_idx] = bi
        else:
            # soft-outlier policy after saturation (clustering.rs:760-814)
            d2 = np.sum((cent[:n_c] - row[None, :]) ** 2, axis=1)
            bi = int(np.argmin(d2))
            cur_d2 = float(d2[bi])
            if cur_d2 <= radius * relax_factor:
                counts[bi] += 1  # centroid not moved (eta = 0)
                assignments[row_idx] = bi
            # else: drop

    if n_c == 0:
        sampler_desc = str(builder.sampling) if builder.sampling else "None"
        raise RuntimeError(
            f"No clusters created from data, sampling: {sampler_desc}")

    if sampling_enabled:
        _check_sampling_ratio(sampler, nrows)
    return cent[:n_c].copy(), assignments, counts[:n_c].tolist()
