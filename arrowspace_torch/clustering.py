"""Incremental clustering with optimal-K heuristics.

PyTorch-package counterpart of ``arrowspace_tpu.clustering`` (reference:
clustering.rs:30-928).  Optimal K runs on ≤1000 sampled rows (NumPy),
except the Two-NN estimate of a large corpus, whose distance tiles run on
the index's resident tensor.  The seeded incremental pass is
order-dependent, so it stays on the host in the native C++ library
(``native``), with the numpy scan as its plain version.  The unseeded
pass is the chunked relaxation: every row of a chunk decides against the
chunk-start snapshot, its distances are one product on the index's
device above DEVICE_CLUSTERING_MIN_ELEMS (host BLAS below), and once the
centroid cap is reached the whole remainder runs as one loop on that
device.  The downstream Laplacian and λτ stages consume the resulting
X×F centroid matrix on the index's device.

Every gate here is keyed on size, never on the device: a CPU index above
the gate takes the same engine, in its own dtype.

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
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import is_test_mode
from .utils.log import get_logger

logger = get_logger("arrowspace.clustering")

CLUSTERING_SEED = 128  # clustering.rs:30

__all__ = ["CLUSTERING_SEED", "Assignments", "compute_optimal_k",
           "estimate_intrinsic_dimension", "calinski_harabasz_score",
           "compute_threshold_from_pilot", "kmeans_lloyd",
           "run_incremental_clustering_with_sampling", "euclidean_dist",
           "nearest_centroid", "DEVICE_CLUSTERING_MIN_ELEMS", "TWONN_CHUNK",
           "TWONN_CORPUS_WIN"]

# Corpora of at least this many elements (rows x features) run the Two-NN
# tiles and the chunked scan's distances on the index's tensor; smaller
# ones keep them on host BLAS (clustering.py:709 of the JAX package).
DEVICE_CLUSTERING_MIN_ELEMS = 1 << 22
# Sample rows per Two-NN block, and the corpus rows of one Two-NN window:
# the transient distance plane is (TWONN_CHUNK x TWONN_CORPUS_WIN), 1 GiB
# of float32, whatever N.
TWONN_CHUNK = 256
TWONN_CORPUS_WIN = 1 << 20


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


def euclidean_dist(a, b) -> float:
    """Euclidean distance of two rows, in float64."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2)))


def nearest_centroid(row, centroids) -> Tuple[int, float]:
    """Linear-scan nearest centroid: (index, squared distance), the first
    of equal distances (clustering.rs:913-928)."""
    c = np.asarray(centroids, dtype=np.float64)
    d2 = np.sum((c - np.asarray(row, dtype=np.float64)[None, :]) ** 2, axis=1)
    idx = int(np.argmin(d2))
    return idx, float(d2[idx])


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


def _twonn_indices(n: int, base_seed: int) -> np.ndarray:
    """The Two-NN sample: the first min(n, 500) rows of a seeded
    permutation (clustering.rs:101-164)."""
    rng = np.random.default_rng(np.uint64((base_seed + 1) % 2 ** 64))
    return rng.permutation(n)[:min(n, 500)]


def _twonn_two_smallest_host(rows, indices) -> np.ndarray:
    """The two smallest squared distances from each sample row to the
    other rows, ascending, as (len(indices), 2) float64: blocked host
    tiles, one (TWONN_CHUNK, N) float32 product each, which is ample for
    a nearest-neighbour ratio."""
    x32 = np.asarray(rows, dtype=np.float32)
    sq = np.sum(x32 * x32, axis=1)
    out = []
    for s0 in range(0, len(indices), TWONN_CHUNK):
        sel = indices[s0:s0 + TWONN_CHUNK]
        d2 = sq[sel][:, None] - 2.0 * (x32[sel] @ x32.T) + sq[None, :]
        d2[np.arange(len(sel)), sel] = np.inf
        d2 = np.maximum(d2, 0.0)
        part = np.partition(d2, 1, axis=1)[:, :2]
        out.append(np.sort(part, axis=1).astype(np.float64))
    return np.concatenate(out, axis=0)


def _twonn_two_smallest_device(data: torch.Tensor, indices) -> np.ndarray:
    """_twonn_two_smallest_host on the index's resident tensor, in its
    dtype (clustering.py:192-282 of the JAX package).

    Each block of TWONN_CHUNK sample rows walks the corpus in windows of
    TWONN_CORPUS_WIN rows, d² = |s|² - 2 s·x + |x|² with the sample row
    itself masked out, and keeps a running two-smallest; no (chunk, N)
    plane is formed, and a window's plane is computed in place.  The
    last block is padded with the first sample row and the padding
    dropped; a tail window's start is clamped to N - win and its rows
    before the unclamped start are masked, so every window has one shape
    and every row counts once.  One fetch at the end."""
    n, _f = data.shape
    dev, inf = data.device, float("inf")
    win = min(TWONN_CORPUS_WIN, n)
    n_sel = len(indices)
    pad = (-n_sel) % TWONN_CHUNK
    padded = np.concatenate([indices, np.full(pad, indices[0])]) \
        if pad else np.asarray(indices)
    sel_all = torch.from_numpy(padded.astype(np.int64)).to(dev)
    col = torch.arange(win, device=dev)
    # |x|² of every row once, 2^16 rows at a time: a (win, F) square of
    # the window would be a transient as large as the window itself
    xsq = torch.cat([(b * b).sum(dim=1) for b in data.split(1 << 16)])
    out = []
    for s0 in range(0, len(padded), TWONN_CHUNK):
        sel = sel_all[s0:s0 + TWONN_CHUNK]
        rows_s = data[sel]
        rs_sq = (rows_s * rows_s).sum(dim=1, keepdim=True)
        m1 = torch.full((sel.shape[0],), inf, dtype=data.dtype, device=dev)
        m2 = m1.clone()
        for w0 in range(0, n, win):
            w0c = min(w0, n - win)
            xw = data[w0c:w0c + win]
            # |s|² - 2 s·x + |x|² in place: one plane of transient memory
            d2 = (rows_s @ xw.T).mul_(-2.0).add_(rs_sq) \
                .add_(xsq[None, w0c:w0c + win]).clamp_min_(0.0)
            gidx = col + w0c
            d2.masked_fill_((gidx < w0)[None, :]
                            | (gidx[None, :] == sel[:, None]), inf)
            w1, am = d2.min(dim=1)
            w2 = d2.scatter_(1, am[:, None], inf).min(dim=1).values
            m2 = torch.minimum(torch.minimum(m2, w2), torch.maximum(m1, w1))
            m1 = torch.minimum(m1, w1)
        out.append(torch.stack([m1, m2], dim=1))
    return torch.cat(out).double().cpu().numpy()[:n_sel]


def _twonn_dimension(two_smallest: np.ndarray, f: int) -> int:
    """The Two-NN estimate from each sample row's two smallest d²: the
    mean of r2/r1 over rows with r1 > 1e-12, ID = 1/ln(mean), rounded and
    clamped to [1, F] (clustering.rs:130-164)."""
    two = np.sqrt(np.maximum(two_smallest, 0.0))
    ok = two[:, 0] > 1e-12
    ratios = two[ok, 1] / two[ok, 0]
    if ratios.size == 0:
        return min(f, 3)
    mean_ratio = float(np.mean(ratios))
    ident = 1.0 / math.log(mean_ratio) if mean_ratio > 1.001 else float(f)
    id_clamped = int(np.clip(round(ident), 1, f))
    logger.debug("Two-NN mean ratio: %.4f, estimated ID: %d",
                 mean_ratio, id_clamped)
    return id_clamped


def estimate_intrinsic_dimension(rows, n: int, f: int, base_seed: int,
                                 device_data=None) -> int:
    """Two-NN ratio estimator (reference: clustering.rs:101-164).

    device_data: the index's resident copy of ``rows``; a corpus of at
    least DEVICE_CLUSTERING_MIN_ELEMS elements then runs its distance
    tiles on it, in its dtype (the host tiles are float32)."""
    if n < 10:
        return min(f, 2)
    indices = _twonn_indices(n, base_seed)
    if device_data is not None and n * f >= DEVICE_CLUSTERING_MIN_ELEMS:
        part = _twonn_two_smallest_device(device_data, indices)
    else:
        part = _twonn_two_smallest_host(rows, indices)
    return _twonn_dimension(part, f)


def _step1_bounds(rows, n: int, f: int, base_seed: int, device_data=None):
    """(k_min, k_max, id) (reference: clustering.rs:75-98)."""
    id_est = estimate_intrinsic_dimension(rows, n, f, base_seed,
                                          device_data=device_data)
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
                      seed_override: Optional[int] = None,
                      device_data=None, *, seconds: Optional[dict] = None
                      ) -> Tuple[int, float, int]:
    """(K, radius, intrinsic_dim) (reference: clustering.rs:36-72).

    device_data: the index's resident copy of ``rows``, on which a large
    corpus runs its Two-NN tiles (estimate_intrinsic_dimension).  The CH
    sweep and the pilot stay host numpy: the chosen K is an argmax over
    rounded scores.  ``seconds``, when given, receives the Two-NN
    estimate's wall seconds under "twonn"."""
    logger.info("Computing optimal K for clustering: N=%d, F=%d", n, f)
    base_seed = seed_override if seed_override is not None \
        else CLUSTERING_SEED

    t0 = time.perf_counter()
    k_min, k_max, id_est = _step1_bounds(rows, n, f, base_seed,
                                         device_data=device_data)
    if seconds is not None:
        seconds["twonn"] = time.perf_counter() - t0

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
    sampler, device_data=None,
) -> Tuple[np.ndarray, Assignments, List[int]]:
    """One-pass incremental clustering (reference: clustering.rs:547-910).

    Seeded builds (and unseeded ones below 4096 rows) run the ordered
    sequential scan in the native library (``native``; it raises if it
    cannot be built or loaded).  Unseeded runs of 4096 rows or more take
    the chunked relaxation (_incremental_clustering_chunked), as
    clustering.py:488-495 of the JAX package does; ``device_data`` is the
    index's resident copy of ``rows``, on which a large corpus runs the
    chunked scan's distances.  Returns (centroids X×F, assignments,
    sizes)."""
    if not builder.deterministic_clustering and len(rows) >= 4096:
        # The reference runs the same per-row rules under a rayon race
        # (decisions on stale snapshots, clustering.rs:570-660); the
        # chunked scan is that relaxation, vectorised.
        return _incremental_clustering_chunked(
            builder, rows, nfeatures, max_clusters, radius, sampler,
            device_data=device_data)
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


# ---------------------------------------------------------------------------
# The unseeded chunked scan
# ---------------------------------------------------------------------------

def _device_chunk_for(nrows: int) -> int:
    """Rows of one chunk window of the device engine: 131072, 262144 from
    2^22 rows (fewer, longer windows for the host's per-chunk rule pass),
    at least 8192 and at most nrows (clustering.py:712-723 of the JAX
    package)."""
    cap = 262144 if nrows >= (1 << 22) else 131072
    return min(cap, max(8192, nrows), nrows)


def _bucket_centroid_cap(max_clusters: int) -> int:
    """Rows of the engine's centroid buffer: max_clusters rounded up to a
    multiple of 128, the extra rows masked by n_c, so one buffer shape
    (and one product shape per window) serves every K of its bucket."""
    return ((max(max_clusters, 1) + 127) // 128) * 128


class _ChunkDistances:
    """The chunked scan's device engine (``_DeviceChunkDistances``,
    clustering.py:733-871 of the JAX package) on the index's resident
    tensor, in its dtype, with no padded copy of the corpus.

    A window is ``chunk`` rows starting at a chunk boundary c0; the tail
    window's start is clamped to n - chunk and only its last
    m = n - c0 rows are used, so every window's product has one shape.
    Per pre-cap chunk only the centroid snapshot goes to the device and
    (chunk,) nearest ids and d² come back; at the cap, decide_tail runs
    the whole remainder on the device."""

    def __init__(self, data: torch.Tensor, max_clusters: int, chunk: int):
        n, _f = data.shape
        assert chunk <= n
        self.n = n
        self.chunk = chunk
        self.mc_pad = _bucket_centroid_cap(max_clusters)
        self.corpus = data

    def _window(self, c0: int):
        """(the clamped window's rows, m): rows [c0, c0 + m) are its last
        m rows."""
        start = min(c0, self.n - self.chunk)
        return self.corpus[start:start + self.chunk], \
            min(self.chunk, self.n - c0)

    def _upload(self, cent: np.ndarray, n_c: int) -> torch.Tensor:
        """The centroid snapshot as a (mc_pad, F) buffer on the device."""
        pad = np.zeros((self.mc_pad, self.corpus.shape[1]), dtype=np.float64)
        pad[:n_c] = cent[:n_c]
        return torch.from_numpy(pad).to(device=self.corpus.device,
                                        dtype=self.corpus.dtype)

    @staticmethod
    def _nearest(rows: torch.Tensor, cent: torch.Tensor,
                 valid_c: torch.Tensor):
        """(nearest centroid id, its d²) of each row: d² = |x|² - 2x·c +
        |c|², clamped at 0, centroids past n_c at +inf; the first of
        equal minima."""
        d2 = ((rows * rows).sum(dim=1)[:, None] - 2.0 * (rows @ cent.T)
              + (cent * cent).sum(dim=1)[None, :])
        d2 = torch.where(valid_c[None, :], d2.clamp_min(0.0), float("inf"))
        bd, best = d2.min(dim=1)
        return best, bd

    def __call__(self, c0: int, cent: np.ndarray, n_c: int):
        """Snapshot nearest centroid of rows [c0, c0 + m) against
        cent[:n_c]: host (best int64, d² float64)."""
        rows, m = self._window(c0)
        valid_c = torch.arange(self.mc_pad, device=self.corpus.device) < n_c
        best, bd = self._nearest(rows, self._upload(cent, n_c), valid_c)
        return best[-m:].cpu().numpy(), bd[-m:].double().cpu().numpy()

    def segment_sums(self, c0: int, tgt: np.ndarray):
        """Per-centroid (sums (mc_pad, F) float64, counts (mc_pad,) int64)
        of rows [c0, c0 + m) grouped by ``tgt`` (m,) (-1 = not assigned).
        The sums add in the corpus dtype, in index_add_'s order (atomic,
        unordered on CUDA: inside the unseeded mode's relaxation)."""
        rows, m = self._window(c0)
        rows = rows[-m:]
        dev, cap = self.corpus.device, self.mc_pad
        t = torch.from_numpy(np.asarray(tgt, dtype=np.int64)).to(dev)
        valid = t >= 0
        t = torch.where(valid, t, cap)      # park the unassigned in slot cap
        sums = torch.zeros((cap + 1, rows.shape[1]), dtype=rows.dtype,
                           device=dev).index_add_(
            0, t, torch.where(valid[:, None], rows, 0.0))
        counts = torch.zeros(cap + 1, dtype=torch.int64,
                             device=dev).index_add_(0, t, valid.long())
        return (sums[:cap].double().cpu().numpy(),
                counts[:cap].cpu().numpy())

    def decide_tail(self, c0: int, cent: np.ndarray, counts: np.ndarray,
                    n_c: int, radius: float, sampler,
                    sampling_enabled: bool, max_clusters: int):
        """Every chunk decision of [c0, n) once n_c == max_clusters (no
        row can create a centroid), with the running means carried on
        the device (clustering.py:579-698 and :789-853 of the JAX
        package).  The sampler's draws for the whole tail come from its
        host generator in one block (a numpy Generator consumes its bit
        stream per value, so rng.random(m_total) equals the host rule
        path's per-chunk draws) and go up once; the centroids, counts,
        tail assignments and kept count come back once.  Returns host
        (cent (n_c, F) float64, counts (n_c,) int64, assign_tail (n - c0,)
        int64, kept)."""
        from .sampling import SimpleRandomSampler

        dev, dt = self.corpus.device, self.corpus.dtype
        m_total = self.n - c0
        counts_pad = np.zeros(self.mc_pad, dtype=np.int64)
        counts_pad[:n_c] = counts[:n_c]
        draws, kind, base = None, "none", 1.0
        if sampling_enabled:
            kind = "simple" if isinstance(sampler, SimpleRandomSampler) \
                else "density"
            base = getattr(sampler, "keep_rate",
                           getattr(sampler, "base_rate", 1.0))
            draws = torch.from_numpy(sampler._rng.random(m_total)).to(
                device=dev, dtype=dt)
        saturation = n_c / max_clusters if max_clusters else 0.0
        cent_d, counts_d, avec, kept = self._tail_windows(
            c0, self._upload(cent, n_c), torch.from_numpy(counts_pad).to(dev),
            n_c, radius, draws, kind, base, saturation)
        return (cent_d[:n_c].double().cpu().numpy(),
                counts_d[:n_c].cpu().numpy(), avec.cpu().numpy(), int(kept))

    def _tail_windows(self, c0, cent, counts, n_c, radius, draws, kind,
                      base, saturation):
        """decide_tail's loop over the chunk windows of [c0, n), all on the
        device: nothing in it reads a value back to the host.  Per window
        the rules at the cap (clustering.py:652-689 of the JAX package):
        keep by the sampler's draw; a row that would create takes the
        soft test on its unchanged d², so
            assign iff keep and d² <= radius/2 (and d² <= radius),
            soft   iff keep and not assign and d² <= 1.5·radius;
        then the grouped running mean cent' = (cent·count + sums) /
        (count + adds) where adds > 0, and soft rows counted with the
        centroid unmoved.  Returns device (cent, counts, assignments of
        [c0, n) with -1 for dropped rows, kept count)."""
        dev, dt, cap = self.corpus.device, self.corpus.dtype, self.mc_pad
        # the thresholds in the corpus dtype, as the JAX program casts them
        rad = torch.tensor(radius, dtype=dt)
        half, relax = rad * 0.5, rad * 1.5
        valid_c = torch.arange(cap, device=dev) < n_c
        avec = torch.empty(self.n - c0, dtype=torch.int64, device=dev)
        kept = torch.zeros((), dtype=torch.int64, device=dev)
        for w0 in range(c0, self.n, self.chunk):
            rows, m = self._window(w0)
            best, bd = self._nearest(rows, cent, valid_c)
            rows, best, bd = rows[-m:], best[-m:], bd[-m:]
            off = w0 - c0
            if kind == "none":
                keep = torch.ones(m, dtype=torch.bool, device=dev)
            else:
                if kind == "simple":
                    prob = base
                else:      # density-adaptive (sampling.rs:167-238)
                    fin = torch.isfinite(bd)
                    df = torch.log(torch.where(fin, bd, 0.0) + 0.1) \
                        .clamp_min(0.0)
                    df = torch.where(fin, df, 0.0)
                    prob = (base * (1.0 - saturation * 0.1)
                            * (1.0 + df * 0.3)).clamp(0.01, 1.0)
                keep = draws[off:off + m] < prob
            kept = kept + keep.sum()
            create = keep & (bd > half)
            assign = keep & ~create & (bd <= rad)
            soft = keep & ~assign & (bd <= relax)

            t_a = torch.where(assign, best, cap)       # park slot = cap
            sums = torch.zeros((cap + 1, rows.shape[1]), dtype=dt,
                               device=dev).index_add_(
                0, t_a, torch.where(assign[:, None], rows, 0.0))[:cap]
            cadd = torch.zeros(cap + 1, dtype=torch.int64,
                               device=dev).index_add_(0, t_a,
                                                      assign.long())[:cap]
            t_s = torch.where(soft, best, cap)
            scnt = torch.zeros(cap + 1, dtype=torch.int64,
                               device=dev).index_add_(0, t_s,
                                                      soft.long())[:cap]
            avec[off:off + m] = torch.where(assign | soft, best, -1)

            new_counts = counts + cadd
            cent = torch.where(
                (cadd > 0)[:, None],
                (cent * counts.to(dt)[:, None] + sums)
                / new_counts.clamp_min(1).to(dt)[:, None], cent)
            counts = new_counts + scnt     # soft: counted, eta = 0
        return cent, counts, avec, kept


def _apply_chunk_decisions(rows_c, best, best_d2, offset, builder, sampler,
                           radius, max_clusters, cent, counts, assign,
                           state, segsum=None, fetch_at=None,
                           nfeatures=None) -> None:
    """Apply the per-row create/assign/soft-outlier rules for one chunk,
    given snapshot nearest-centroid results (best, best_d2)
    (clustering.py:874-1040 of the JAX package).  Mutates
    cent/counts/assign in place and state["n_c"].

    segsum: optional grouped-sum callable (tgt_local (m,) int, -1 = not
    assigned) -> (sums (cap, F), counts (cap,)); when given, the
    running-mean reduction runs on the index's device against the
    resident corpus instead of np.add.at over host rows.

    rows_c may be None when BOTH segsum and fetch_at are given:
    fetch_at(local_idx) -> (len(idx), F) float64 rows serves the only
    other host use of row data, the few creator rows, so a caller holding
    the corpus elsewhere (the sharded build) moves no full chunk to the
    host."""
    m = best.shape[0]
    if m == 0:
        return
    if rows_c is None:
        assert segsum is not None and fetch_at is not None and \
            nfeatures is not None, \
            "lazy-row mode needs segsum + fetch_at + nfeatures"
    else:
        nfeatures = rows_c.shape[1]
    n_c = state["n_c"]
    relax = 1.5
    sampling_enabled = builder.sampling is not None

    if sampling_enabled:
        probs = sampler.keep_probability(best_d2, n_c, max_clusters)
        draws = sampler._rng.random(m)
        keep = draws < probs
        sampler.sampled_count += int(keep.sum())
        sampler.discarded_count += int(m - keep.sum())
    else:
        keep = np.ones(m, dtype=bool)

    want_create = keep & (best_d2 > radius * 0.5)
    assign_mask = keep & ~want_create & (best_d2 <= radius)
    soft_mask = keep & ~want_create & ~assign_mask \
        & (best_d2 <= radius * relax)

    # Creations in row order, each re-filtering the remaining candidates
    # against the new centroid (one matvec per creation): a candidate now
    # within radius/2 re-routes to assign.  Without it every same-cluster
    # creator of a chunk would spawn a duplicate centroid (none sees the
    # others') and hit the cap on the first chunk; with it every row still
    # decides at a legal snapshot point.
    creators = np.nonzero(want_create)[0]
    reroute_assign_rows, reroute_assign_tgt = [], []
    soft_extra_rows, soft_extra_tgt = [], []
    if creators.size and n_c >= max_clusters:
        # at the cap no creation can run: every candidate takes the soft
        # test on its unchanged best distance (decide_tail's rule)
        lb = best_d2[creators]
        soft_ok = lb <= radius * relax
        soft_extra_rows.extend(creators[soft_ok].tolist())
        soft_extra_tgt.extend(best[creators][soft_ok].tolist())
    elif creators.size:
        creator_rows = rows_c[creators] if rows_c is not None \
            else fetch_at(creators)
        # float32 distances in the creation loop (the relaxed unseeded
        # mode; the device engine's snapshot distances are float32 too)
        cand_rows = np.ascontiguousarray(creator_rows, dtype=np.float32)
        cand_sq = np.einsum("ij,ij->i", cand_rows, cand_rows)
        cand_best = best_d2[creators].astype(np.float32)
        cand_best_idx = best[creators].astype(np.int64).copy()
        active = np.ones(creators.size, dtype=bool)
        half = np.float32(radius * 0.5)
        pos = 0
        while n_c < max_clusters:
            rem = np.nonzero(active[pos:])[0]
            if rem.size == 0:
                break
            pos += int(rem[0])
            cent[n_c] = creator_rows[pos]
            counts[n_c] = 1
            assign[offset + creators[pos]] = n_c
            new_id = n_c
            n_c += 1
            active[pos] = False
            if not active.any():
                break
            d2new = np.maximum(
                cand_sq - 2.0 * (cand_rows @ cand_rows[pos])
                + cand_sq[pos], 0.0)
            closer = active & (d2new < cand_best)
            cand_best[closer] = d2new[closer]
            cand_best_idx[closer] = new_id
            leaving = active & (cand_best <= half)
            if leaving.any():
                # best <= radius/2 < radius: a leaver always assigns
                reroute_assign_rows.extend(creators[leaving].tolist())
                reroute_assign_tgt.extend(
                    cand_best_idx[leaving].tolist())
                active &= ~leaving
        if active.any():
            # cap reached mid-pass: the rest take the soft test on their
            # updated best
            lb = cand_best[active].astype(np.float64)
            lv = creators[active]
            li = cand_best_idx[active]
            soft_ok = lb <= radius * relax
            soft_extra_rows.extend(lv[soft_ok].tolist())
            soft_extra_tgt.extend(li[soft_ok].tolist())

    # grouped running-mean assignment, re-routed creators included
    a_idx = np.nonzero(assign_mask)[0]
    tgt = best[a_idx]
    if reroute_assign_rows:
        a_idx = np.concatenate([a_idx, np.asarray(reroute_assign_rows,
                                                  dtype=np.int64)])
        tgt = np.concatenate([tgt, np.asarray(reroute_assign_tgt,
                                              dtype=np.int64)])
    if a_idx.size:
        if segsum is not None:
            tgt_local = np.full(m, -1, dtype=np.int64)
            tgt_local[a_idx] = tgt
            sums_full, cnt_full = segsum(tgt_local)
            add_cnt = cnt_full[:n_c]
            add_sum = sums_full[:n_c]
        else:
            assert rows_c is not None
            add_cnt = np.bincount(tgt, minlength=n_c)
            add_sum = np.zeros((n_c, nfeatures))
            np.add.at(add_sum, tgt, rows_c[a_idx])
        upd = add_cnt > 0
        new_counts = counts[:n_c] + add_cnt
        cent[:n_c][upd] = (
            (cent[:n_c][upd] * counts[:n_c][upd, None]
             + add_sum[upd]) / new_counts[upd, None])
        counts[:n_c] = new_counts
        assign[offset + a_idx] = tgt

    # soft outliers: counted, centroids unmoved (eta = 0)
    soft_idx = np.nonzero(soft_mask)[0]
    soft_tgt = best[soft_idx]
    if soft_extra_rows:
        soft_idx = np.concatenate([soft_idx, np.asarray(soft_extra_rows,
                                                        dtype=np.int64)])
        soft_tgt = np.concatenate([soft_tgt, np.asarray(soft_extra_tgt,
                                                        dtype=np.int64)])
    if soft_idx.size:
        np.add.at(counts, soft_tgt, 1)
        assign[offset + soft_idx] = soft_tgt

    state["n_c"] = n_c


def _apply_atcap_tail(engine, c0: int, builder, sampler, radius,
                      max_clusters, cent, counts, assign,
                      n_c: int) -> None:
    """Apply the whole at-cap remainder [c0, n) from engine.decide_tail:
    final centroids and counts, tail assignments, sampler counts.  The
    same rules as _apply_chunk_decisions chunk by chunk at n_c ==
    max_clusters (clustering.py:1043-1063 of the JAX package)."""
    cent_new, counts_new, assign_tail, kept = engine.decide_tail(
        c0, cent, counts, n_c, radius, sampler,
        builder.sampling is not None, max_clusters)
    m_total = assign_tail.shape[0]
    if builder.sampling is not None:
        sampler.sampled_count += kept
        sampler.discarded_count += m_total - kept
    cent[:n_c] = cent_new
    counts[:n_c] = counts_new
    idx = np.nonzero(assign_tail >= 0)[0]
    if idx.size:
        assign[c0 + idx] = assign_tail[idx]


def _incremental_clustering_chunked(builder, rows, nfeatures, max_clusters,
                                    radius, sampler,
                                    chunk: Optional[int] = None,
                                    device_data=None):
    """The unseeded scan: a vectorised analogue of the reference's
    parallel (racy) mode (clustering.py:1066-1190 of the JAX package).
    Every row of a chunk takes its snapshot at the chunk boundary; the
    distances are one product (on ``device_data``, the index's resident
    tensor, when the corpus has at least DEVICE_CLUSTERING_MIN_ELEMS
    elements, in chunks of _device_chunk_for rows; else host BLAS in
    chunks of 8192); running means are grouped means.  Creations within a
    chunk respect the cap in row order; rows never see centroids created
    later in their own chunk, the wider race window the reference's rayon
    mode allows.  Once the cap is reached the engine runs the whole
    remainder in one call (_apply_atcap_tail).

    The pre-cap and at-cap seconds land in builder.clustering_seconds as
    "scan_pre_cap" and "scan_tail" (0 when the cap is never reached on
    the engine).  Returns (centroids X×F, Assignments, sizes)."""
    nrows = len(rows)
    sampling_enabled = builder.sampling is not None

    engine = None
    if (device_data is not None and device_data.shape[0] == nrows
            and nrows * nfeatures >= DEVICE_CLUSTERING_MIN_ELEMS):
        if chunk is None:
            chunk = _device_chunk_for(nrows)
        engine = _ChunkDistances(device_data, max_clusters, chunk)
    elif chunk is None:
        chunk = 8192

    # with the engine only the pre-cap chunks' rows are read on the host
    # (bootstrap and creator candidates): convert per visited chunk
    x = np.asarray(rows, dtype=np.float64) if engine is None \
        else (rows if isinstance(rows, np.ndarray) else np.asarray(rows))

    cent = np.zeros((max_clusters, nfeatures), dtype=np.float64)
    counts = np.zeros(max_clusters, dtype=np.int64)
    n_c = 0
    assign = np.full(nrows, -1, dtype=np.int64)
    t_scan0 = time.perf_counter()
    t_tail = 0.0

    for c0 in range(0, nrows, chunk):
        use_engine = engine is not None

        if use_engine and n_c >= max_clusters:
            logger.info("chunked scan: pre-cap phase %d rows in %.2fs; "
                        "at-cap tail %d rows in one call",
                        c0, time.perf_counter() - t_scan0, nrows - c0)
            t_tail0 = time.perf_counter()
            _apply_atcap_tail(engine, c0, builder, sampler, radius,
                              max_clusters, cent, counts, assign, n_c)
            t_tail = time.perf_counter() - t_tail0
            logger.info("chunked scan: at-cap tail done in %.2fs", t_tail)
            break

        rows_c = np.asarray(x[c0:c0 + chunk], dtype=np.float64)
        m = rows_c.shape[0]
        offset = c0

        if n_c == 0:
            # bootstrap: scan sequentially until the first kept row seeds
            # centroid 0, then the chunk's remainder proceeds vectorised
            continue_from = 0
            for r in range(m):
                kept = (not sampling_enabled) or sampler.should_keep(
                    rows_c[r], float("inf"), 0, max_clusters)
                continue_from = r + 1
                if kept:
                    cent[0] = rows_c[r]
                    counts[0] = 1
                    assign[c0 + r] = 0
                    n_c = 1
                    break
            if n_c == 0:
                continue  # whole chunk rejected before any centroid
            rows_c = rows_c[continue_from:]
            offset = c0 + continue_from
            m = rows_c.shape[0]
            if m == 0:
                continue
            # a mid-chunk restart is window-misaligned: this one chunk
            # runs on the host, the engine resumes at the next boundary
            use_engine = False

        segsum = None
        if use_engine:
            best, best_d2 = engine(c0, cent, n_c)
            segsum = (lambda tgt_local, _c0=c0:
                      engine.segment_sums(_c0, tgt_local))
        else:
            snap = cent[:n_c]
            d2 = (np.sum(rows_c * rows_c, axis=1)[:, None]
                  - 2.0 * rows_c @ snap.T
                  + np.sum(snap * snap, axis=1)[None, :])
            d2 = np.maximum(d2, 0.0)
            best = np.argmin(d2, axis=1)
            best_d2 = d2[np.arange(m), best]

        state = {"n_c": n_c}
        _apply_chunk_decisions(rows_c, best, best_d2, offset, builder,
                               sampler, radius, max_clusters, cent, counts,
                               assign, state, segsum=segsum)
        n_c = state["n_c"]

    builder.clustering_seconds["scan_pre_cap"] = \
        time.perf_counter() - t_scan0 - t_tail
    builder.clustering_seconds["scan_tail"] = t_tail

    if n_c == 0:
        sampler_desc = str(builder.sampling) if builder.sampling else "None"
        raise RuntimeError(
            f"No clusters created from data, sampling: {sampler_desc}")

    if sampling_enabled:
        _check_sampling_ratio(sampler, nrows)
    return cent[:n_c].copy(), Assignments(assign), counts[:n_c].tolist()




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
