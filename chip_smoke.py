#!/usr/bin/env python3
"""Smoke run of arrowspace_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels (nvcc, sm_90a) and drives four
paths once at full width: two on one seeded, clustered 1,000,000 x 128
corpus, one on a 1,000,000 x 768 and one on a 1,000,000 x 1536 corpus of
the same kind:

- the cosine path: ArrowIndex.build, then a SearchSession serving
  batched λ-aware top-k at B=2048, k=10, α=0.9 (kernels K1, K2, K3);
- the energy path: ArrowIndex.build_energy with
  EnergyParams(allow_tall_graphs=True), whose JL projection gives a
  1,000,000 x 64 z-plane, then an exact EnergySearchSession and one with
  approx=True, both at B=2048, k=10, w_λ=1.0, w_D=0.5 (K4 in the build,
  K6 and K7 in the sessions);
- the wide projected path: ArrowIndex.build with dims_reduction=True on
  the 768-wide rows, whose JL feature graph has r = min(jl_dim, F/2)
  nodes, so λ of the raw rows takes K4 and then K5 in each 2 GiB row
  window; then a SearchSession as on the cosine path (K1, K3);
- the 1536-wide projected path: the same build on 1536-wide rows (the
  width of the most widely deployed text embeddings), whose F is above
  K1's gate, so the SearchSession resolves "merge" and serves every batch
  through the exact merge kernel K3 (K4, then K5, in each of the build's
  three row windows); a "plain" session (matmul + stable sort) is timed
  beside it.

Every seeded build's clustering scan runs in the native C++ library
(arrowspace_torch/native), compiled with the host C++ compiler at first
use; each build prints its optimal-K and scan seconds, and its Two-NN
estimate from the card tile beside the host tiles' on the same sample
rows (they must be equal).  Two more phases on the cosine corpus:

- the API on the seeded cosine index, after its session: search_hybrid
  against a float64 plain hybrid, range on three λ bands, add_items /
  mul_items / scale_item with the one-row λ refresh against
  recompute_lambdas (one K2 launch), stats and warmup;
- the unseeded cosine path: ArrowIndex.build without a seed (the
  chunked scan, its at-cap tail on the card) and a SearchSession (K2 in
  the build, K1), then the chunked scan's engine on the card (float32)
  against its host path (float64) at the build's K and radius.

Three phases cover the spectral build, persistence and the live
sessions:

- persistence: the seeded cosine index saved as Parquet artifacts
  (under _smoke_artifacts/, removed at the end), loaded onto the card
  and served: ids and scores bitwise those of the index's own session,
  and no K2 in the load; a 131072-row snapshot of the wide projected
  index saved and loaded likewise, its projection matrix bitwise;
- live: a LiveSearchSession on the seeded cosine index (capacity n +
  131072, K1 at the live count): 16 batches bitwise the static
  session's, then add 65536 rows, update 4096 and delete 65536, each
  timed and followed by 4 batches held against the plain scan of the
  live rows, the added rows' λ against the query preparation, and a
  to_index snapshot saved, loaded and served; a LiveEnergySearchSession
  on the energy index (K6) through the same steps; a live "merge"
  session on the 1536-wide index (K3) around an add and a delete;
- spectral: the cosine corpus built again with with_spectral(True): the
  signals graph against a float64 numpy build, λ (one K2 launch)
  against a float64 λ, then a SearchSession.

Five phases cover the pruned sessions and out-of-core streaming:

- [4e] the pruned sessions on the seeded cosine index: the cells built
  on the host and on the card (cap 256), a B=16 session and a B=256
  union session over 64 batches of corpus rows x 1.02 each, every batch
  held against the plain full scan, timed beside a SearchSession at the
  same B; a batch of Gaussian queries, which flag and re-run through K1;
  an auto-budget union session from 8 units, which grows; the cells
  saved, loaded and served bitwise; a zero-row corpus built on the card
  against the host build;
- [4f] the JAX package's own pruned corpus (1024 centres, noise 0.03,
  benchmarks/pruned_crossover.py:37-58) at 1M x 128, built with
  ArrowIndex.build, B=16 and B=256 sessions on 16 hot regions beside a
  SearchSession at the same B;
- [10c] a B=16 pruned session on the wide 1M x 768 projected index;
- [4g] and [13c] streaming from host memory in chunks of 2^18 rows
  through pinned, double-buffered copies: λ (K2; K4 and K5 at 1536)
  against the build's, and the top-k of a 2048-query batch (K1 with its
  repair; K3 at 1536) against the index's session, with the upload rate
  and the share of copy time hidden behind compute.

Six phases cover the ensembles and the mesh, the mesh as MESH_SHARDS =
4 shards on the one card (shards sharing a card measure the per-shard
launches and the merge, not how a mesh of cards scales):

- [4h] a λτ-graph ensemble on the seeded cosine index: build_ensemble
  over ensemble_params (6 variants, τ once by K4), the (dk=0, fe=1.0)
  variant's λ against the index's, ensemble_topk_batch at B=2048 over
  16 batches against a float64 fused score;
- [4i] the mesh on the cosine index: the sharded λ (K2 per shard)
  against the build's, binned (K1 per shard, the mesh repair and its K3
  exact pass) and merge (K3 per shard) DistributedSearchSessions over
  the 16 batches held to the single-chip session, the (2, 2)
  hierarchical merge against the 1-D one, and the cell screen of [4e]
  over the mesh, whose flagged rows re-run through the mesh's K3;
- [5c] distributed_build_step on the 1M x 128 corpus at the unseeded
  build's K and radius, its assignments held row for row to the same
  sharded scan in float64 on a CPU mesh, beside the single-chip chunked
  scan;
- [4j] the multi-process dry run in a worker process, NCCL at world
  size 1 on the card, four shards at 262144 x 64, its binned sessions
  through the strided mesh repair;
- [8c] a mesh energy session (K6 per shard, the mesh energy repair)
  held to the single-chip exact session;
- [13d] a mesh merge session over the 1536-wide index (K3 per shard),
  4 batches held to the single-chip merge session.

Each prints its ms a batch beside the single-chip session's and the
merge's share of device time under torch.profiler.

Three phases cover bf16 serving (the bf16 modes of K1 and K3, bf16
operands with float32 accumulation), each on an index above:

- [3b], [11b], [14b] a bf16 SearchSession on the cosine, wide and
  1536-wide indexes beside the float32 session, both timed over the 16
  batches in this run; every one resolves "binned" (K1's bf16 gate
  admits F <= 1536) and must launch K1's bf16 mode once a batch (and K3's
  for batch 0's overflowing repair) and no float32 K1 or K3; 256 queries
  of batch 0 are held against the plain bf16 full scan (the same bf16
  operands, a float32 product, the stable two-key sort), and the top-10
  overlap with the float32 session is logged, not gated; then K1's bf16
  mode (wgmma fed by a TMA ring, csrc/bintopk_bf16.cu) against its plain
  version at that width, with what its launch runs (query block, ring
  stages, shared bytes, registers; a ring below 3 stages or a spilled
  register fails) and the corpus bytes it reads from L2 a batch, and on
  the cosine index K3's at the whole batch and at a repair's single row;
- [3d] a live bf16 session on the cosine index: 4 batches bitwise the
  static bf16 session's, then 4096 rows added and 2 batches held by
  buffer position against the plain bf16 scan of the live rows;
- [14c] a bf16 session on the 1536-wide index that resolves "merge" (the
  kind bf16 sessions take above K1's bf16 gate, F > 1536): its 16
  batches through K3's bf16 mode (wgmma fed by a TMA ring,
  csrc/merge_topk_bf16.cu), timed beside the [14b] session's, 256
  queries of batch 0 held against the plain bf16 full scan; then K3's
  bf16 mode against its plain version at 1M x 1536, with what its launch
  runs (a ring below 3 stages or a spilled register fails) and the bytes
  it reads from L2 a batch.

One phase covers the JAX package's names and options ported last, on
the indexes above ([15], the migration surface):

- [15a] on the seeded cosine index, before the API phase mutates it:
  ArrowIndex.build(spectral=True) (λ, signals and a 2048-query search
  bitwise the [4d] builder route's); search with use_pallas None and
  True (K1, the strided repair and K3) and False (no kernel, bitwise the
  plain full scan); use_pallas=True on a 60000-row slice, below the
  streaming kernels' row floor (K1); SearchSessions with
  prepare_corpus=True and False over the 16 batches (bitwise equal; ms
  a batch and the bytes each holds after construction);
  ops.search.hybrid_search_device on one query against a float64 plain
  hybrid;
- [15b] the exact energy sessions with prepare_corpus=True and False
  (K6, bitwise equal, ms and resident bytes), and approx=True with
  prepare_corpus=False refused;
- [15c] "merge" sessions of the 1536-wide index with prepare_corpus=True
  and False over 4 batches (K3, bitwise equal, ms and resident bytes).

Each path is run with the launch counters set to 0 just before it and
read just after it.  Then every kernel is held against its plain PyTorch
version on the card at the path's shapes, and each session against the
plain full scan.  The corpus carries exact duplicate rows, as real
corpora do, placed so that more than the binned kernels' depth of them
share a bin: the first streamed batch of each session then needs the
strided repair.  Any failed check exits non-zero.  Without CUDA, or
without the package beside it, it exits non-zero and prints no result.

Output: progress lines (each session's device time by kernel under
torch.profiler among them), then the card's name and power limit, then
one JSON line with each kernel's launches (counted over its path's run;
K3's over the 1536-wide path, with its other paths' counts beside them),
error against its plain version, mean times, the bound of its work on
this card (for K1, K2, K3, K5, K6 and K7, whose products run on the
tensor cores as 3×TF32, also bound_fp32_ms, the bound of the same work on
the fp32 CUDA cores; for K1 and K3 the time of torch.matmul of the
product alone, as context; for K3 its record at 1M x 1536 and at the
wide repair's shape; for K2 and K5 their λ error against a float64 plain
λ, K2's record at the cosine build's shape and K5's at the 1536-wide
build's row window, each held against its plain version) and the time of a
PyTorch call computing the same function (null where none does), then
the last line {"ok": true, "device": ...}.  The bf16 modes have their own
entries, bintopk_bf16 (source csrc/bintopk_bf16.cu; launches on the
cosine bf16 session's path; its records at_768 and at_1536) and
merge_topk_bf16 (source csrc/merge_topk_bf16.cu; its records at_repair
and at_1536, the latter with the [14c] session's ms a batch),
their bounds at the dense bf16 peak, their matmul_ms the time of the
bf16 product alone.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import numpy as np

N_ROWS, N_FEAT, N_CENTRES, NOISE = 1_000_000, 128, 64, 0.05
# The wide projected path: the JAX package's wide-F configuration
# (bench.py:691-709, the 100M x 768 target's F) at 1M rows.
W_ROWS, W_FEAT = 1_000_000, 768
# The 1536-wide path: the shape of dbpedia-entities-openai-1M (OpenAI
# text-embedding-ada-002 vectors), made here from the seed; batches of the
# "plain" session timed beside the "merge" one.
X_ROWS, X_FEAT, X_PLAIN_BATCHES = 1_000_000, 1536, 3
SEED = 11
# The default ε (1e-3) leaves this corpus's feature graph without an edge,
# so every λ would be 0 and neither K2 nor the λ term would be tested.
EPS = 1.0
BATCH, K, ALPHA, N_BATCHES = 2048, 10, 0.9, 16
N_PROFILE = 8           # batches of each session under the profiler
TAULAMBDA_ROWS = 262_144
TOL = 1e-5              # kernel vs plain version, float32 scores and λ
# The energy path: session weights, and the score tolerance against a
# reference of another rounding (float64, or cuBLAS's d²): d² = |q|² +
# |x|² - 2·q·x cancels for near duplicates, and w_D/(1+√d²) magnifies a
# one-ulp error of d² (≈ 4e-6 at |z|² ≈ 30) by w_D/(2√d²).
E_WL, E_WD = 1.0, 0.5
E_TOL = 5e-5
# Published H100 SXM peaks: float32 outside the tensor cores, HBM3, and
# dense TF32 on the tensor cores (the 3×TF32 products of K1, K3, K6, K7).
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
PEAK_TF32_FLOPS = 494.7e12
# Dense bf16 on the tensor cores (K1's and K3's bf16 modes).
PEAK_BF16_FLOPS = 989.4e12
# The live bf16 session: batches held bitwise to the static bf16 session,
# rows added, then batches held to the plain bf16 scan of the live rows.
BF16_LIVE_BATCHES, BF16_LIVE_ADD, BF16_LIVE_AFTER = 4, 4096, 2


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def clustered_rows(n: int, f: int, seed: int) -> np.ndarray:
    """The serving suite's corpus (bench.py:324-328): 64 uniform centres
    in [0.2, 0.8], Gaussian noise 0.05."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.2, 0.8, (N_CENTRES, f))
    rows = centres[rng.integers(0, N_CENTRES, n)]
    rows += rng.normal(0, NOISE, (n, f))
    return rows


def plant_duplicates(rows: np.ndarray) -> np.ndarray:
    """Overwrite rows with exact copies of rows 0 and 1 so that, at k=K,
    row 0 has depth+1 copies in each of MAX_FIRED+1 bins (its repair
    overflows to K3) and row 1 has depth+2 copies in one bin (the strided
    repair alone).  Row g lies in bin g mod bins.  Returns each row's
    canonical id, the lowest id of its duplicate group."""
    from arrowspace_torch.ops.bin_repair import MAX_FIRED
    from arrowspace_torch.ops.bintopk import (binned_topk_depth_for,
                                              bins_target)
    bins, depth = bins_target(K), binned_topk_depth_for(K)
    canon = np.arange(rows.shape[0])
    storms = [(0, b, depth + 1) for b in range(5, 5 + 12 * (MAX_FIRED + 1),
                                                12)] + [(1, 77, depth + 2)]
    for src, b, copies in storms:
        g = b + bins * (2 + np.arange(copies))
        rows[g] = rows[src]
        canon[g] = src
    return canon


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() over reps launches after one warm-up,
    timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, n_bytes: float, tf32_ops: float = 0.0,
          bf16_ops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for work
    of ``ops`` float32 operations on the CUDA cores and ``tf32_ops`` TF32
    (``bf16_ops`` bf16) operations on the tensor cores that must move
    ``n_bytes`` (each input read once, each output written once)."""
    t_ops = max(ops / PEAK_F32_FLOPS, tf32_ops / PEAK_TF32_FLOPS,
                bf16_ops / PEAK_BF16_FLOPS) * 1e3
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def matmul_ms(torch, a, b) -> float:
    """Time of the one torch.matmul a @ b.T inside a scoring kernel, as
    context for its time (no kernel of the port calls it)."""
    return cuda_ms(lambda: torch.matmul(a, b.T), reps=3)


def exact_scores(qhat, qlam, xhat, xlam, c1, ids):
    """Float64 shifted scores of the given (B, k) ids, from the prepared
    (α-prescaled unit) queries and the prepared corpus."""
    rows = xhat[ids].double()
    acos = (rows * qhat.double()[:, None, :]).sum(-1)
    dl = (qlam.double()[:, None] - xlam[ids].double()).abs().clamp_max(1.0)
    return acos - c1 * dl


def true_scores(queries, qlam, data, lam, ids):
    """Float64 λ-aware scores α·cos + (1-α)·(1-min(|Δλ|,1)) of the given
    (B, k) ids, from the raw queries and corpus."""
    from arrowspace_torch.ops.search import safe_unit
    q = safe_unit(queries.double())
    x = safe_unit(data[ids].double())
    cos = (x * q[:, None, :]).sum(-1)
    dl = (qlam.double()[:, None] - lam[ids].double()).abs().clamp_max(1.0)
    return ALPHA * cos + (1.0 - ALPHA) * (1.0 - dl)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def agree(name, s, i, ref_s, ref_i, exact=None, tol=TOL,
          quiet=False) -> float:
    """Hold (scores, ids), row by row, against a reference's.

    Scores lie within ``tol`` of the reference's and, when given, of the
    float64 scores of the returned ids (``exact``); they come best first,
    no id twice, and ids whose float64 scores are equal (identical rows)
    come in ascending order, the lowest-id tie rule.  Ids equal the
    reference's.  Where the two sides' scores are not bitwise equal their
    rounding differs, and an id may then stand elsewhere only where the
    reference's scores at both places lie within twice the largest score
    difference: a near-tie that rounding can reorder.  Returns the max
    abs score error."""
    s, i, ref_s, ref_i = (_host(t) for t in (s, i, ref_s, ref_i))
    s64, r64 = s.astype(np.float64), ref_s.astype(np.float64)
    err = float(np.abs(s64 - r64).max())
    check(err <= tol, f"{name}: score error {err} > {tol}")
    check(bool((np.diff(s64, axis=1) <= 0).all()),
          f"{name}: scores not best first")
    srt = np.sort(i, axis=1)
    check(bool((srt[:, 1:] != srt[:, :-1]).all()),
          f"{name}: repeated id in a row")
    if exact is not None:
        ex = _host(exact).astype(np.float64)
        ex_err = float(np.abs(ex - s64).max())
        check(ex_err <= tol, f"{name}: scores vs float64 {ex_err} > {tol}")
        tied = np.diff(ex, axis=1) == 0
        check(bool((np.diff(i, axis=1)[tied] > 0).all()),
              f"{name}: identical rows not in ascending id order")
    swaps = bad = 0
    for r, j in zip(*np.nonzero(i != ref_i)):
        pos = np.nonzero(ref_i[r] == i[r, j])[0]
        other = r64[r, pos[0]] if pos.size else r64[r, -1]
        if err > 0.0 and abs(other - r64[r, j]) <= 2.0 * err:
            swaps += 1
        else:
            bad += 1
    if not quiet:
        log(f"  {name}: max_abs_err={err:.3e} id_mismatches={bad} "
            f"near_tie_swaps={swaps}")
    check(bad == 0, f"{name}: {bad} ids differ from the reference's "
          "outside near-ties")
    return err


def log_clustering(torch, index, rows) -> None:
    """The build's host clustering seconds, and its Two-NN estimate: the
    card tile (timed inside the build, and again here) beside the host
    tiles on the same sample rows, whose estimates must be equal (the
    estimate bounds k_max).  Optimal K with the host tiles in place of
    the card tile is reckoned from the two timings of this run."""
    from arrowspace_torch import clustering as cl
    b = index.builder
    cs = b.clustering_seconds
    n, f = rows.shape
    seed = b.clustering_seed if b.clustering_seed is not None \
        else cl.CLUSTERING_SEED
    idx = cl._twonn_indices(n, seed)
    t0 = time.perf_counter()
    part_d = cl._twonn_two_smallest_device(index.aspace.data, idx)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    part_h = cl._twonn_two_smallest_host(rows, idx)
    t_host = time.perf_counter() - t0
    id_d, id_h = cl._twonn_dimension(part_d, f), cl._twonn_dimension(part_h, f)
    rel = float((np.abs(part_d - part_h)
                 / np.maximum(np.abs(part_h), 1e-6)).max())
    scan = "native" if b.deterministic_clustering else "chunked"
    log(f"  clustering: optimal_k_s={cs['optimal_k']:.3f} (twonn_s="
        f"{cs['twonn']:.3f} on the card) {scan}_scan_s={cs['scan']:.3f}")
    log(f"  Two-NN on {len(idx)} sample rows: card tile {t_dev:.3f}s "
        f"id={id_d}; host tiles {t_host:.3f}s id={id_h}; two smallest d² "
        f"max rel diff {rel:.3e}; optimal K with the host tiles "
        f"{cs['optimal_k'] - cs['twonn'] + t_host:.3f}s")
    check(id_d == id_h, f"Two-NN: card estimate {id_d} != host {id_h}")


def reset(counters) -> None:
    for c in counters.values():
        if hasattr(c, "launches"):
            c.launches = 0
        else:
            c.calls = 0


def check_lambdas(lam, canon, what) -> None:
    """λ of a build: finite, one per row, many distinct values, and equal
    for identical rows."""
    lam_h = lam.cpu().numpy()
    check(lam_h.shape == canon.shape and bool(np.isfinite(lam_h).all()),
          f"{what} λ not finite or wrong shape")
    n_distinct = int(np.unique(lam_h).size)
    log(f"  λ: min={lam_h.min():.6g} max={lam_h.max():.6g} "
        f"distinct={n_distinct}")
    check(n_distinct >= 1000, f"{what} λ nearly constant")
    check(bool((lam_h == lam_h[canon]).all()),
          f"identical rows got different {what} λ")


def serve(torch, counters, index, rows, canon, dev, seed, kernels,
          kind="binned"):
    """A SearchSession of the index, which must resolve ``kind``, warmed
    up, then fed 16 batches of perturbed corpus rows (×1.02), batch 0
    carrying the duplicated rows 0 and 1 (on the binned kernel the
    strided repair and K3).  The launch counts of ``kernels`` ({name:
    counter key}) are read right after the stream, before any check runs.
    Batch 0's first 256 rows are held against the plain full scan (matmul
    + stable sort) with the session's own query λ.  Returns (session,
    batches, launches, self-match rate, batch 0's ids, ms per batch)."""
    from arrowspace_torch.index import _query_prep
    from arrowspace_torch.ops.search import batched_lambda_aware_topk

    session = index.make_search_session(batch_size=BATCH, k=K, alpha=ALPHA)
    check(session.kernel == kind, f"session kernel {session.kernel}")
    session.warmup()
    repairs_warm = counters["repair"].calls
    rng = np.random.default_rng(seed)
    picks = [rng.integers(0, rows.shape[0], BATCH) for _ in range(N_BATCHES)]
    picks[0][:2] = (0, 1)
    batches = [rows[p] * 1.02 for p in picks]
    sync(torch, dev)
    t0 = time.perf_counter()
    results = list(session.search_stream(batches))
    sync(torch, dev)
    t_stream = time.perf_counter() - t0
    launches = {name: counters[key].launches for name, key in kernels.items()}
    repairs = counters["repair"].calls - repairs_warm
    log(f"  launches: {launches}; strided repairs in the stream: {repairs}")
    check(repairs > 0 or kind != "binned",
          "the stream repaired no flagged row")
    check(repairs == 0 or kind == "binned", "a merge session repaired")

    ms_batch = t_stream / N_BATCHES * 1e3
    self_hits = np.mean([float(np.mean(canon[r[1][:, 0]] == canon[p]))
                         for r, p in zip(results, picks)])
    log(f"  session: {N_BATCHES} batches of {BATCH}, ms_per_batch="
        f"{ms_batch:.3f}, queries_per_s={BATCH / ms_batch * 1e3:.1f}, "
        f"self_match_rate={self_hits}")
    check(all(r[0].shape == (BATCH, K) and np.isfinite(r[0]).all()
              for r in results), "session output shape/finiteness")

    a = index.aspace
    q = torch.as_tensor(batches[0][:256], device=dev, dtype=torch.float32)
    _, qlam = _query_prep(a, index.gl)[1](q)
    ps, pi = batched_lambda_aware_topk(q, qlam, a.data, a.lambdas, ALPHA,
                                       k=K)
    s0, i0 = results[0][0][:256], results[0][1][:256]
    agree("session vs plain full scan (256 queries)", s0, i0, ps, pi,
          exact=true_scores(q, qlam, a.data, a.lambdas,
                            torch.as_tensor(i0, device=dev)))
    return session, batches, launches, self_hits, i0, ms_batch


def main_path(torch, counters, rows, canon, dev):
    """The cosine path, through the user entry points: build, session,
    warm-up, stream.  The kernel counters are set to 0 just before the
    build and read right after the stream.  Returns the index, the
    session, the query batches and the launch counts."""
    from arrowspace_torch.index import ArrowIndex

    log(f"[2] cosine path: ArrowIndex.build {rows.shape[0]}x{rows.shape[1]} "
        f"eps={EPS} seed={SEED} on {dev}")
    reset(counters)
    t0 = time.perf_counter()
    index = ArrowIndex.build(rows, eps=EPS, seed=SEED, device=dev)
    sync(torch, dev)
    t_build = time.perf_counter() - t0
    st = index.builder.stage_seconds
    log(f"  build_s={t_build:.3f} clustering_s={st['clustering']:.3f} "
        f"laplacian_s={st['laplacian']:.3f} taumode_s={st['taumode']:.3f} "
        f"clusters={index.aspace.n_clusters} graph={tuple(index.gl.shape())}")
    log_clustering(torch, index, rows)

    session, batches, launches, self_hits, i0, _ = serve(
        torch, counters, index, rows, canon, dev, SEED + 1,
        {"bintopk": "k1", "taulambda": "k2", "merge_topk": "k3"})
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the cosine path never launched: {launches}")
    check(self_hits == 1.0, f"self-match rate {self_hits} != 1.0")
    check_lambdas(index.aspace.lambdas, canon, "cosine")
    log(f"  row 0 (3 overflowing bins, K3) top-{K}: {i0[0].tolist()}")
    log(f"  row 1 (1 fired bin, strided repair) top-{K}: {i0[1].tolist()}")
    return index, session, batches, launches


def tc_bounds(b: int, n: int, f: int, tail: int, n_bytes: int) -> tuple:
    """The two bounds of a tensor-core kernel (K1, K3, K6, K7): (bound_ms,
    bound_by) of the work its design does, the 3·2F TF32 products a pair
    on the tensor cores beside ``tail`` fp32 operations a pair of its
    score, and bound_fp32_ms, the whole 2F + tail a pair on the fp32 CUDA
    cores."""
    b_ms, b_by = bound(tail * b * n, n_bytes, tf32_ops=6.0 * b * n * f)
    return b_ms, b_by, bound(b * n * (2.0 * f + tail), n_bytes)[0]


def bf16_bounds(b: int, n: int, f: int, tail: int, n_bytes: int) -> tuple:
    """(bound_ms, bound_by) of K1's and K3's bf16 modes: the 2F bf16
    products a pair at the dense bf16 peak beside ``tail`` fp32
    operations a pair of the score, and the bytes."""
    return bound(tail * b * n, n_bytes, bf16_ops=2.0 * b * n * f)


def lambda_bounds(rows: int, n: int, f: int, n_bytes: int) -> tuple:
    """The two bounds of K2 and K5, whose five n×n quadratic forms a row
    run on the tensor cores as 3×TF32 (lambda_tile.cuh): (bound_ms,
    bound_by) of 3·10·n² TF32 operations a row beside the fp32 ones (x²
    over the row, the O(n) row terms and the fold: 2F + 18n), and
    bound_fp32_ms, the whole 10·n² + 2F + 18n a row on the CUDA cores."""
    tail = rows * (2.0 * f + 18.0 * n)
    b_ms, b_by = bound(tail, n_bytes, tf32_ops=30.0 * rows * n * n)
    return b_ms, b_by, bound(tail + 10.0 * rows * n * n, n_bytes)[0]


def lambda_f64_errors(x, lap, tau, *lams) -> list:
    """Each λ of ``lams`` against a float64 plain λ of the same rows and
    τ, relative where |λ| > 1, as the plain comparison is."""
    from arrowspace_torch.ops import lambda_batch as lb
    ref = lb.lambda_batch_plain(x.double(), lap.double(), tau.double())
    return [float(((lam.double() - ref).abs() / ref.abs().clamp_min(1.0))
                  .max()) for lam in lams]


def kernels_vs_plain(torch, index, batches, dev):
    """Each kernel against its plain version on the card, at the main
    path's shapes; returns the per-kernel records (without launches)."""
    from arrowspace_torch.ops import bintopk as bt
    from arrowspace_torch.ops import taulambda as tl
    from arrowspace_torch.ops.search import prepare_query

    log("[3] kernels against their plain versions on the card")
    aspace = index.aspace
    n = aspace.nitems
    xhat, xlam = bt.prepare_binned_corpus(aspace.data, aspace.lambdas)
    q = torch.as_tensor(batches[0], device=dev, dtype=torch.float32)
    qlam = aspace.prepare_query_items_batch(batches[0], index.gl)
    qhat, c1 = prepare_query(q, ALPHA, dtype=torch.float32)
    qlam = qlam.float().contiguous()
    rec = {}

    # K2 on the first 262144 rows against the build's Laplacian
    x = aspace.data[:TAULAMBDA_ROWS].contiguous()
    lap = index.gl.matrix
    lam_k, tau_k = tl.fused_taulambda(x, lap, aspace.taumode)
    lam_p, tau_p = tl.taulambda_plain(x, lap, aspace.taumode)
    err = float((lam_k - lam_p).abs().max())
    err64, plain64 = lambda_f64_errors(x, lap, tau_p, lam_k, lam_p)
    tau_eq = bool(torch.equal(tau_k, tau_p))
    n_distinct = int(torch.unique(lam_p).numel())
    log(f"  K2 taulambda {TAULAMBDA_ROWS}x{x.shape[1]}: λ max_abs_err="
        f"{err:.3e} (vs float64 {err64:.3e}; the plain float32 λ vs "
        f"float64 {plain64:.3e}), τ bitwise equal={tau_eq}; plain λ min="
        f"{float(lam_p.min()):.6g} max={float(lam_p.max()):.6g} "
        f"distinct={n_distinct}")
    check(n_distinct >= 1000, "K2 compared on nearly constant λ")
    check(err <= TOL and tau_eq, "K2 disagrees with its plain version")
    # the rows, τ and the graph read once (L, W and W2), λ and τ written
    nn, ff = lap.shape[0], x.shape[1]
    b_ms, b_by, b32_ms = lambda_bounds(
        x.shape[0], nn, ff, nbytes(x, lap, lam_k, tau_k) + 2 * nbytes(lap))
    rec["taulambda"] = dict(
        max_abs_err=err, max_abs_err_f64=err64,
        ms=cuda_ms(lambda: tl.fused_taulambda(x, lap, aspace.taumode)),
        plain_ms=cuda_ms(lambda: tl.taulambda_plain(x, lap,
                                                    aspace.taumode)),
        bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32_ms, library_ms=None)
    log(f"    K2: ms={rec['taulambda']['ms']:.3f} bound_ms={b_ms:.3f} "
        f"({b_by}) bound_fp32_ms={b32_ms:.3f}")
    # and at the shape the cosine build launches it: all rows, one launch
    xa = aspace.data
    lam_a, tau_a = tl.fused_taulambda(xa, lap, aspace.taumode)
    lam_p, tau_p = tl.taulambda_plain(xa, lap, aspace.taumode)
    err_a = float((lam_a - lam_p).abs().max())
    err64_a, plain64_a = lambda_f64_errors(xa, lap, tau_p, lam_a, lam_p)
    tau_eq = bool(torch.equal(tau_a, tau_p))
    log(f"  K2 taulambda at the build's {xa.shape[0]}x{ff}: λ max_abs_err="
        f"{err_a:.3e} (vs float64 {err64_a:.3e}; the plain float32 λ vs "
        f"float64 {plain64_a:.3e}), τ bitwise equal={tau_eq}")
    check(err_a <= TOL and tau_eq,
          "K2 disagrees with its plain version at the build's rows")
    rec["taulambda"]["max_abs_err"] = max(err, err_a)
    rec["taulambda"]["max_abs_err_f64"] = max(err64, err64_a)
    a_ms, a_by, a32_ms = lambda_bounds(
        xa.shape[0], nn, ff, nbytes(xa, lap, lam_a, tau_a) + 2 * nbytes(lap))
    rec["taulambda"]["at_build"] = dict(
        rows=xa.shape[0], max_abs_err=err_a, max_abs_err_f64=err64_a,
        ms=cuda_ms(lambda: tl.fused_taulambda(xa, lap, aspace.taumode)),
        plain_ms=cuda_ms(lambda: tl.taulambda_plain(xa, lap,
                                                    aspace.taumode), reps=3),
        bound_ms=a_ms, bound_by=a_by, bound_fp32_ms=a32_ms)
    log(f"    K2 at the build's rows: ms="
        f"{rec['taulambda']['at_build']['ms']:.3f} plain_ms="
        f"{rec['taulambda']['at_build']['plain_ms']:.3f} bound_ms="
        f"{a_ms:.3f} ({a_by}) bound_fp32_ms={a32_ms:.3f}")
    del lam_a, tau_a, lam_p, tau_p

    # K1 at k=10 (depth 3, bins 128) and k=64 (depth 4, bins 512)
    k1_err = 0.0
    for k in (K, 64):
        depth, bins = bt.binned_topk_depth_for(k), bt.bins_target(k)
        chunks = bt._default_chunks(bt.grid_ctas(BATCH, bins, qhat.shape[1]),
                                    -(-n // bins), q.device)
        args = (qhat, qlam, xhat, xlam, c1, n)
        kw = dict(depth=depth, bins=bins, chunks=chunks)
        out_k = bt.flush_pool(*bt.binned_topk_pool(*args, **kw), k, c1)
        out_p = bt.flush_pool(*bt.binned_topk_pool_plain(*args, **kw), k, c1)
        err = agree(f"K1 bintopk k={k} depth={depth} bins={bins} "
                    f"chunks={chunks}", out_k[0], out_k[1], out_p[0],
                    out_p[1], exact=exact_scores(qhat, qlam, xhat, xlam,
                                                 c1, out_k[1]) + c1)
        det_err = float((out_k[3] - out_p[3]).abs().max())
        log(f"    flags kernel={int(out_k[2].sum())} "
            f"plain={int(out_p[2].sum())} det max_abs_err={det_err:.3e}")
        check(det_err <= TOL, "K1 det disagrees")
        k1_err = max(k1_err, err, det_err)
        pool = bt.binned_topk_pool(*args, **kw)
        # K1's λ term: five fp32 operations a pair
        b_ms, b_by, b32_ms = tc_bounds(
            BATCH, n, qhat.shape[1], 5,
            nbytes(qhat, qlam, xhat[:n], xlam[:n], *pool))
        ms = cuda_ms(lambda: bt.binned_topk_pool(*args, **kw))
        log(f"    K1 k={k}: ms={ms:.3f} bound_ms={b_ms:.3f} ({b_by}) "
            f"bound_fp32_ms={b32_ms:.3f}")
        if k == K:
            rec["bintopk"] = dict(
                ms=ms, plain_ms=cuda_ms(lambda: bt.binned_topk_pool_plain(
                    *args, **kw), reps=2),
                bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32_ms,
                library_ms=None)
            log(f"    matmul context (qhat @ xhat.T, {BATCH}x{n}x"
                f"{qhat.shape[1]}): {matmul_ms(torch, qhat, xhat[:n]):.3f} ms")
    rec["bintopk"]["max_abs_err"] = k1_err

    # K3 at k=10 over the whole batch
    rec["merge_topk"] = k3_vs_plain(torch, qhat, qlam, xhat, xlam, c1, n,
                                    "K3 merge_topk")
    return rec


def k3_vs_plain(torch, qhat, qlam, xhat, xlam, c1, n, name):
    """K3 at k=K on these queries, at the wrapper's chunking: each (query,
    chunk) partial top-k held against its plain version as one row and
    its scores against float64; its time, the plain version's, its TF32
    and fp32 bounds (the 3·2F TF32 products
    and 5 fp32 operations of the λ term a pair; with bf16 operands the
    2F bf16 products, bf16_bounds) and torch.matmul's time for the
    product alone, as context."""
    from arrowspace_torch.ops import topk as tk
    bsz, f = qhat.shape
    bf16 = qhat.dtype == torch.bfloat16
    rows_pc = tk._chunk_rows(bsz, n, qhat.device, K, bf16, f)
    args = (qhat, qlam, xhat, xlam, c1, n)
    kw = dict(k=K, rows_per_chunk=rows_pc)
    s_k, i_k = tk.merge_topk_partial(*args, **kw)
    s_p, i_p = tk.merge_topk_partial_plain(*args, **kw)
    chunks = s_k.shape[1]
    err = agree(f"{name} B={bsz} F={f} k={K} rows_per_chunk={rows_pc} "
                f"chunks={chunks}", s_k.reshape(-1, K), i_k.reshape(-1, K),
                s_p.reshape(-1, K), i_p.reshape(-1, K),
                exact=exact_scores(qhat.repeat_interleave(chunks, 0),
                                   qlam.repeat_interleave(chunks, 0), xhat,
                                   xlam, c1, i_k.reshape(-1, K).long()))
    del s_p, i_p
    moved = nbytes(qhat, qlam, xhat[:n], xlam[:n], s_k, i_k)
    if bf16:
        (b_ms, b_by), b32_ms = bf16_bounds(bsz, n, f, 5, moved), None
    else:
        b_ms, b_by, b32_ms = tc_bounds(bsz, n, f, 5, moved)
    out = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               bound_fp32_ms=b32_ms, library_ms=None,
               ms=cuda_ms(lambda: tk.merge_topk_partial(*args, **kw),
                          reps=3),
               plain_ms=cuda_ms(lambda: tk.merge_topk_partial_plain(
                   *args, **kw), reps=2),
               matmul_ms=matmul_ms(torch, qhat, xhat[:n]))
    if bf16:
        del out["bound_fp32_ms"]
    b32 = "none" if b32_ms is None else f"{b32_ms:.3f}"
    log(f"    {name}: ms={out['ms']:.3f} plain_ms={out['plain_ms']:.3f} "
        f"bound_ms={b_ms:.3f} ({b_by}) bound_fp32_ms={b32} "
        f"matmul context ({bsz}x{n}x{f}, {qhat.dtype}) "
        f"{out['matmul_ms']:.3f} ms")
    return out


def energy_exact(zq, qlam, z, lam, ids):
    """Float64 energy scores w_D/(1+|z_q - z_g|) - w_λ·|λ_q - λ_g| of the
    given (B, k) ids, from the float32 z-plane."""
    d = zq.double()[:, None, :] - z[ids].double()
    num = (d * d).sum(-1).sqrt()
    dl = (qlam.double()[:, None] - lam[ids].double()).abs()
    return E_WD / (1.0 + num) - E_WL * dl - E_WD


def flag_flips(name, fl, rfl, s, det, err) -> int:
    """Flags (or certifications) of the kernel against the plain
    version's: a row may differ only where its k-th score and its largest
    det lie within twice the measured score error, a near-tie that
    another rounding of the product can turn.  Returns how many rows
    differ."""
    diff = (fl != rfl).cpu()
    if bool(diff.any()):
        gap = (s[:, -1] - det.amax(dim=1)).abs().cpu()
        check(float(gap[diff].max()) <= 2.0 * err,
              f"{name}: a row differs from the plain version's outside a "
              "near-tie")
    return int(diff.sum())


def d2_error(torch, zq, zx, pool, wd, rows: int = 512) -> tuple:
    """Max abs error of K7's pooled d² and of u = w_D/(1+√d²) from it,
    against float64 from the same float32 rows, over every live pool
    entry of the first ``rows`` queries."""
    from arrowspace_torch.ops.search import INT_MAX
    rows = min(rows, zq.shape[0])
    pi, pd = (t[:rows].reshape(rows, -1) for t in pool[1:3])
    live = pi != INT_MAX
    ids = torch.where(live, pi, torch.zeros_like(pi)).long()
    d = zq[:rows].double()[:, None, :] - zx[ids].double()
    d2 = (d * d).sum(-1)
    d2_err = float((pd.double() - d2)[live].abs().max())
    u = wd / (1.0 + pd.double().clamp_min(0.0).sqrt())
    u_err = float((u - wd / (1.0 + d2.sqrt()))[live].abs().max())
    return d2_err, u_err


def energy_stream(torch, session, batches, dev, counters):
    """Warm-up, then the stream.  Returns (results, ms per batch, and the
    stream's own counts, warm-up excluded: rows the engine re-ran, K6
    launches and strided energy repairs)."""
    session.warmup()
    before = (session.engine.flagged_rows, counters["k6"].launches,
              counters["erepair"].calls)
    sync(torch, dev)
    t0 = time.perf_counter()
    results = list(session.search_stream(batches))
    sync(torch, dev)
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    check(all(r[0].shape == (BATCH, K) and np.isfinite(r[0]).all()
              for r in results), "energy session output shape/finiteness")
    after = (session.engine.flagged_rows, counters["k6"].launches,
             counters["erepair"].calls)
    return results, ms, [b - a for a, b in zip(before, after)]


def energy_path(torch, counters, rows, canon, dev):
    """The energy path, through the user entry points: build_energy, then
    an exact EnergySearchSession and one with approx=True, each warmed up
    and fed the same 16 batches.  The counters are set to 0 just before
    the build with the exact session, and again just before the approx
    session, and read right after each stream.  Returns the index, the
    two sessions, the batches, the launch counts and the results."""
    from arrowspace_torch.energymaps import EnergyParams
    from arrowspace_torch.index import ArrowIndex

    log(f"[6] energy path: ArrowIndex.build_energy {rows.shape[0]}x"
        f"{rows.shape[1]} EnergyParams(allow_tall_graphs=True) seed={SEED}")
    reset(counters)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index = ArrowIndex.build_energy(rows, EnergyParams(allow_tall_graphs=True),
                                    seed=SEED, device=dev)
    sync(torch, dev)
    t_build = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    a, st = index.aspace, index.builder.stage_seconds
    x_nodes = index.gl.matrix.shape[0]
    log(f"  build_s={t_build:.3f} " + " ".join(
        f"{k}_s={v:.3f}" for k, v in st.items()))
    log(f"  clusters={a.n_clusters} reduced_dim={a.reduced_dim} X={x_nodes} "
        f"max_memory_allocated={peak / 2**30:.3f} GiB")
    log_clustering(torch, index, rows)
    build = {"select_tau": counters["k4"].launches,
             "taulambda": counters["k2"].launches}
    log(f"  build launches: {build}")
    check(build["select_tau"] >= 1, "the energy build never launched K4")
    check(build["taulambda"] == 0, "the tall energy build launched K2")
    check(a.reduced_dim is not None and a.reduced_dim < rows.shape[1],
          "the energy build did not project")
    check(x_nodes > a.reduced_dim, "the energy graph is not tall")
    check_lambdas(a.lambdas, canon, "energy")

    rng = np.random.default_rng(SEED + 2)
    picks = [rng.integers(0, rows.shape[0], BATCH) for _ in range(N_BATCHES)]
    picks[0][:2] = (0, 1)            # the duplicated rows: repair
    batches = [rows[p] * 1.02 for p in picks]

    exact = index.make_energy_session(batch_size=BATCH, k=K, w_lambda=E_WL,
                                      w_dirichlet=E_WD)
    check(exact.kernel == "binned", f"energy session kernel {exact.kernel}")
    res_e, ms_e, (flagged_e, _, repairs) = energy_stream(
        torch, exact, batches, dev, counters)
    launches = {"select_tau": build["select_tau"],
                "energy_bintopk": counters["k6"].launches}
    log(f"  exact session: ms_per_batch={ms_e:.3f} queries_per_s="
        f"{BATCH / ms_e * 1e3:.1f} K6 launches={launches['energy_bintopk']} "
        f"flagged rows={flagged_e} strided repairs in the stream={repairs}")
    check(launches["energy_bintopk"] >= N_BATCHES + 1,
          "K6 did not launch for every batch and the warm-up")
    check(repairs > 0, "the energy stream repaired no flagged row")

    reset(counters)
    approx = index.make_energy_session(batch_size=BATCH, k=K, w_lambda=E_WL,
                                       w_dirichlet=E_WD, approx=True)
    check(approx.kernel == "binned_approx",
          f"approx session kernel {approx.kernel}")
    res_a, ms_a, (flagged_a, fallback, _) = energy_stream(
        torch, approx, batches, dev, counters)
    launches["energy_chord"] = counters["k7"].launches
    cert = 1.0 - flagged_a / (N_BATCHES * BATCH)
    log(f"  approx session: ms_per_batch={ms_a:.3f} queries_per_s="
        f"{BATCH / ms_a * 1e3:.1f} K7 launches={launches['energy_chord']} "
        f"certified={cert:.6f} ({flagged_a} rows re-run exactly); K6 "
        f"launches as its fallback in the stream={fallback}")
    check(launches["energy_chord"] >= N_BATCHES + 1,
          "K7 did not launch for every batch and the warm-up")
    return index, exact, approx, batches, launches, res_e, res_a


def energy_vs_plain_scan(torch, index, exact, res_e, res_a, batches, dev):
    """Both sessions' first 256 rows of batch 0, the duplicated rows 0 and
    1 among them, against the plain chunked scan on the session's own
    prepared queries and plane (the engine serves the z-plane centred on
    its mean), and against float64 on the raw plane.  The plain scan of
    the raw plane is logged beside them: its own float32 error."""
    from arrowspace_torch.ops.energy_bintopk import energy_topk_chunked
    a, eng = index.aspace, exact.engine
    q = torch.as_tensor(batches[0][:256], device=dev, dtype=torch.float32)
    zq, qlam = exact.prepare(q)
    z = a.projected_items()
    ps, pi = energy_topk_chunked(eng.centred(zq), qlam, eng.zx[:eng.n],
                                 eng.xlam[:eng.n], E_WL, E_WD, k=K)
    for name, res in (("exact", res_e), ("approx", res_a)):
        s0, i0 = res[0][0][:256], res[0][1][:256]
        agree(f"energy {name} session vs plain chunked scan (256 queries)",
              s0, i0, ps, pi, tol=E_TOL,
              exact=energy_exact(zq, qlam, z, a.lambdas,
                                 torch.as_tensor(i0, device=dev)))
    rs, ri = energy_topk_chunked(zq, qlam, z, a.lambdas, E_WL, E_WD, k=K)
    raw_err = float((energy_exact(zq, qlam, z, a.lambdas, ri) - rs).abs()
                    .max())
    log(f"  plain chunked scan of the raw (uncentred) plane vs float64: "
        f"max_abs_err={raw_err:.3e}")
    log(f"  row 0 top-{K}: {res_e[0][1][0].tolist()}")
    log(f"  row 1 top-{K}: {res_e[0][1][1].tolist()}")


def k4_vs_plain(torch, x, mode):
    """K4 against its plain version (the row sort) on the rows x, as a
    build's λ pass hands them to it: τ bitwise equal; returns its record
    (without launches), torch.nanquantile's time beside it."""
    from arrowspace_torch.ops import select_tau as st

    tau_k = st.fused_select_tau(x, mode)
    tau_p = st.select_tau_plain(x, mode)
    tau_eq = bool(torch.equal(tau_k, tau_p))
    log(f"  K4 select_tau {tuple(x.shape)} {mode.kind}: τ bitwise equal="
        f"{tau_eq}")
    check(tau_eq, "K4 disagrees with its plain version")
    lib = None
    if mode.kind == "median":        # finite rows: the same order statistic
        lib_tau = torch.nanquantile(x, 0.5, dim=1)
        log(f"    torch.nanquantile(x, 0.5, dim=1) vs K4: max_abs_diff="
            f"{float((lib_tau - tau_k).abs().max()):.3e}")
        lib = cuda_ms(lambda: torch.nanquantile(x, 0.5, dim=1), reps=3)
    # the rows read once and τ written once; one comparison a value
    b_ms, b_by = bound(float(x.numel()), nbytes(x, tau_k))
    rec = dict(
        max_abs_err=float((tau_k - tau_p).abs().max()),
        ms=cuda_ms(lambda: st.fused_select_tau(x, mode), reps=20),
        plain_ms=cuda_ms(lambda: st.select_tau_plain(x, mode), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    log(f"    K4: ms={rec['ms']:.3f} plain_ms={rec['plain_ms']:.3f} "
        f"bound_ms={b_ms:.3f} ({b_by}) library_ms="
        f"{lib if lib is None else round(lib, 3)}")
    return rec


def energy_kernels_vs_plain(torch, index, exact, approx, batches, dev):
    """K4, K6 and K7 against their plain versions on the card, at the
    energy path's shapes; returns the per-kernel records (without
    launches)."""
    from arrowspace_torch.ops import bintopk as bt
    from arrowspace_torch.ops import energy_approx as ea
    from arrowspace_torch.ops import energy_bintopk as eb

    log("[7] energy kernels against their plain versions on the card")
    a, rec = index.aspace, {}

    # K4 over the corpus, as the build's λ pass calls it
    rec["select_tau"] = k4_vs_plain(torch, a.data, a.taumode)

    # K6 and K7 call rsqrtf; their plain versions call torch.rsqrt
    v = torch.logspace(-37.0, 38.0, 1 << 20, device=dev)
    rsqrt_eq = bool(torch.equal(eb.rsqrt_probe(v), torch.rsqrt(v)))
    log(f"  rsqrtf (CUDA) vs torch.rsqrt over 2^20 values in [1e-37, 1e38]: "
        f"bitwise equal={rsqrt_eq}")
    check(rsqrt_eq, "rsqrtf and torch.rsqrt differ")

    # K6 and K7 on batch 0, over each session's prepared corpus (the
    # z-plane centred on its mean, as the engine serves it)
    q = torch.as_tensor(batches[0], device=dev, dtype=torch.float32)
    eng = exact.engine
    zq, qlam = exact.prepare(q)
    zq, qlam = eng.centred(zq).contiguous(), qlam.contiguous()
    qn = (zq * zq).sum(dim=1)
    n, g = eng.n, zq.shape[1]
    depth, bins = bt.binned_topk_depth_for(K), bt.bins_target(K)
    z_n = eng.zx[:n]
    chunks = bt._default_chunks(eb.energy_grid_ctas(BATCH, bins, g,
                                                    eb.K6_PAIRS),
                                -(-n // bins), dev)
    args = (zq, qn, qlam, eng.zx, eng.xn, eng.xlam, eng.wl, eng.wd, n)
    kw = dict(depth=depth, bins=bins, chunks=chunks)
    pool = eb.binned_energy_pool(*args, **kw)
    out_k = bt.flush_pool(*pool, K, -eng.wd)
    out_p = bt.flush_pool(*eb.binned_energy_pool_plain(*args, **kw), K,
                          -eng.wd)
    err = agree(f"K6 energy_bintopk k={K} depth={depth} bins={bins} "
                f"chunks={chunks}", out_k[0], out_k[1], out_p[0], out_p[1],
                tol=E_TOL, exact=energy_exact(zq, qlam, z_n, eng.xlam,
                                              out_k[1]))
    det_err = float((out_k[3] - out_p[3]).abs().max())
    flips = flag_flips("K6 flags", out_k[2], out_p[2], out_k[0], out_k[3],
                       err)
    log(f"    flags kernel={int(out_k[2].sum())} plain={int(out_p[2].sum())} "
        f"rows differing (near-ties)={flips} det max_abs_err={det_err:.3e}")
    check(det_err <= E_TOL, "K6 det disagrees")
    log(f"    matmul context (zq @ z.T, {BATCH}x{n}x{g}): "
        f"{matmul_ms(torch, zq, z_n):.3f} ms")
    # per pair: d² (3), clamp (2), two rsqrt and four roundings of the
    # tail (6), the λ term (4)
    b_ms, b_by, b32_ms = tc_bounds(
        BATCH, n, g, 15, nbytes(zq, qn, qlam, z_n, eng.xn[:n],
                                eng.xlam[:n], *pool))
    ms = cuda_ms(lambda: eb.binned_energy_pool(*args, **kw))
    log(f"    K6: ms={ms:.3f} bound_ms={b_ms:.3f} ({b_by}) "
        f"bound_fp32_ms={b32_ms:.3f}")
    rec["energy_bintopk"] = dict(
        max_abs_err=max(err, det_err), ms=ms,
        plain_ms=cuda_ms(lambda: eb.binned_energy_pool_plain(*args, **kw),
                         reps=2),
        bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32_ms, library_ms=None)

    ap = approx.engine
    ca, cb = ea._fit_chords(zq, qn, ap.z_samp, ap.xn_samp, ap.wd)
    chunks = bt._default_chunks(eb.energy_grid_ctas(BATCH, bins, g,
                                                    ea.K7_PAIRS),
                                -(-n // bins), dev)
    args = (zq, qn, qlam, ca, cb, ap.zx, ap.xn, ap.xlam, ap.wl, n)
    kw = dict(depth=depth, bins=bins, chunks=chunks)
    pool = ea.binned_energy_approx_pool(*args, **kw)
    pool_p = ea.binned_energy_approx_pool_plain(*args, **kw)
    same = pool[1] == pool_p[1]      # slots holding the same row
    d2_err = float((pool[2] - pool_p[2])[same].abs().max())
    d2_64, u_64 = d2_error(torch, zq, ap.zx, pool, ap.wd)
    log(f"    K7 pooled d² against float64 (first 512 queries, every live "
        f"entry): d² max_abs_err={d2_64:.3e}, u = w_D/(1+√d²) "
        f"max_abs_err={u_64:.3e}")
    check(u_64 <= E_TOL, "K7's d² misses the energy tolerance")
    out_k = ea._flush_rescore_certify(*pool, qlam, ap.xlam, ap.wl, ap.wd, K)
    out_p = ea._flush_rescore_certify(*pool_p, qlam, ap.xlam, ap.wl, ap.wd,
                                      K)
    err = agree(f"K7 energy_chord k={K} depth={depth} bins={bins} "
                f"chunks={chunks}", out_k[0], out_k[1], out_p[0], out_p[1],
                tol=E_TOL, exact=energy_exact(zq, qlam, z_n, ap.xlam,
                                              out_k[1]))
    det_err = float((pool[3] - pool_p[3]).abs().max())
    flips = flag_flips("K7 certification", out_k[2], out_p[2], out_k[0],
                       pool[3].reshape(BATCH, -1) - ap.wd, err)
    log(f"    uncertified kernel={int(out_k[2].sum())} "
        f"plain={int(out_p[2].sum())} rows differing (near-ties)={flips} "
        f"det max_abs_err={det_err:.3e} pooled d² vs plain (slots "
        f"holding the same row) max_abs_err={d2_err:.3e}")
    check(det_err <= E_TOL, "K7 det disagrees")
    # per pair: d² (3), two chords and their max (6), the λ term (4)
    b_ms, b_by, b32_ms = tc_bounds(
        BATCH, n, g, 13, nbytes(zq, qn, qlam, ca, cb, z_n, ap.xn[:n],
                                ap.xlam[:n], *pool))
    ms = cuda_ms(lambda: ea.binned_energy_approx_pool(*args, **kw))
    log(f"    K7: ms={ms:.3f} bound_ms={b_ms:.3f} ({b_by}) "
        f"bound_fp32_ms={b32_ms:.3f}")
    rec["energy_chord"] = dict(
        max_abs_err=max(err, det_err), ms=ms,
        plain_ms=cuda_ms(lambda: ea.binned_energy_approx_pool_plain(
            *args, **kw), reps=2),
        bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32_ms, library_ms=None)
    return rec


def wide_path(torch, counters, dev):
    """The wide projected path, through the user entry points: a seeded
    build with dims_reduction=True on 1M x 768 rows, then a SearchSession,
    warmed up and fed 16 batches.  The counters are set to 0 just before
    the build and read right after the stream.  Returns the index, the
    session, the batches and the launch counts."""
    from arrowspace_torch.index import ArrowIndex

    log(f"[9] wide projected path: ArrowIndex.build {W_ROWS}x{W_FEAT} "
        f"eps={EPS} dims_reduction=True seed={SEED} on {dev}")
    t0 = time.perf_counter()
    rows = clustered_rows(W_ROWS, W_FEAT, SEED)
    canon = plant_duplicates(rows)
    log(f"  corpus made in {time.perf_counter() - t0:.3f}s")
    reset(counters)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index = ArrowIndex.build(rows, eps=EPS, dims_reduction=True, seed=SEED,
                             device=dev)
    sync(torch, dev)
    t_build = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    a, st = index.aspace, index.builder.stage_seconds
    lap = index.gl.matrix
    n = lap.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=lap.device)
    edges = int(((lap != 0) & ~eye).sum()) // 2
    log(f"  build_s={t_build:.3f} " + " ".join(
        f"{k}_s={v:.3f}" for k, v in st.items()))
    log(f"  clusters={a.n_clusters} reduced_dim={a.reduced_dim} graph="
        f"{n}x{n} edges={edges} max_memory_allocated="
        f"{peak / 2**30:.3f} GiB")
    log_clustering(torch, index, rows)
    check(a.reduced_dim == n and 2 * n <= W_FEAT,
          f"the wide build's graph is {n} nodes, not a JL graph of at most "
          f"F/2 = {W_FEAT // 2}")
    check(edges > 0, "the wide build's feature graph has no edge")

    session, batches, launches, _, i0, _ = serve(
        torch, counters, index, rows, canon, dev, SEED + 3,
        {"select_tau": "k4", "lambda_batch": "k5", "taulambda": "k2",
         "bintopk": "k1", "merge_topk": "k3"})
    check(launches["select_tau"] == 2 and launches["lambda_batch"] == 2,
          "the wide build did not take K4 and K5 in each of its two windows")
    check(launches["taulambda"] == 0, "the wide build launched K2")
    check(launches["bintopk"] == N_BATCHES + 1,
          "K1 did not launch once for every batch and the warm-up")
    check(launches["merge_topk"] >= 1, "batch 0's repair never reached K3")
    check_lambdas(a.lambdas, canon, "wide")
    log(f"  row 0 top-{K}: {i0[0].tolist()}")
    return index, session, batches, launches


def k5_vs_plain(torch, a, lap, win, name):
    """K5 against its plain version on the first row window of the build
    ``a`` (``win`` rows, the shape the build gives it), τ from the build's
    selection; returns its record (without launches)."""
    from arrowspace_torch.ops import lambda_batch as lb
    from arrowspace_torch.taumode import select_tau_batch

    x = a.data[:win]
    n, f = lap.shape[0], x.shape[1]
    tau = select_tau_batch(x, a.taumode)
    lam_k = lb.fused_lambda_batch(x, lap, tau)
    lam_p = lb.lambda_batch_plain(x, lap, tau)
    err = float(((lam_k - lam_p).abs() / lam_p.abs().clamp_min(1.0)).max())
    err64, plain64 = lambda_f64_errors(x, lap, tau, lam_k, lam_p)
    n_distinct = int(torch.unique(lam_p).numel())
    log(f"  {name} {win}x{f}, n={n}: λ max_abs_err={err:.3e} (vs float64 "
        f"{err64:.3e}; the plain float32 λ vs float64 {plain64:.3e}); plain "
        f"λ distinct={n_distinct}; K5 λ equals the build's: "
        f"{bool(torch.equal(lam_k, a.lambdas[:win]))}")
    check(n_distinct >= 1000, f"{name} compared on nearly constant λ")
    check(err <= TOL, f"{name} disagrees with its plain version")
    # the rows, τ and the graph (L, W and W2) read once, λ written once
    b_ms, b_by, b32_ms = lambda_bounds(
        win, n, f, nbytes(x, tau, lam_k) + 3 * nbytes(lap))
    rec = dict(
        max_abs_err=err, max_abs_err_f64=err64,
        ms=cuda_ms(lambda: lb.fused_lambda_batch(x, lap, tau)),
        plain_ms=cuda_ms(lambda: lb.lambda_batch_plain(x, lap, tau), reps=3),
        bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32_ms, library_ms=None)
    log(f"    {name}: ms={rec['ms']:.3f} plain_ms={rec['plain_ms']:.3f} "
        f"bound_ms={b_ms:.3f} ({b_by}) bound_fp32_ms={b32_ms:.3f}")
    return rec


def wide_kernels_vs_plain(torch, index, batches, dev):
    """K4 and K5 against their plain versions at the wide build's first
    row window (the shape the build gives them), K1 at F = 768 on batch
    0, and K3 at the shape batch 0's repair hands it (row 0, whose fired
    bins overflow); returns K5's record (without launches), K3's at that
    shape and K4's at the window."""
    from arrowspace_torch.config import TAUMODE_WINDOW_BYTES
    from arrowspace_torch.ops import bintopk as bt
    from arrowspace_torch.ops import lambda_batch as lb
    from arrowspace_torch.ops.search import prepare_query

    log("[10] wide-path kernels against their plain versions on the card")
    a = index.aspace
    win = TAUMODE_WINDOW_BYTES // (W_FEAT * 4) >> 14 << 14
    lap = index.gl.matrix
    n = lap.shape[0]
    k4 = k4_vs_plain(torch, a.data[:win], a.taumode)
    rec = {"lambda_batch": k5_vs_plain(torch, a, lap, win, "K5 lambda_batch")}
    x = a.data[:win]
    xn = x[:, :n].contiguous()
    ops = lb.graph_operands(lap, torch.float32)[:3]
    five = (ops[0], ops[1], ops[2], ops[2], ops[2])
    log(f"    context: the five cuBLAS products of the plain version "
        f"({win}x{n} @ {n}x{n}): "
        f"{cuda_ms(lambda: [xn @ m.T for m in five], reps=3):.3f} ms")

    # K1 at F = 768, k=10, on batch 0 against the session's prepared corpus
    q = torch.as_tensor(batches[0], device=dev, dtype=torch.float32)
    xhat, xlam = bt.prepare_binned_corpus(a.data, a.lambdas)
    qlam = a.prepare_query_items_batch(batches[0], index.gl).float()
    qhat, c1 = prepare_query(q, ALPHA, dtype=torch.float32)
    rows = a.nitems
    depth, bins = bt.binned_topk_depth_for(K), bt.bins_target(K)
    chunks = bt._default_chunks(bt.grid_ctas(BATCH, bins, W_FEAT),
                                -(-rows // bins), q.device)
    args = (qhat, qlam.contiguous(), xhat, xlam, c1, rows)
    kw = dict(depth=depth, bins=bins, chunks=chunks)
    out_k = bt.flush_pool(*bt.binned_topk_pool(*args, **kw), K, c1)
    out_p = bt.flush_pool(*bt.binned_topk_pool_plain(*args, **kw), K, c1)
    agree(f"K1 bintopk F={W_FEAT} k={K} chunks={chunks}", out_k[0],
          out_k[1], out_p[0], out_p[1],
          exact=exact_scores(qhat, qlam, xhat, xlam, c1, out_k[1]) + c1)
    b1_ms, b1_by, b32_ms = tc_bounds(
        BATCH, rows, W_FEAT, 5, nbytes(qhat, qlam, xhat[:rows], xlam[:rows],
                                       *bt.binned_topk_pool(*args, **kw)))
    k1_ms = cuda_ms(lambda: bt.binned_topk_pool(*args, **kw), reps=3)
    log(f"    K1 at F={W_FEAT}: ms={k1_ms:.3f} bound_ms={b1_ms:.3f} "
        f"({b1_by}) bound_fp32_ms={b32_ms:.3f}")
    k3 = k3_vs_plain(torch, qhat[:1].contiguous(), qlam[:1].contiguous(),
                     xhat, xlam, c1, rows, "K3 at the wide repair's shape")
    return rec, k3, k4


def host_peak_gib() -> float:
    """This process's peak resident host memory so far, GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def x_path(torch, counters, dev):
    """The 1536-wide projected path, through the user entry points: a
    seeded build with dims_reduction=True on 1M x 1536 rows, then a
    SearchSession, which must resolve "merge" (F is above K1's gate),
    warmed up and fed 16 batches.  The counters are set to 0 just before
    the build and read right after the stream.  Returns the index, the
    session, the batches, the launch counts and the ms per batch."""
    from arrowspace_torch.config import TAUMODE_WINDOW_BYTES
    from arrowspace_torch.index import ArrowIndex
    from arrowspace_torch.ops.select_tau import select_tau_fits

    log(f"[12] 1536-wide projected path: ArrowIndex.build {X_ROWS}x"
        f"{X_FEAT} eps={EPS} dims_reduction=True seed={SEED} on {dev}")
    t0 = time.perf_counter()
    rows = clustered_rows(X_ROWS, X_FEAT, SEED)
    canon = plant_duplicates(rows)
    log(f"  corpus made in {time.perf_counter() - t0:.3f}s; host peak "
        f"{host_peak_gib():.3f} GiB")
    reset(counters)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index = ArrowIndex.build(rows, eps=EPS, dims_reduction=True, seed=SEED,
                             device=dev)
    sync(torch, dev)
    t_build = time.perf_counter() - t0
    a, st = index.aspace, index.builder.stage_seconds
    n = index.gl.matrix.shape[0]
    log(f"  build_s={t_build:.3f} " + " ".join(
        f"{k}_s={v:.3f}" for k, v in st.items()))
    log(f"  λ pass (τ by K4, λ by K5, in row windows): "
        f"{st['taumode']:.3f} s")
    log(f"  clusters={a.n_clusters} reduced_dim={a.reduced_dim} graph="
        f"{n}x{n} max_memory_allocated="
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB host peak "
        f"{host_peak_gib():.3f} GiB")
    log_clustering(torch, index, rows)
    check(a.reduced_dim == n and 2 * n <= X_FEAT,
          f"the 1536-wide build's graph is {n} nodes, not a JL graph")

    session, batches, launches, _, i0, ms = serve(
        torch, counters, index, rows, canon, dev, SEED + 4,
        {"select_tau": "k4", "lambda_batch": "k5", "taulambda": "k2",
         "bintopk": "k1", "merge_topk": "k3"}, kind="merge")
    # λ runs in row windows; τ takes K4 where its gate admits F (a row in
    # one warp's registers), else the sort; λ then takes K5
    win = max(1 << 14, TAUMODE_WINDOW_BYTES // (X_FEAT * 4) >> 14 << 14)
    windows = -(-X_ROWS // win)
    k4 = windows if select_tau_fits(X_FEAT) else 0
    check(launches["select_tau"] == k4
          and launches["lambda_batch"] == windows,
          f"the 1536-wide build's {windows} windows did not take K4 "
          f"{k4} times and K5 {windows} times")
    check(launches["taulambda"] == 0 and launches["bintopk"] == 0,
          "the 1536-wide path launched K2 or K1")
    check(launches["merge_topk"] == N_BATCHES + 1,
          "K3 did not launch once for every batch and the warm-up")
    check_lambdas(a.lambdas, canon, "1536-wide")
    log(f"  row 0 top-{K}: {i0[0].tolist()}")
    return index, session, batches, launches, ms


def x_plain_session(torch, index, batches, dev):
    """A "plain" session (the full product + stable sort) of the same
    index, the gate's other option at this width, timed over
    X_PLAIN_BATCHES batches after its warm-up.  The session is made
    through make_search_session with the gate answering "plain"."""
    import arrowspace_torch.index as index_mod
    gate = index_mod.session_kernel_kind
    index_mod.session_kernel_kind = lambda *a: "plain"
    try:
        plain = index.make_search_session(batch_size=BATCH, k=K,
                                          alpha=ALPHA)
    finally:
        index_mod.session_kernel_kind = gate
    check(plain.kernel == "plain", f"plain session kernel {plain.kernel}")
    plain.warmup()
    sync(torch, dev)
    t0 = time.perf_counter()
    list(plain.search_stream(batches[:X_PLAIN_BATCHES]))
    sync(torch, dev)
    ms = (time.perf_counter() - t0) / X_PLAIN_BATCHES * 1e3
    log(f"  plain session: {X_PLAIN_BATCHES} batches of {BATCH}, "
        f"ms_per_batch={ms:.3f}")
    return plain, ms


def x_kernels_vs_plain(torch, index, batches, dev):
    """K4 and K5 against their plain versions at the 1536-wide build's
    first row window, and K3 on batch 0 at 1M x 1536 (the session's
    prepared corpus); returns their records (without launches)."""
    from arrowspace_torch.config import TAUMODE_WINDOW_BYTES
    from arrowspace_torch.ops import bintopk as bt
    from arrowspace_torch.ops.search import prepare_query

    log("[13] K4, K5 and K3 against their plain versions at 1536 on the "
        "card")
    a = index.aspace
    win = max(1 << 14, TAUMODE_WINDOW_BYTES // (X_FEAT * 4) >> 14 << 14)
    k4 = k4_vs_plain(torch, a.data[:win], a.taumode)
    k5 = k5_vs_plain(torch, a, index.gl.matrix, win, "K5 lambda_batch")
    q = torch.as_tensor(batches[0], device=dev, dtype=torch.float32)
    xhat, xlam = bt.prepare_binned_corpus(a.data, a.lambdas)
    qlam = a.prepare_query_items_batch(batches[0], index.gl).float()
    qhat, c1 = prepare_query(q, ALPHA, dtype=torch.float32)
    return k4, k5, k3_vs_plain(torch, qhat, qlam.contiguous(), xhat, xlam,
                               c1, a.nitems, "K3 merge_topk")


def where_time_goes(torch, sessions, batches, step,
                    n_batches=N_PROFILE, drive=None) -> None:
    """Device time by kernel over the first ``n_batches`` batches of
    each session (torch.profiler), and the device's idle share of that
    window: 1 - (summed kernel time) / wall time.  ``drive(session,
    batches)`` serves the batches (default: the session's stream).  A
    measurement only: where the profiler records no device time it
    prints so."""
    from torch.profiler import ProfilerActivity, profile
    log(f"[{step}] where the time goes (torch.profiler)")
    for name, session in sessions:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if drive is None:
                list(session.search_stream(batches[:n_batches]))
            else:
                drive(session, batches[:n_batches])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA]
        busy = {e.key: getattr(e, "self_device_time_total", 0.0)
                for e in kernels}
        total = sum(busy.values())
        if total <= 0.0:
            log(f"  {name}: no device time recorded (not measured)")
            continue
        log(f"  {name}: {n_batches} batches, wall {wall_us / 1e3:.3f} ms, "
            f"device busy {total / 1e3:.3f} ms, idle share "
            f"{1.0 - total / wall_us:.4f}")
        for key, us in sorted(busy.items(), key=lambda kv: -kv[1])[:6]:
            log(f"    {us / 1e3 / n_batches:9.3f} ms/batch  "
                f"{100.0 * us / total:5.1f} %  {key[:90]}")


def small_reference(torch, dev):
    """A small seeded build on the card against the same build in float64
    on the CPU: same clustering, λ within 1e-4, scores within 1e-4 and
    ids equal outside near-ties."""
    from arrowspace_torch.index import ArrowIndex
    rows = clustered_rows(4000, 32, SEED)
    gpu = ArrowIndex.build(rows, eps=1.0, seed=SEED, device=dev)
    cpu = ArrowIndex.build(rows, eps=1.0, seed=SEED, device="cpu",
                           dtype=torch.float64)
    check(gpu.aspace.n_clusters == cpu.aspace.n_clusters,
          "small build: cluster counts differ")
    err = float(np.abs(gpu.lambdas - cpu.lambdas).max())
    log(f"[5] small reference (4000x32, card f32 vs CPU f64): "
        f"λ max_abs_err={err:.3e}")
    check(err <= 1e-4, "small reference: λ disagrees")
    q = rows[:32] * 1.02
    gs, gi = gpu.search(q, k=K, alpha=ALPHA)
    cs, ci = cpu.search(q, k=K, alpha=ALPHA)
    agree("small reference search", gs, gi, cs, ci, tol=1e-4)


def topk_by_score(score, k):
    """The k ids of the largest scores, ties to the lowest id."""
    kth = np.partition(score, score.shape[0] - k)[score.shape[0] - k]
    cand = np.nonzero(score >= kth)[0]
    return cand[np.lexsort((cand, -score[cand]))][:k]


def hybrid_plain64(q, qlam, xunit, lam, k):
    """The hybrid union in float64 on the host (the reference expression,
    ties to the lowest id): (every item's effective score, the k ids,
    cos, the blended score, the k-th blended score of the λ-aware
    top-k)."""
    qn = np.linalg.norm(q)
    cos = xunit @ (q / qn if qn > 0 else q)
    blend = ALPHA * cos + (1.0 - ALPHA) * (1.0 - np.minimum(
        np.abs(qlam - lam), 1.0))
    top = topk_by_score(blend, k)
    eff = np.full(cos.shape[0], -np.inf)
    sem = int(np.argmax(cos))
    eff[sem] = cos[sem]
    eff[top] = blend[top]
    high = cos > 0.9999
    eff[high] = cos[high]
    return eff, topk_by_score(eff, k), cos, blend, blend[top[-1]]


def api_phase(torch, counters, index, batches, dev):
    """The search and mutation API on the seeded cosine index, after its
    session has run: search_hybrid against a float64 plain hybrid on
    host_rows (the same query λ), range on three λ bands against a numpy
    filter, add_items / mul_items / scale_item with the one-row λ refresh
    against recompute_lambdas (one K2 launch, counted), a search for a
    mutated row, f64_rescore refused after mutation, stats and warmup."""
    a, gl = index.aspace, index.gl
    log("[4a] search and mutation API on the seeded cosine index")

    # hybrid: ids equal outside near-ties of the blended score and of the
    # 0.9999 threshold (within twice the measured score error)
    host = a.host_rows
    xunit = host / np.maximum(np.linalg.norm(host, axis=1), 1e-300)[:, None]
    lam = a.lambdas.double().cpu().numpy()
    qs = batches[0][:64]
    t0 = time.perf_counter()
    got = [index.search_hybrid(q, k=K, alpha=ALPHA) for q in qs]
    t_hyb = (time.perf_counter() - t0) / len(qs) * 1e3
    refs = [hybrid_plain64(q, a.prepare_query_item(q, gl), xunit, lam, K)
            for q in qs]
    err = max(abs(sc - ref[0][i]) for g, ref in zip(got, refs)
              for i, sc in g if np.isfinite(ref[0][i]))
    check(err <= TOL, f"hybrid: score error {err} > {TOL}")
    tol = 2.0 * max(err, 1e-12)
    swaps = 0
    for g, (eff, ids, cos, blend, kth) in zip(got, refs):
        for j, (i, _sc) in enumerate(g):
            r = int(ids[j])
            if i == r:
                continue
            edge = any(abs(blend[x] - kth) <= tol
                       or abs(cos[x] - 0.9999) <= tol for x in (i, r))
            check(edge or abs(eff[i] - eff[r]) <= tol,
                  f"hybrid: id {i} at {j} differs from the float64 union's "
                  f"{r} outside a near-tie")
            swaps += 1
    log(f"  search_hybrid: 64 queries, {t_hyb:.3f} ms a query, "
        f"max_abs_err={err:.3e} near_tie_swaps={swaps}")

    # range: three bands, exact against a numpy filter of the λ
    qtl = np.quantile(lam, [0.0, 0.05, 0.45, 0.55, 0.9, 1.0])
    for lo, hi in ((qtl[0], qtl[1]), (qtl[2], qtl[3]), (qtl[4], qtl[5])):
        hits = index.range(float(lo), float(hi))
        sel = np.nonzero((lam >= lo) & (lam <= hi))[0]
        sel = sel[np.lexsort((sel, lam[sel]))]
        check([i for i, _ in hits] == sel.tolist()
              and [v for _, v in hits] == lam[sel].tolist(),
              f"range [{lo}, {hi}] differs from the numpy filter")
        log(f"  range [{lo:.6g}, {hi:.6g}]: {len(hits)} items, equal to "
            f"the numpy filter")

    # mutation: three rows, the one-row refresh against the full recompute
    n = a.nitems
    rows_m = {"add_items": (n // 8 + 7, 5 * n // 8 + 3),
              "mul_items": (n // 4 + 11, 3 * n // 4 + 5),
              "scale_item": (n // 3 + 13, 1.5)}
    before = a.lambdas.clone()
    for op, (i, arg) in rows_m.items():
        getattr(a, op)(i, arg, gl)
    touched = torch.zeros(a.nitems, dtype=torch.bool, device=dev)
    touched[[i for i, _ in rows_m.values()]] = True
    check(bool(torch.equal(a.lambdas[~touched], before[~touched])),
          "a mutation moved an untouched row's λ")
    refreshed = a.lambdas[touched].clone()
    reset(counters)
    t0 = time.perf_counter()
    a.recompute_lambdas(gl)
    sync(torch, dev)
    t_rec = time.perf_counter() - t0
    k2 = counters["k2"].launches
    lam_err = float((refreshed - a.lambdas[touched]).abs().max())
    log(f"  add_items, mul_items, scale_item on rows "
        f"{[i for i, _ in rows_m.values()]}: one-row λ refresh vs "
        f"recompute_lambdas max_abs_err={lam_err:.3e}; untouched λ bitwise "
        f"unchanged; recompute_lambdas {t_rec:.3f}s, K2 launches={k2}")
    check(k2 == 1, f"recompute_lambdas launched K2 {k2} times, not once")
    check(lam_err <= TOL, "the one-row λ refresh disagrees with K2")
    mutated = rows_m["add_items"][0]
    _s, ids = index.search(a.get_item(mutated).item, k=K, alpha=ALPHA)
    check(int(ids[0][0]) == mutated, "search did not find the mutated row")
    try:
        index.search(qs[:2], k=K, precision="f64_rescore")
        check(False, "f64_rescore ran after mutation")
    except ValueError:
        pass
    st = index.stats()
    index.warmup()
    log(f"  search finds mutated row {mutated} first; f64_rescore refused; "
        f"stats: n_clusters={st['n_clusters']} graph_nnz={st['graph_nnz']} "
        f"lambda_mean={st['lambda_mean']:.6g}; warmup ran")


def unseeded_path(torch, counters, rows, canon, dev):
    """The unseeded cosine path: ArrowIndex.build without a seed (default
    sampling simple(0.6), the chunked scan), then a SearchSession of 16
    batches held against the plain full scan.  The counters are set to 0
    just before the build and read right after the stream.  Returns the
    index."""
    from arrowspace_torch.index import ArrowIndex
    from arrowspace_torch.sampling import SamplerType

    log(f"[5a] unseeded cosine path: ArrowIndex.build {rows.shape[0]}x"
        f"{rows.shape[1]} eps={EPS} (no seed) on {dev}")
    made = []
    make = SamplerType.make
    SamplerType.make = lambda self, seed=None: made.append(
        make(self, seed)) or made[-1]
    reset(counters)
    try:
        t0 = time.perf_counter()
        index = ArrowIndex.build(rows, eps=EPS, device=dev)
        sync(torch, dev)
        t_build = time.perf_counter() - t0
    finally:
        SamplerType.make = make
    b, a = index.builder, index.aspace
    cs = b.clustering_seconds
    kept, _ = made[-1].get_stats()
    share = kept / rows.shape[0]
    assigned = int((a.cluster_assignments >= 0).sum())
    log(f"  build_s={t_build:.3f} " + " ".join(
        f"{k}_s={v:.3f}" for k, v in b.stage_seconds.items()))
    log(f"  K={b.cluster_max_clusters} radius={b.cluster_radius:.6g} "
        f"n_clusters={a.n_clusters} kept share={share:.4f} assigned="
        f"{assigned}; chunked scan {cs['scan']:.3f}s: pre-cap chunks "
        f"{cs['scan_pre_cap']:.3f}s, at-cap tail {cs['scan_tail']:.3f}s")
    log_clustering(torch, index, rows)
    check(not b.deterministic_clustering, "the build was seeded")
    check(int(a.cluster_sizes.sum()) == assigned,
          "cluster sizes do not sum to the assigned rows")
    check(0.325 < share < 0.89, f"kept share {share} outside (0.325, 0.89)")
    _, _, launches, self_hits, _, _ = serve(
        torch, counters, index, rows, canon, dev, SEED + 5,
        {"bintopk": "k1", "taulambda": "k2", "merge_topk": "k3"})
    check(launches["taulambda"] == 1 and launches["bintopk"] == N_BATCHES + 1,
          f"the unseeded path launched {launches}, not K2 once and K1 "
          f"{N_BATCHES + 1} times")
    return index


def chunked_engine_vs_host(torch, index, rows, dev):
    """_incremental_clustering_chunked twice on the same rows with the K,
    radius and chunk of the unseeded build and samplers seeded alike: the
    engine on the card (float32) and the host path (float64).  n_c must be
    equal.  A row may be assigned differently only near a rule's edge:
    its float64 d² at decision time (the host run's snapshot) within
    ``tol`` of radius/2, radius or 1.5·radius, its two nearest centroids
    within 2·tol, or its sampler draw within float32 rounding of the keep
    rate; tol = the float32 d² error measured on those snapshots + the
    reach of the final centroid difference Δ (2·√d²·Δ + Δ²)."""
    from arrowspace_torch import clustering as cl
    from arrowspace_torch.builder import ArrowSpaceBuilder
    from arrowspace_torch.sampling import SamplerType

    b0 = index.builder
    k_cap, radius = b0.cluster_max_clusters, b0.cluster_radius
    n, f = rows.shape
    chunk = cl._device_chunk_for(n)
    log(f"[5b] chunked scan: engine on the card (float32) vs host path "
        f"(float64), K={k_cap} radius={radius:.6g} chunk={chunk}")

    def run(device_data):
        b = ArrowSpaceBuilder(device=dev)
        s = SamplerType.simple(0.6).make(seed=SEED)
        t0 = time.perf_counter()
        out = cl._incremental_clustering_chunked(
            b, rows, f, k_cap, radius, s, chunk=chunk,
            device_data=device_data)
        return out, time.perf_counter() - t0, b.clustering_seconds

    tails = []
    apply_tail = cl._apply_atcap_tail
    cl._apply_atcap_tail = lambda eng, c0, *r, **k: tails.append(c0) or \
        apply_tail(eng, c0, *r, **k)
    try:
        (c_e, a_e, z_e), t_e, cs_e = run(index.aspace.data)
    finally:
        cl._apply_atcap_tail = apply_tail
    records = []
    decide = cl._apply_chunk_decisions

    def record(rows_c, best, best_d2, offset, builder, sampler, radius_,
               max_clusters, cent, counts, assign, state, **kw):
        records.append((offset, best.shape[0], best_d2.copy(),
                        cent[:state["n_c"]].copy()))
        return decide(rows_c, best, best_d2, offset, builder, sampler,
                      radius_, max_clusters, cent, counts, assign, state,
                      **kw)
    cl._apply_chunk_decisions = record
    try:
        (c_h, a_h, z_h), t_h, _ = run(None)
    finally:
        cl._apply_chunk_decisions = decide
    log(f"  engine: {t_e:.3f}s (pre-cap {cs_e['scan_pre_cap']:.3f}s, at-cap "
        f"tail from row {tails[0] if tails else None} "
        f"{cs_e['scan_tail']:.3f}s); host path: {t_h:.3f}s")
    check(c_e.shape[0] == c_h.shape[0],
          f"n_c differs: engine {c_e.shape[0]}, host {c_h.shape[0]}")
    check(len(tails) == 1, "the engine run did not take the at-cap tail")

    # float64 decision-time distances of every row (the host snapshots),
    # and the float32 d² error of the engine's formula on them
    bd, d2nd = np.full(n, np.nan), np.full(n, np.nan)
    f32_err = 0.0
    x64 = torch.as_tensor(rows, device=dev)

    def plane(x, c):
        return ((x * x).sum(1)[:, None] - 2.0 * (x @ c.T)
                + (c * c).sum(1)[None, :]).clamp_min(0.0)
    for off, m, best_d2, snap in records:
        c64 = torch.as_tensor(snap, device=dev)
        r64 = x64[off:off + m]
        p64 = plane(r64, c64)
        f32_err = max(f32_err, float((plane(r64.float(), c64.float())
                                      .double() - p64).abs().max()))
        bd[off:off + m] = best_d2
        if p64.shape[1] > 1:
            d2nd[off:off + m] = p64.topk(2, dim=1, largest=False) \
                .values[:, 1].cpu().numpy()
    delta = float(np.linalg.norm(c_e - c_h, axis=1).max())
    cent_abs = float(np.abs(c_e - c_h).max())
    diff = np.nonzero(a_e.array != a_h.array)[0]
    bdd, d2d = bd[diff], d2nd[diff]
    tol_rule = f32_err + 2.0 * np.sqrt(bdd) * delta + delta ** 2
    tol_tie = 2.0 * (f32_err + 2.0 * np.sqrt(d2d) * delta + delta ** 2)
    rule = np.min(np.abs(bdd[:, None] - radius * np.array([0.5, 1.0, 1.5])),
                  axis=1) <= tol_rule
    tie = d2d - bdd <= tol_tie
    draws = SamplerType.simple(0.6).make(seed=SEED)._rng.random(n)[diff]
    keep_edge = (draws.astype(np.float32) < np.float32(0.6)) != (draws < 0.6)
    bad = diff[~(rule | tie | keep_edge)]
    log(f"  n_c={c_e.shape[0]} (both); rows assigned differently: "
        f"{diff.size} ({diff.size / n:.3e} of the rows; near a rule edge "
        f"{int(rule.sum())}, near a tie {int(tie.sum())}, at the keep rate "
        f"{int(keep_edge.sum())}); float32 d² error on the host's snapshots "
        f"{f32_err:.3e}; largest centroid |Δ| {cent_abs:.3e} (row L2 "
        f"{delta:.3e}); sizes equal: {z_e == z_h}")
    check(bad.size == 0, f"{bad.size} rows assigned differently away from "
          f"every rule edge and tie, e.g. row {bad[:1].tolist()}")


# ---------------------------------------------------------------------------
# The spectral build, persistence and the live sessions
# ---------------------------------------------------------------------------

# Artifacts of the persistence phases go here, inside the checkout, and
# are removed at the end of the run.
ARTIFACTS = "_smoke_artifacts"
# The live sessions: capacity headroom, the mutations, and the batches
# run after each mutation; the wide snapshot's rows.
LIVE_HEADROOM, LIVE_ADD, LIVE_UPDATE, LIVE_DELETE = 131_072, 65_536, 4_096, \
    65_536
LIVE_BATCHES, LIVE_COPIES = 4, 256
SNAP_ROWS = 131_072


def artifacts_dir():
    import pathlib
    return pathlib.Path(__file__).resolve().parent / ARTIFACTS


def artifact_bytes(name: str) -> dict:
    """Size in bytes of each file of the saved index ``name``."""
    return {p.name[len(name) + 1:]: p.stat().st_size
            for p in sorted(artifacts_dir().glob(f"{name}-*.parquet"))}


def more_rows(n: int, f: int, seed: int) -> np.ndarray:
    """n new rows of the corpus generator at width f: its 64 centres
    (clustered_rows' first draws at SEED), new picks and noise from
    ``seed``."""
    centres = np.random.default_rng(SEED).uniform(0.2, 0.8, (N_CENTRES, f))
    rng = np.random.default_rng(seed)
    return centres[rng.integers(0, N_CENTRES, n)] \
        + rng.normal(0, NOISE, (n, f))


def timed(torch, dev, fn):
    """(fn(), wall seconds to its end on the card)."""
    sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, time.perf_counter() - t0


def stream_ms(torch, dev, session, batches):
    """(results, ms per batch) of a session's stream over ``batches``."""
    res, secs = timed(torch, dev,
                      lambda: list(session.search_stream(batches)))
    return res, secs / len(batches) * 1e3


def same_results(name, got, ref) -> None:
    """Two streams' (scores, ids) bitwise equal, batch by batch."""
    for b, ((s, i), (rs, ri)) in enumerate(zip(got, ref)):
        check(np.array_equal(i, ri), f"{name}: ids differ in batch {b}")
        check(np.array_equal(s, rs), f"{name}: scores differ in batch {b}")
    log(f"  {name}: ids and scores bitwise equal over {len(ref)} batches")


def laplacian64(rows: np.ndarray, eps: float, topk: int, p: float,
                sigma) -> np.ndarray:
    """The λτ-graph Laplacian over the rows of ``rows`` in float64 numpy
    (laplacian.rs:203-417): top-(topk+1) neighbours by rectified cosine
    distance (stable order), d <= eps, w = 1/(1+(d/σ)^p), a max-merge
    symmetrisation, L = D - A.  No row here has more than topk edges,
    so the reference's sparsification (average degree above 10) never
    applies."""
    n = rows.shape[0]
    kq = min(topk + 1, n)
    sigma = 1.0 if sigma is None else sigma
    norms = np.sqrt((rows * rows).sum(axis=1))
    unit = rows / np.where(norms > 0, norms, 1.0)[:, None]
    cos = np.where((norms[:, None] > 0) & (norms[None, :] > 0),
                   unit @ unit.T, 0.0)
    dist = 1.0 - np.maximum(cos, 0.0)
    np.fill_diagonal(dist, -1.0)
    nbr = np.argsort(dist, axis=1, kind="stable")[:, :kq]
    d = np.take_along_axis(dist, nbr, axis=1)
    keep = (nbr != np.arange(n)[:, None]) & (d <= eps)
    w = 1.0 / (1.0 + (np.maximum(d, 0.0) / sigma) ** p)
    keep &= w > 1e-12
    check(keep.sum(axis=1).mean() <= 10.0, "laplacian64: would sparsify")
    adj = np.zeros((n, n))
    np.maximum.at(adj, (np.repeat(np.arange(n), kq), nbr.ravel()),
                  np.where(keep, w, 0.0).ravel())
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0.0)
    return np.diag(adj.sum(axis=1)) - adj


def spectral_path(torch, counters, rows, canon, dev):
    """One more build of the cosine corpus with the signals graph
    (ArrowSpaceBuilder, ε = 1.0, seed 11, with_spectral(True)): signals
    128×128 against a float64 numpy build of the Laplacian of Lᵀ, the
    build's λ (one K2 launch, counted) against a float64 λ against
    signals, recompute_lambdas bitwise the build's, then a SearchSession
    of 16 batches held against the plain full scan.  The counters are
    set to 0 just before the build and read after the stream; returns
    the launch counts and the index."""
    from arrowspace_torch.builder import ArrowSpaceBuilder
    from arrowspace_torch.index import ArrowIndex
    from arrowspace_torch.taumode import compute_taumode_lambdas

    log(f"[4d] spectral path: ArrowSpaceBuilder {rows.shape[0]}x"
        f"{rows.shape[1]} eps={EPS} seed={SEED} with_spectral(True)")
    reset(counters)
    b = (ArrowSpaceBuilder(device=dev).with_lambda_graph(EPS, 6, 3, 2.0, None)
         .with_seed(SEED).with_spectral(True))
    (a, gl), t_build = timed(torch, dev, lambda: b.build(rows))
    k2_build = counters["k2"].launches
    log(f"  build_s={t_build:.3f} " + " ".join(
        f"{k}_s={v:.3f}" for k, v in b.stage_seconds.items())
        + f"; K2 launches in the build={k2_build}")
    check(k2_build == 1, f"the spectral build launched K2 {k2_build} times")
    sig = a.signals
    check(sig is not None and tuple(sig.shape) == (N_FEAT, N_FEAT),
          f"signals shape {None if sig is None else tuple(sig.shape)}")
    gp = gl.graph_params
    ref = laplacian64(gl.matrix.double().cpu().numpy().T, gp.eps, gp.topk,
                      gp.p, gp.sigma)
    sig_err = float(np.abs(sig.double().cpu().numpy() - ref).max())
    edges = int((ref != 0).sum() - N_FEAT) // 2
    log(f"  signals {tuple(sig.shape)}, {edges} edges: max_abs_err against "
        f"a float64 numpy build of the Laplacian of L^T {sig_err:.3e}")
    check(sig_err <= 1e-6, f"signals differ from float64: {sig_err}")
    lam64 = compute_taumode_lambdas(a.data.double(), sig.double(), a.taumode)
    lam_err = float((a.lambdas.double() - lam64).abs().max())
    lam_feat = compute_taumode_lambdas(a.data.double(),
                                       gl.matrix.double(), a.taumode)
    log(f"  λ (K2 against signals) vs float64 λ against signals: "
        f"max_abs_err={lam_err:.3e}; vs float64 λ against the feature "
        f"graph {float((a.lambdas.double() - lam_feat).abs().max()):.3e}")
    check(lam_err <= TOL, f"spectral λ vs float64: {lam_err} > {TOL}")
    check_lambdas(a.lambdas, canon, "spectral")
    before = a.lambdas.clone()
    a.recompute_lambdas(gl)
    check(bool(torch.equal(a.lambdas, before)),
          "recompute_lambdas moved the spectral build's λ")
    del lam64, lam_feat
    index = ArrowIndex(a, gl, b)
    reset(counters)
    session, _b, launches, self_hits, _i0, ms = serve(
        torch, counters, index, rows, canon, dev, SEED + 5,
        {"bintopk": "k1", "merge_topk": "k3", "taulambda": "k2"})
    check(launches["bintopk"] == N_BATCHES + 1 and self_hits == 1.0,
          f"spectral session: launches {launches}, self-match {self_hits}")
    log(f"  spectral session: {ms:.3f} ms a batch")
    launches["taulambda"] = k2_build
    return launches, index


def persistence_phase(torch, counters, index, batches, dev):
    """The seeded cosine index saved, loaded onto the card and served: a
    SearchSession of the reloaded index over the 16 batches gives
    bitwise the ids and scores of the index's own session; the load
    launches no K2.  Returns (the index's session results, its ms per
    batch, the reloaded session's K1 launches)."""
    from arrowspace_torch.index import ArrowIndex

    log("[4b] persistence: save, load and serve the seeded cosine index")
    static = index.make_search_session(batch_size=BATCH, k=K, alpha=ALPHA)
    static.warmup()
    ref, ms_static = stream_ms(torch, dev, static, batches)
    base = artifacts_dir()
    _, t_save = timed(torch, dev, lambda: index.save(base, "cosine"))
    reset(counters)
    loaded, t_load = timed(torch, dev, lambda: ArrowIndex.load(
        base, "cosine", device=dev))
    check(counters["k2"].launches == 0, "the load launched K2")
    a, b = loaded.aspace, index.aspace
    check(bool(torch.equal(a.data, b.data) and torch.equal(a.lambdas,
                                                           b.lambdas)
               and torch.equal(loaded.gl.matrix, index.gl.matrix)),
          "the reloaded index's tensors differ")
    sizes = artifact_bytes("cosine")
    log(f"  save_s={t_save:.3f} load_s={t_load:.3f} (onto the card, no K2); "
        f"files: " + ", ".join(f"{k} {v / 2**20:.1f} MiB"
                               for k, v in sizes.items()))
    reset(counters)
    session = loaded.make_search_session(batch_size=BATCH, k=K, alpha=ALPHA)
    session.warmup()
    got, ms = stream_ms(torch, dev, session, batches)
    k1 = counters["k1"].launches
    same_results("reloaded index's session vs the index's", got, ref)
    log(f"  sessions: the index's {ms_static:.3f} ms a batch, the reloaded "
        f"index's {ms:.3f}; K1 launches={k1}")
    return ref, ms_static, k1


def live_positions(live, ids) -> np.ndarray:
    return np.vectorize(live._pos.__getitem__, otypes=[np.int64])(ids)


def live_vs_plain(torch, live, name, q_np, res, dev) -> None:
    """The first 256 rows of a live batch (its exact copies of added rows
    among them) against the plain full scan of
    the live rows (its first nitems positions) with the session's own
    query λ, compared by buffer position (the external ids mapped
    through the session's table), so that identical rows tie to the
    lowest position, as in a static session."""
    from arrowspace_torch.ops.search import batched_lambda_aware_topk
    n = live.nitems
    q = torch.as_tensor(q_np[:256], device=dev, dtype=torch.float32)
    _, qlam = live._prepare(q)
    ps, pi = batched_lambda_aware_topk(q, qlam, live._raw[:n],
                                       live._lam[:n], ALPHA, k=K)
    pos = live_positions(live, res[1][:256])
    check(int(pos.max()) < n, f"{name}: a position past the live count")
    agree(name, res[0][:256], pos, ps, pi,
          exact=true_scores(q, qlam, live._raw[:n], live._lam[:n],
                            torch.as_tensor(pos, device=dev)))


def copies_first(name, res, copies_ids, sources, canon, tol=None) -> None:
    """Each query that is an exact copy of an added row (the copy of
    corpus row ``sources[r]``) returns that row first, or behind a row
    identical to it (the source row or one of its planted duplicates,
    ``canon``), with the added row in its top k; with ``tol``, the two
    scores within it.  Before any delete a corpus row's external id is
    its row number."""
    s, ids = res
    for r, cid in enumerate(copies_ids):
        row = list(ids[r])
        check(int(cid) in row, f"{name}: added row {cid} not in its top {K}")
        j, top = row.index(int(cid)), int(ids[r][0])
        if j:
            same = top < canon.size and canon[top] == canon[sources[r]]
            check(same and (tol is None or s[r][0] - s[r][j] <= tol),
                  f"{name}: query {r} returned {top} before its added copy "
                  f"{cid}")
    log(f"  {name}: each of {len(copies_ids)} added copies returned first "
        f"or behind a row identical to it")


def live_counts(counters) -> dict:
    return {"k1": counters["k1"].launches, "k3": counters["k3"].launches,
            "k2": counters["k2"].launches, "k6": counters["k6"].launches,
            "repairs": counters["repair"].calls,
            "energy_repairs": counters["erepair"].calls}


def live_batches(rows, seed, n_batches, first=None) -> list:
    """Query batches of corpus rows ×1.02; batch 0 begins with ``first``
    (exact copies of added rows) where given."""
    rng = np.random.default_rng(seed)
    out = [rows[rng.integers(0, rows.shape[0], BATCH)] * 1.02
           for _ in range(n_batches)]
    if first is not None:
        out[0][:len(first)] = first
    return out


def mutation_ids(live, rng, tail: int) -> tuple:
    """(update ids, delete ids): LIVE_UPDATE ids at random; LIVE_DELETE
    ids spread evenly through the corpus and the ids at its last
    ``tail`` positions, so that the swap moves rows and stale rows stay
    past the live count."""
    n = live.nitems
    upd = live._ids[rng.choice(n, LIVE_UPDATE, replace=False)]
    spread = np.linspace(0, n - tail - 1, LIVE_DELETE - tail).astype(np.int64)
    pos = np.concatenate([spread, np.arange(n - tail, n)])
    check(np.unique(pos).size == LIVE_DELETE, "delete positions repeat")
    return upd, live._ids[pos]


def copy_sources(canon, rng) -> np.ndarray:
    """LIVE_COPIES corpus rows without a planted duplicate, whose added
    copies the queries repeat."""
    single = np.nonzero(canon == np.arange(canon.size))[0]
    single = single[np.bincount(canon, minlength=canon.size)[single] == 1]
    return rng.choice(single, LIVE_COPIES, replace=False)


def live_phase(torch, counters, index, rows, canon, batches, ref,
               ms_static, dev):
    """The live cosine session on the seeded index, capacity n + 131072:
    (a) 16 batches before any mutation, bitwise the static session's;
    (b) add 65536 rows (exact copies of 256 corpus rows, and new rows of
    the generator), update 4096, delete 65536 (spread, and the tail),
    each timed; (c) after each, 4 batches held against the plain full
    scan of the live rows; (d) a query equal to an added row returns it
    first or tied with its copies; (e) the added rows' λ against
    prepare_query_items_batch; (f) K1 once a batch, K3 only on repair
    overflow; (g) to_index, save, load, and a SearchSession whose ids,
    mapped through the external ids, equal the live session's.  Returns
    the K1 launches of (a) and the 4-batch checks."""
    from arrowspace_torch.index import ArrowIndex

    n0 = index.nitems
    log(f"[4c] live cosine session: {n0} rows, capacity {n0 + LIVE_HEADROOM}")
    live = index.make_live_session(batch_size=BATCH, k=K, alpha=ALPHA,
                                   capacity=n0 + LIVE_HEADROOM)
    check(live.kernel == "binned", f"live session kernel {live.kernel}")
    live.warmup()
    reset(counters)
    got, ms_live = stream_ms(torch, dev, live, batches)
    c = live_counts(counters)
    check(c["k1"] == N_BATCHES, f"live stream: K1 launched {c['k1']} times")
    same_results("(a) live session before mutation vs the static session",
                 got, ref)
    log(f"  (a) {len(batches)} batches: live {ms_live:.3f} ms a batch, static "
        f"{ms_static:.3f}; launches {c}")
    launches = c["k1"]

    rng = np.random.default_rng(SEED + 7)
    src = copy_sources(canon, rng)
    added = np.concatenate([rows[src], more_rows(LIVE_ADD - LIVE_COPIES,
                                                 N_FEAT, SEED + 8)])
    ids_added, t = timed(torch, dev, lambda: live.add(added))
    upd, dele = mutation_ids(live, rng, 4096)
    for step in ("add", "update", "delete"):
        m = LIVE_ADD
        if step == "update":
            m = LIVE_UPDATE
            _, t = timed(torch, dev, lambda: live.update(
                upd, more_rows(LIVE_UPDATE, N_FEAT, SEED + 9)))
        elif step == "delete":
            m = LIVE_DELETE
            _, t = timed(torch, dev, lambda: live.delete(dele))
        reset(counters)
        qb = live_batches(rows, SEED + 10, LIVE_BATCHES,
                          first=added[:LIVE_COPIES] if step == "add" else None)
        res = list(live.search_stream(qb))
        c = live_counts(counters)
        check(c["k1"] == LIVE_BATCHES and c["k2"] == 0
              and c["k3"] <= c["repairs"],
              f"(f) live after {step}: launches {c} (K1 once a batch, K3 "
              "only on repair overflow)")
        launches += c["k1"]
        log(f"  (b) {step} {m} rows: {t * 1e3:.3f} ms ({t * 1e6 / m:.3f} ms "
            f"per 1000 rows); nitems={live.nitems}; (f) launches over "
            f"{LIVE_BATCHES} batches {c}")
        live_vs_plain(torch, live, f"(c) live after {step} vs plain scan of "
                      "the live rows (256 queries)", qb[0], res[0], dev)
        if step == "add":
            copies_first("(d) live after add", res[0],
                         ids_added[:LIVE_COPIES], src, canon, tol=2 * TOL)
            pos = torch.as_tensor(live_positions(live, ids_added),
                                  device=dev)
            lam_ref = index.aspace.prepare_query_items_batch(added, index.gl)
            lam_err = float((live._lam[pos] - lam_ref).abs().max())
            log(f"  (e) added rows' λ vs prepare_query_items_batch: "
                f"max_abs_err={lam_err:.3e}")
            check(lam_err <= TOL, f"added rows' λ: {lam_err} > {TOL}")
    stale = int((live._xhat[live.nitems:live.nitems + 4096].abs()
                 .sum(dim=1) > 0).sum())
    log(f"  stale prepared rows among the 4096 past the live count: {stale}")
    check(stale > 0, "no stale row past the live count")

    (snap, ext), t_snap = timed(torch, dev, live.to_index)
    base = artifacts_dir()
    _, t_save = timed(torch, dev, lambda: snap.save(base, "live"))
    loaded, t_load = timed(torch, dev, lambda: ArrowIndex.load(
        base, "live", device=dev))
    q = live_batches(rows, SEED + 11, 1)[0][:256]
    ls, li = live.search(q)
    sess = loaded.make_search_session(batch_size=BATCH, k=K, alpha=ALPHA)
    ss, si = next(iter(sess.search_stream([q])))
    check(np.array_equal(ext[si], li), "(g) the reloaded snapshot's ids, "
          "mapped through the external ids, differ from the live session's")
    log(f"  (g) to_index {t_snap:.3f}s, save {t_save:.3f}s, load "
        f"{t_load:.3f}s; the reloaded snapshot's session equals the live "
        f"session on 256 queries (scores bitwise "
        f"{np.array_equal(ss, ls)})")
    return launches


def live_energy_phase(torch, counters, index, exact, rows, canon, batches,
                      res_e, dev):
    """The live energy session on the 1M energy index (K6, capacity
    n + 131072): steps (a)-(e) of the live cosine phase, held at the
    energy tolerance: (a) against the exact static session; (c) against
    the plain chunked scan of the live rows on the engine's plane, the
    centre fixed at construction.  Returns its K6 launches."""
    from arrowspace_torch.ops.energy_bintopk import energy_topk_chunked

    n0 = index.nitems
    log(f"[8b] live energy session: {n0} rows, capacity "
        f"{n0 + LIVE_HEADROOM}")
    live = index.make_live_energy_session(
        batch_size=BATCH, k=K, w_lambda=E_WL, w_dirichlet=E_WD,
        capacity=n0 + LIVE_HEADROOM)
    check(live.kernel == "binned", f"live energy kernel {live.kernel}")
    e = live.engine
    centre = e.centre.clone()
    check(bool(torch.equal(centre, exact.engine.centre)),
          "the live engine's centre is not the static engine's")
    live.warmup()
    reset(counters)
    got, ms_live = stream_ms(torch, dev, live, batches)
    c = live_counts(counters)
    check(c["k6"] == N_BATCHES, f"live energy: K6 launched {c['k6']} times")
    bitwise = all(np.array_equal(g[0], r[0]) and np.array_equal(g[1], r[1])
                  for g, r in zip(got, res_e))
    for b in (0, N_BATCHES - 1):
        agree(f"(a) live energy batch {b} vs the static exact session",
              got[b][0], got[b][1], res_e[b][0], res_e[b][1], tol=E_TOL)
    log(f"  (a) {len(batches)} batches: live {ms_live:.3f} ms a batch, "
        f"bitwise the "
        f"static session's: {bitwise}; launches {c}")
    launches = c["k6"]

    rng = np.random.default_rng(SEED + 12)
    src = copy_sources(canon, rng)
    added = np.concatenate([rows[src], more_rows(LIVE_ADD - LIVE_COPIES,
                                                 N_FEAT, SEED + 13)])
    ids_added, t_add = timed(torch, dev, lambda: live.add(added))
    upd, dele = mutation_ids(live, rng, 4096)
    for step in ("add", "update", "delete"):
        m, t = LIVE_ADD, t_add
        if step == "update":
            m = LIVE_UPDATE
            _, t = timed(torch, dev, lambda: live.update(
                upd, more_rows(LIVE_UPDATE, N_FEAT, SEED + 14)))
        elif step == "delete":
            m = LIVE_DELETE
            _, t = timed(torch, dev, lambda: live.delete(dele))
        check(bool(torch.equal(e.centre, centre)), "the centre moved")
        reset(counters)
        qb = live_batches(rows, SEED + 15, LIVE_BATCHES,
                          first=added[:LIVE_COPIES] if step == "add" else None)
        res = list(live.search_stream(qb))
        c = live_counts(counters)
        check(c["k6"] == LIVE_BATCHES, f"live energy after {step}: {c}")
        launches += c["k6"]
        log(f"  (b) {step} {m} rows: {t * 1e3:.3f} ms ({t * 1e6 / m:.3f} ms "
            f"per 1000 rows); nitems={live.nitems}; launches {c}")
        # (c) on 256 queries that are no exact copy: at d² → 0 the float32
        # score's error is w_D·√(d² error), beyond E_TOL (README)
        n, rr = live.nitems, slice(LIVE_COPIES, LIVE_COPIES + 256)
        q = torch.as_tensor(qb[0][rr], device=dev, dtype=torch.float32)
        zq, qlam = live._prepare(q)
        zc = e.centred(zq)
        ps, pi = energy_topk_chunked(zc, qlam, e.zx[:n], e.xlam[:n], E_WL,
                                     E_WD, k=K)
        pos = live_positions(live, res[0][1][rr])
        check(int(pos.max()) < n, "live energy: a position past the count")
        agree(f"(c) live energy after {step} vs plain chunked scan of the "
              "live rows (256 queries)", res[0][0][rr], pos, ps, pi,
              tol=E_TOL, exact=energy_exact(zc, qlam, e.zx, e.xlam,
                                             torch.as_tensor(pos, device=dev)))
        if step == "add":
            copies_first("(d) live energy after add", res[0],
                         ids_added[:LIVE_COPIES], src, canon)
            lam_ref = index.aspace.prepare_query_items_batch(added, index.gl)
            lam_err = float((e.xlam[torch.as_tensor(
                live_positions(live, ids_added), device=dev)]
                - lam_ref).abs().max())
            log(f"  (e) added rows' λ vs prepare_query_items_batch: "
                f"max_abs_err={lam_err:.3e}")
            check(lam_err <= TOL, f"added energy λ: {lam_err} > {TOL}")
    return launches


def wide_snapshot_phase(torch, counters, index, batches, dev):
    """A 131072-row snapshot of the wide projected index (the same graph,
    projection and λ, as to_index makes one) saved and loaded onto the
    card: the loaded projection matrix bitwise the saved one, and its
    SearchSession (K1) bitwise the snapshot's over 4 batches.  Returns
    the K1 launches of the reloaded session."""
    import copy
    import dataclasses

    from arrowspace_torch.index import ArrowIndex

    log(f"[10b] persistence of a {SNAP_ROWS}-row snapshot of the wide "
        f"projected index (F = {W_FEAT})")
    a = index.aspace
    data = a.data[:SNAP_ROWS].clone()
    snap_a = dataclasses.replace(
        a, nitems=SNAP_ROWS, data=data, lambdas=a.lambdas[:SNAP_ROWS].clone(),
        host_rows=data.double().cpu().numpy(), _projected_cache=None,
        _energy_z_cache=None, _lambda_order=None)
    gl = copy.copy(index.gl)
    gl.nnodes = SNAP_ROWS
    snap = ArrowIndex(snap_a, gl)
    static = snap.make_search_session(batch_size=BATCH, k=K, alpha=ALPHA)
    check(static.kernel == "binned", f"snapshot session {static.kernel}")
    static.warmup()
    ref = list(static.search_stream(batches[:4]))
    base = artifacts_dir()
    _, t_save = timed(torch, dev, lambda: snap.save(base, "wide"))
    loaded, t_load = timed(torch, dev, lambda: ArrowIndex.load(
        base, "wide", device=dev))
    p0, p1 = a.projection_matrix, loaded.aspace.projection_matrix
    check(p1 is not None and p1.generator == "torch"
          and bool(torch.equal(p1.matrix(), p0.matrix())),
          "the reloaded projection matrix differs from the saved one")
    reset(counters)
    session = loaded.make_search_session(batch_size=BATCH, k=K, alpha=ALPHA)
    session.warmup()
    got = list(session.search_stream(batches[:4]))
    k1 = counters["k1"].launches
    same_results("reloaded wide snapshot's session vs the snapshot's", got,
                 ref)
    log(f"  save_s={t_save:.3f} load_s={t_load:.3f}; projection "
        f"{tuple(p1.matrix().shape)} bitwise; K1 launches={k1}; files: "
        + ", ".join(f"{k} {v / 2**20:.1f} MiB"
                    for k, v in artifact_bytes("wide").items()))
    return k1


def live_merge_phase(torch, counters, index, batches, dev):
    """The live "merge" session on the 1536-wide index (K3 at n_live):
    4 batches before and 4 after an add of 4096 rows and a delete of
    4096, each held against the plain full scan of the live rows.
    Returns its K3 launches."""
    n0 = index.nitems
    log(f"[13b] live merge session: {n0} x {X_FEAT}, capacity {n0 + 8192}")
    live = index.make_live_session(batch_size=BATCH, k=K, alpha=ALPHA,
                                   capacity=n0 + 8192)
    check(live.kernel == "merge", f"live session kernel {live.kernel}")
    live.warmup()
    launches = 0
    rng = np.random.default_rng(SEED + 16)
    for step in ("before", "after add and delete"):
        if step != "before":
            ids = live.add(more_rows(4096, X_FEAT, SEED + 17))
            dele = np.concatenate([live._ids[rng.choice(n0, 2048,
                                                        replace=False)],
                                   ids[-2048:]])
            live.delete(dele)
        reset(counters)
        res, ms = stream_ms(torch, dev, live, batches[:LIVE_BATCHES])
        c = live_counts(counters)
        check(c["k3"] == LIVE_BATCHES and c["k1"] == 0,
              f"live merge {step}: launches {c}")
        launches += c["k3"]
        log(f"  {step}: nitems={live.nitems}, {ms:.3f} ms a batch, "
            f"launches {c}")
        live_vs_plain(torch, live, f"live merge {step} vs plain scan of the "
                      "live rows (256 queries)", batches[0], res[0], dev)
    return launches


# ---------------------------------------------------------------------------
# The pruned sessions and out-of-core streaming
# ---------------------------------------------------------------------------

# Pruned sessions: batches a session, the union session's batch, the
# auto-budget session's first union and batches; the JAX package's pruned
# corpus (benchmarks/pruned_crossover.py:37-58): centres, noise, hot
# regions; rows a streamed chunk.
P_BATCHES, P_UNION, P_AUTO_START, P_AUTO_BATCHES = 64, 256, 8, 8
J_CENTRES, J_NOISE, J_HOT, J_BATCHES = 1024, 0.03, 16, 16
STREAM_CHUNK = 1 << 18


def cell_arrays(c):
    return (c.x, c.lam, c.ids, c.cent, c.radius, c.cosr, c.sinr, c.lam_lo,
            c.lam_hi)


def check_partition(torch, cells, n: int, name: str) -> None:
    ids = cells.ids[cells.ids >= 0]
    check(ids.numel() == n and bool(torch.equal(
        torch.sort(ids.long()).values,
        torch.arange(n, device=ids.device))),
          f"{name}: the units do not partition the corpus")


def build_cells_timed(torch, dev, fn, a, name):
    """A cell build of the index's corpus, timed, with its stage seconds,
    real and padded units and the grouped bytes."""
    stages = {}
    cells, secs = timed(torch, dev, lambda: fn(a.data, a.lambdas, cap=256,
                                               seed=SEED, stages=stages))
    grouped = nbytes(cells.x, cells.lam, cells.ids)
    log(f"  {name} build: {secs:.3f} s (" + " ".join(
        f"{k}_s={v:.3f}" for k, v in stages.items()) + f"); units "
        f"{cells.n_units} real, {cells.cent.shape[0]} padded; grouped "
        f"{grouped / 2**30:.3f} GiB")
    check_partition(torch, cells, a.nitems, name)
    return cells, secs


def pruned_stream(torch, dev, counters, index, session, batches, name):
    """The batches through a pruned session, one after another (each
    search returns to the host); the launch counts of K1 and K3 (the
    fallback and its repair) are read right after, then every batch is
    held against the plain full scan (agree, with the query λ of the
    session's preparation).  Returns (results, ms a batch, this stream's
    flag rate, launches)."""
    from arrowspace_torch.index import _query_prep
    from arrowspace_torch.ops.search import batched_lambda_aware_topk

    f0, q0 = session.flagged_total, session.queries_total
    results, secs = timed(torch, dev,
                          lambda: [session.search(q) for q in batches])
    launches = {k: counters[k].launches for k in ("k1", "k3")}
    rate = (session.flagged_total - f0) / (session.queries_total - q0)
    a = index.aspace
    prepare = _query_prep(a, index.gl)[1]
    err = 0.0
    for q, (s, i) in zip(batches, results):
        qt = torch.as_tensor(q, device=dev, dtype=torch.float32)
        _, qlam = prepare(qt)
        ps, pi = batched_lambda_aware_topk(qt, qlam, a.data, a.lambdas,
                                           ALPHA, k=K)
        err = max(err, agree(name, s, i, ps, pi, exact=true_scores(
            qt, qlam, a.data, a.lambdas, torch.as_tensor(i, device=dev)),
            quiet=True))
    ms = secs / len(batches) * 1e3
    log(f"  {name}: {len(batches)} batches of {batches[0].shape[0]}, "
        f"{ms:.3f} ms a batch, flag rate {rate:.4f}, launches {launches}; "
        f"every batch agrees with the plain full scan (max_abs_err "
        f"{err:.3e})")
    return results, ms, rate, launches


def search_session_ms(torch, dev, index, batches) -> float:
    """ms a batch of a SearchSession at the batches' size on the index,
    after its warm-up (its launches are not counted to any path)."""
    sess = index.make_search_session(batch_size=batches[0].shape[0], k=K,
                                     alpha=ALPHA)
    sess.warmup()
    return stream_ms(torch, dev, sess, batches)[1]


def zero_row_repro(torch, dev) -> None:
    """The device build of a 60-row corpus with a zero row, and the query
    anti-aligned with the zero row's cluster (the zero row is the true
    top-1; a cap from 1 - d²/2 would prune it): its certified top-1 is
    the host build's."""
    from arrowspace_torch.pruned import (build_cells, build_cells_device,
                                         pruned_topk)
    rng = np.random.default_rng(91)
    u = np.zeros(8)
    u[:4] = 0.5
    w = 0.3 * u + np.sqrt(1 - 0.09) * np.eye(8)[7]
    x = np.vstack([u + rng.normal(0, 0.01, (30, 8)),
                   w + rng.normal(0, 0.01, (30, 8))]).astype(np.float32)
    x[5] = 0.0
    lam = rng.uniform(0, 1, 60).astype(np.float32)
    q = torch.as_tensor(-u[None, :], dtype=torch.float32, device=dev)
    ql = torch.as_tensor(lam[:1], device=dev)
    kw = dict(cap=64, seed=2, n_clusters=2, iters=4)
    tops = []
    for build in (build_cells, build_cells_device):
        c = build(torch.as_tensor(x, device=dev),
                  torch.as_tensor(lam, device=dev), **kw)
        s, i, fl = pruned_topk(q, ql, *cell_arrays(c), 1.0, k=1, m_cells=1,
                               cap=64, margin=1e-3)
        tops.append((int(i[0, 0]), bool(fl[0])))
    log(f"  zero-row repro (60 rows): host build top-1 {tops[0]}, device "
        f"build {tops[1]} (id, flagged)")
    check(tops[0] == tops[1] == (5, False),
          "zero-row repro: the device build's top-1 is not the host build's")


def zero_rows_at_scale(torch, dev, index, cells_kw) -> None:
    """The first 131072 corpus rows with 64 of them zeroed, both builds on
    the card, and 16 queries anti-aligned with the corpus mean (every real
    row scores below 0, the zero rows 0): each build's certified rows
    agree with the plain full scan and hold zero rows only."""
    from arrowspace_torch.ops.search import batched_lambda_aware_topk
    from arrowspace_torch.pruned import (build_cells, build_cells_device,
                                         pruned_topk)
    a = index.aspace
    n = 131_072
    x = a.data[:n].clone()
    zero = torch.arange(0, n, 2048, device=dev)
    x[zero] = 0.0
    lam = a.lambdas[:n]
    rng = np.random.default_rng(SEED + 31)
    q = -x.mean(dim=0)[None, :] + torch.as_tensor(
        rng.normal(0, 0.01, (16, x.shape[1])), dtype=torch.float32,
        device=dev)
    ql = lam[torch.as_tensor(rng.integers(0, n, 16), device=dev)]
    ps, pi = batched_lambda_aware_topk(q, ql, x, lam, ALPHA, k=K)
    check(bool(torch.isin(pi, zero).all()),
          "zero rows: the plain scan's top-k is not the zero rows")
    for name, build in (("host", build_cells), ("device", build_cells_device)):
        c = build(x, lam, **cells_kw)
        s, i, fl = pruned_topk(q, ql, *cell_arrays(c), ALPHA, k=K,
                               m_cells=32, cap=c.cap, margin=1e-3)
        ok = ~fl
        log(f"  zero rows at {n} rows ({name} build): {int(ok.sum())} of 16 "
            f"certified")
        check(bool(ok.any()), f"zero rows ({name} build): nothing certified")
        agree(f"zero rows ({name} build) vs plain full scan", s[ok], i[ok],
              ps[ok], pi[ok])


def pruned_phase(torch, counters, index, rows, dev):
    """[4e] The pruned sessions on the seeded cosine index: both cell
    builds, a B=16 session (host-built cells) and a B=256 union session
    (device-built cells) over 64 batches of corpus rows x 1.02 each,
    every batch held against the plain full scan, their ms beside a
    SearchSession at the same B; a batch of Gaussian queries, which must
    flag and re-run through K1; an auto-budget union session from 8
    units; the cells saved, loaded and served bitwise; and the zero-row
    cases.  Returns the launches by path and the device-built cells."""
    from arrowspace_torch.pruned import (PrunedSearchSession, build_cells,
                                         build_cells_device, load_cells,
                                         save_cells)
    log("[4e] pruned sessions on the seeded cosine index")
    a = index.aspace
    n = a.nitems
    host, t_host = build_cells_timed(torch, dev, build_cells, a, "host")
    card, t_card = build_cells_timed(torch, dev, build_cells_device, a,
                                     "device")
    rng = np.random.default_rng(SEED + 20)
    q16 = [rows[rng.integers(0, n, 16)] * 1.02 for _ in range(P_BATCHES)]
    q256 = [rows[rng.integers(0, n, P_UNION)] * 1.02
            for _ in range(P_BATCHES)]
    by_path = {"k1": {}, "k3": {}}

    def record(path, launches):
        for key in by_path:
            by_path[key][path] = launches[key]

    reset(counters)
    s16 = PrunedSearchSession(index, 16, k=K, alpha=ALPHA, cells=host)
    s16.warmup()
    res16, ms16, rate16, l16 = pruned_stream(
        torch, dev, counters, index, s16, q16, "pruned B=16 (host cells)")
    record("pruned_cosine_b16", l16)
    reset(counters)
    s256 = PrunedSearchSession(index, P_UNION, k=K, alpha=ALPHA, cells=card)
    s256.warmup()
    res256, ms256, rate256, l256 = pruned_stream(
        torch, dev, counters, index, s256, q256,
        "pruned union B=256 (device cells)")
    record("pruned_cosine_b256", l256)
    ss16 = search_session_ms(torch, dev, index, q16)
    ss256 = search_session_ms(torch, dev, index, q256)
    log(f"  timing ({card_line()}): B=16 pruned {ms16:.3f} ms a batch (flag "
        f"rate {rate16:.4f}) vs SearchSession {ss16:.3f}; B=256 union "
        f"{ms256:.3f} ({rate256:.4f}) vs SearchSession {ss256:.3f}; "
        f"m_cells={s16.m_cells} union_cells={s256.union_cells}")

    reset(counters)
    qn = [rng.normal(size=(16, a.nfeatures))]
    f0 = s16.flagged_total
    _, _, _, ln = pruned_stream(torch, dev, counters, index, s16, qn,
                                "Gaussian queries (B=16)")
    record("pruned_cosine_gaussian", ln)
    check(s16.flagged_total - f0 == 16, "the Gaussian queries did not flag")
    check(ln["k1"] > 0, "the fallback of the flagged rows launched no K1")

    reset(counters)
    auto = PrunedSearchSession(index, P_UNION, k=K, alpha=ALPHA, cells=card,
                               union_cells=P_AUTO_START, auto_budget=True)
    auto.warmup()
    trail = []
    for _ in range(P_AUTO_BATCHES):
        q = rows[rng.integers(0, n, P_UNION)] * 1.02
        f0 = auto.flagged_total
        _, _, _, la = pruned_stream(torch, dev, counters, index, auto, [q],
                                    "auto-budget union")
        trail.append((auto.flagged_total - f0, auto.union_cells))
    record("pruned_cosine_auto", la)
    log(f"  auto-budget union from {P_AUTO_START} units: (flags, "
        f"union_cells) per batch {trail}; growths {auto.budget_growths}")
    check(auto.budget_growths >= 1 and auto.union_cells > P_AUTO_START,
          "the auto-budget session did not grow")

    path = artifacts_dir() / "cells"
    path.parent.mkdir(parents=True, exist_ok=True)
    _, t_save = timed(torch, dev, lambda: save_cells(card, str(path)))
    loaded, t_load = timed(torch, dev,
                           lambda: load_cells(str(path), device=dev))
    check(all(bool(torch.equal(getattr(loaded, f), getattr(card, f)))
              for f in ("x", "lam", "ids", "cent", "radius", "cosr",
                        "sinr", "lam_lo", "lam_hi")),
          "the reloaded cells differ")
    again = PrunedSearchSession(index, P_UNION, k=K, alpha=ALPHA,
                                cells=loaded)
    same_results("session on reloaded cells vs the original",
                 [again.search(q) for q in q256[:8]], res256[:8])
    size = path.with_suffix(".npz").stat().st_size
    log(f"  cells saved in {t_save:.3f} s and loaded onto the card in "
        f"{t_load:.3f} s ({size / 2**20:.1f} MiB)")
    zero_row_repro(torch, dev)
    zero_rows_at_scale(torch, dev, index, dict(cap=256, seed=SEED))
    del host, loaded
    return by_path, card


def jax_corpus_phase(torch, counters, dev):
    """[4f] The JAX package's pruned corpus (benchmarks/pruned_crossover.py:
    37-58) at 1M x 128, built with ArrowIndex.build, then a B=16 and a
    B=256 pruned session (make_pruned_session, device-built cells) over
    16 batches each of rows x 1.002 from 16 hot regions, every batch held
    against the plain full scan, beside a SearchSession at the same B.
    Returns the launches by path."""
    from arrowspace_torch.index import ArrowIndex
    from arrowspace_torch.pruned import PrunedSearchSession
    log(f"[4f] the JAX package's pruned corpus: {N_ROWS}x{N_FEAT}, "
        f"{J_CENTRES} centres, noise {J_NOISE}")
    rng = np.random.default_rng(7)
    cents = rng.uniform(0.2, 0.8, (J_CENTRES, N_FEAT)).astype(np.float32)
    assign = rng.integers(0, J_CENTRES, N_ROWS)
    rows = cents[assign] + rng.normal(0, J_NOISE, (N_ROWS, N_FEAT)).astype(
        np.float32)
    index, t_build = timed(torch, dev, lambda: ArrowIndex.build(
        rows, eps=EPS, seed=SEED, device=dev))
    log(f"  build_s={t_build:.3f} clusters={index.aspace.n_clusters}")
    hot = np.nonzero(assign < J_HOT)[0]
    by_path = {"k1": {}, "k3": {}}
    for b in (16, P_UNION):
        batches = [rows[rng.choice(hot, b, replace=False)] * 1.002
                   for _ in range(J_BATCHES)]
        reset(counters)
        sess, t_make = timed(torch, dev, lambda: index.make_pruned_session(
            batch_size=b, k=K, alpha=ALPHA, engine="device"))
        sess.warmup()
        _, ms, rate, launches = pruned_stream(
            torch, dev, counters, index, sess, batches,
            f"JAX corpus pruned B={b}")
        for key in by_path:
            by_path[key][f"pruned_jax_corpus_b{b}"] = launches[key]
        ss = search_session_ms(torch, dev, index, batches)
        eager = PrunedSearchSession(index, b, k=K, alpha=ALPHA,
                                    cells=sess.cells, cuda_graph=False)
        eager.warmup()
        got, ms_eager = timed(torch, dev, lambda: [eager.search(q)
                                                   for q in batches])
        same_results(f"B={b} step op by op vs graph-replayed", got,
                     [sess.search(q) for q in batches])
        log(f"  timing ({card_line()}): B={b} pruned {ms:.3f} ms a batch "
            f"(flag rate {rate:.4f}, cells {t_make:.3f} s; the step op by "
            f"op {ms_eager / len(batches) * 1e3:.3f}) vs SearchSession "
            f"{ss:.3f}")
        where_time_goes(torch, ((f"JAX corpus pruned B={b}", sess),),
                        batches, step="4f", drive=lambda s, qs: [
                            s.search(q) for q in qs])
    del index
    return by_path


def wide_pruned_phase(torch, counters, index, batches, dev):
    """[10c] A B=16 pruned session (device-built cells) on the wide 1M x
    768 projected index: 16 batches of the wide session's queries, each
    held against the plain full scan, beside the wide SearchSession at
    B=16.  Returns the launches."""
    log("[10c] pruned B=16 session on the wide projected index")
    q16 = [b[:16] for b in batches]
    reset(counters)
    sess, t_make = timed(torch, dev, lambda: index.make_pruned_session(
        batch_size=16, k=K, alpha=ALPHA, engine="device"))
    sess.warmup()
    _, ms, rate, launches = pruned_stream(torch, dev, counters, index, sess,
                                          q16, "wide pruned B=16")
    ss = search_session_ms(torch, dev, index, q16)
    log(f"  timing ({card_line()}): pruned {ms:.3f} ms a batch (flag rate "
        f"{rate:.4f}, cells {t_make:.3f} s) vs SearchSession {ss:.3f}")
    return launches


def log_stream(name, prof) -> None:
    log(f"  {name}: {prof['chunks']} chunks, wall {prof['wall_s']:.3f} s, "
        f"upload {prof['bytes'] / 2**30:.3f} GiB at "
        f"{prof['upload_gb_s']:.3f} GB/s ({prof['copy_ms']:.3f} ms of "
        f"copies), compute {prof['compute_ms']:.3f} ms, copy hidden behind "
        f"compute {prof['hidden_share']:.4f}")


def streaming_phase(torch, counters, index, session, host, batches, dev,
                    step, kernels_lam, kernels_topk):
    """[4g]/[13c] Out-of-core streaming over ``host`` (the index's rows in
    host memory) in chunks of 2^18 rows from pinned buffers: streamed λ
    against the build's (within TOL), then the streamed top-k of batch 0
    against the index's ``session`` (agree).  Returns the launches of
    each stream."""
    from arrowspace_torch.index import _query_prep
    from arrowspace_torch.ops.streaming import (streamed_lambda_topk,
                                                streamed_taumode_lambdas)
    a = index.aspace
    log(f"[{step}] streaming {host.shape[0]}x{host.shape[1]} ({host.dtype}) "
        f"from host memory, chunks of {STREAM_CHUNK} rows ({card_line()})")
    reset(counters)
    prof = {}
    lam = streamed_taumode_lambdas(host, a.lambda_graph(index.gl), a.taumode,
                                   chunk=STREAM_CHUNK, device=dev,
                                   profile=prof)
    l_lam = {k: counters[k].launches for k in kernels_lam}
    ref = a.lambdas.cpu().numpy()
    err = float((np.abs(lam - ref) / np.maximum(np.abs(ref), 1.0)).max())
    log_stream("streamed λ", prof)
    log(f"  streamed λ vs the build's: max_abs_err={err:.3e}; launches "
        f"{l_lam}")
    check(err <= TOL, f"streamed λ differs from the build's by {err}")

    q = torch.as_tensor(batches[0], device=dev, dtype=torch.float32)
    _, qlam = _query_prep(a, index.gl)[1](q)
    reset(counters)
    prof = {}
    s, i = streamed_lambda_topk(batches[0], qlam.cpu().numpy(), host, ref,
                                ALPHA, K, chunk=STREAM_CHUNK, device=dev,
                                profile=prof)
    l_topk = {k: counters[k].launches for k in kernels_topk}
    log_stream(f"streamed top-k (B={BATCH})", prof)
    rs, ri = list(session.search_stream(batches[:1]))[0]
    agree(f"streamed top-k vs the index's session (launches {l_topk})",
          s, i, rs, ri, exact=true_scores(q, qlam, a.data, a.lambdas,
                                          torch.as_tensor(i, device=dev)))
    check(all(v > 0 for v in l_lam.values())
          and all(l_topk[k] > 0 for k in kernels_topk[:1]),
          f"a kernel of the streamed paths never launched: {l_lam} {l_topk}")
    return l_lam, l_topk


# The mesh phases: four shards of the smoke's indexes on one card, as the
# JAX package's tests run eight virtual CPU devices.  Shards sharing one
# card launch one after another, so these phases measure the cost of the
# per-shard launches and of the merge, not how a mesh of cards scales.
MESH_SHARDS = 4
MESH_1536_BATCHES = 4
MESH_PRUNED_BATCHES = 4
MP_ROWS, MP_FEAT = 262_144, 64
# [5c]: the sharded scan on the card against the same scan in float64 on
# a CPU mesh.  Rows at a float32 rounding of the radius or of a second
# centroid may decide otherwise, and the running means then move by a
# rounding.  At 1M x 128, K 317, the CPU's float32 scan differs from
# float64 in 109 rows (tools/scan_precision.py) and the card's in 106,
# no cluster's size by more than 3 in either: the bounds are about three
# and two times those readings.
BUILD_STEP_ROWS_TOL = 300
BUILD_STEP_SIZE_TOL = 6


def merge_share(torch, name, run, key) -> None:
    """Device time of the ranges named ``key`` (the merge) against all
    device time of ``run()`` under torch.profiler; a measurement only,
    printed as not measured where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_time(e, self_only):
        for attr in (("self_device_time_total", "self_cuda_time_total")
                     if self_only else ("device_time_total",
                                        "cuda_time_total")):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0
    total = sum(dev_time(e, True) for e in events
                if getattr(e, "device_type", None)
                == torch.autograd.DeviceType.CUDA)
    merge = sum(dev_time(e, False) for e in events if e.key == key)
    if total <= 0.0 or merge <= 0.0:
        log(f"  {name}: merge share not measured (no device time recorded)")
        return
    log(f"  {name} (torch.profiler): {key} {merge / 1e3:.3f} ms of "
        f"{total / 1e3:.3f} ms device time, share {merge / total:.4f}")


def hypergraph_phase(torch, counters, index, batches, ms_single, dev):
    """[4h] A λτ-graph ensemble on the seeded cosine index: build_ensemble
    over ensemble_params(base) (6 variants, τ once: K4), the (dk=0,
    fe=1.0) variant's λ against the index's, then ensemble_topk_batch
    (B=2048, k=10, α=0.9) over 16 batches, timed beside the single-chip
    session, 256 queries of batch 0 held to a float64 fused score.
    Returns the launches."""
    from arrowspace_torch.hypergraph import (build_ensemble, ensemble_params,
                                             ensemble_query_lambdas,
                                             ensemble_topk_batch)
    from arrowspace_torch.ops.search import exact_topk, safe_unit
    log(f"[4h] hypergraph ensemble on the seeded cosine index "
        f"({card_line()})")
    a, gl = index.aspace, index.gl
    base = gl.graph_params
    grid = ensemble_params(base)
    # the centroids the index's graph was built from (normalise=False)
    cent = gl.init_data.T.double()
    reset(counters)
    ens, t_build = timed(torch, dev, lambda: build_ensemble(a, cent, grid))
    k4_build = counters["k4"].launches
    check(len(ens) == 6, f"{len(ens)} ensemble variants, not 6")
    same = [j for j, p in enumerate(grid) if p.k == base.k
            and p.topk == base.topk and p.eps == base.eps]
    err = float((ens[same[0]][1] - a.lambdas).abs().max())
    spread = float(torch.stack([lam for _, lam in ens]).std(dim=0).mean())
    log(f"  build_ensemble: {len(ens)} variants in {t_build:.3f} s, K4 "
        f"launches {k4_build}; the (dk=0, fe=1.0) variant's λ vs the "
        f"index's max_abs_err={err:.3e}; mean λ spread across variants "
        f"{spread:.4e}")
    check(k4_build == 1, f"build_ensemble launched K4 {k4_build} times")
    check(err <= TOL, f"the (dk=0, fe=1.0) variant's λ differs by {err}")
    lam_v = torch.stack([lam for _, lam in ens])

    def run(qbs):
        out = []
        for qb in qbs:
            q = torch.as_tensor(qb, device=dev, dtype=torch.float32)
            ql = ensemble_query_lambdas(q, ens, a.taumode)
            s, i = ensemble_topk_batch(q, ql, a.data, lam_v, ALPHA, k=K)
            out.append((s, i, ql))
        return out
    run(batches[:1])                              # first-call costs
    reset(counters)
    sync(torch, dev)
    t0 = time.perf_counter()
    res = run(batches)
    sync(torch, dev)
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    k4_serve = counters["k4"].launches
    log(f"  ensemble_topk_batch: {len(batches)} batches of {BATCH}, "
        f"{ms:.3f} ms a batch beside the single-chip session's "
        f"{ms_single:.3f} ({card_line()}); K4 launches in query "
        f"preparation {k4_serve}")
    s, i, ql = res[0]
    q = torch.as_tensor(batches[0][:256], device=dev, dtype=torch.float64)
    qh, xh = safe_unit(q) * ALPHA, safe_unit(a.data.double())
    lam64, ql64 = lam_v.double(), ql[:, :256].double()

    def fused(rows=None):
        x = xh if rows is None else xh[rows]
        lam = lam64 if rows is None else lam64[:, rows]
        if rows is None:
            cos = qh @ x.T
            dl = sum((ql64[v][:, None] - lam[v][None, :]).abs()
                     .clamp_max(1.0) for v in range(len(ens)))
        else:
            cos = (x * qh[:, None, :]).sum(-1)
            dl = sum((ql64[v][:, None] - lam[v]).abs().clamp_max(1.0)
                     for v in range(len(ens)))
        return cos + (1.0 - ALPHA) * (1.0 - dl / len(ens))
    ref_s, ref_i = exact_topk(fused(), K)
    agree("ensemble_topk_batch vs a float64 fused score (256 queries)",
          s[:256], i[:256], ref_s, ref_i, exact=fused(i[:256]))
    check(all(r[0].shape == (BATCH, K) and bool(torch.isfinite(r[0]).all())
              for r in res), "ensemble output shape/finiteness")
    merge_share(torch, "ensemble_topk_batch, 2 batches",
                lambda: run(batches[:2]), "arrowspace::ensemble_select")
    del ens, lam_v, xh
    return {"select_tau": k4_build + k4_serve}


def mesh_stream(torch, counters, name, sess, batches, ref, dev, exact=None):
    """Warm-up, then the stream of a mesh session, its launches read right
    after it (counters set to 0 before the warm-up); every batch held to
    ``ref`` (the single-chip session's results) by agree, batch 0 with
    the float64 scores ``exact(ids)`` of its returned ids when given.
    Returns (launches, ms a batch, stream repairs)."""
    reset(counters)
    sess.warmup()
    rep0 = (counters["repair"].calls, counters["erepair"].calls)
    sync(torch, dev)
    t0 = time.perf_counter()
    res = list(sess.search_stream(batches))
    sync(torch, dev)
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    launches = {key: counters[key].launches
                for key in ("k1", "k2", "k3", "k4", "k6")}
    reps = (counters["repair"].calls - rep0[0],
            counters["erepair"].calls - rep0[1])
    tol = E_TOL if sess.__class__.__name__.startswith("DistributedEnergy") \
        else TOL
    err = 0.0
    for b, ((s, i), (rs, ri)) in enumerate(zip(res, ref)):
        err = max(err, agree(f"{name} batch {b}", s, i, rs, ri, tol=tol,
                             exact=exact(i) if exact and b == 0 else None,
                             quiet=b > 0))
    log(f"  {name}: {len(batches)} batches of {BATCH}, {ms:.3f} ms a batch; "
        f"launches {launches}; repairs in the stream (cosine, energy) "
        f"{reps}; max_abs_err vs single-chip over all batches {err:.3e}")
    return launches, ms, reps


def mesh_phase(torch, counters, index, ref, ms_single, batches, cells,
               dev):
    """[4i] The seeded cosine index on a mesh of MESH_SHARDS shards on one
    card: the sharded λ (K2 per shard), a binned and a merge
    DistributedSearchSession (16 batches each, held to the single-chip
    session, the planted duplicates of batch 0 through the mesh repair
    and its K3 exact pass), the (2, 2) hierarchical merge against the
    1-D one, and the cell screen of [4e] over the mesh, whose flagged
    rows re-run through the mesh's K3.  Returns the launches by path."""
    from arrowspace_torch import parallel as par
    from arrowspace_torch.index import _query_prep
    from arrowspace_torch.ops.search import batched_lambda_aware_topk
    a = index.aspace
    mesh = par.make_mesh(devices=[dev] * MESH_SHARDS)
    shard_n = a.nitems // MESH_SHARDS
    log(f"[4i] mesh of {MESH_SHARDS} shards on {dev} (shard {shard_n} rows; "
        f"shards on one card measure launch and merge cost, not scaling; "
        f"{card_line()})")
    out = {}
    reset(counters)
    lam, t_lam = timed(torch, dev, lambda: par.sharded_compute_taumode_lambdas(
        a.data, a.lambda_graph(index.gl), a.taumode, mesh, use_pallas=True))
    out["mesh_lambda"] = {"k2": counters["k2"].launches}
    err = float((lam.local() - a.lambdas).abs().max())
    log(f"  sharded λ (K2 per shard) in {t_lam:.3f} s, launches "
        f"{out['mesh_lambda']}; vs the build's λ max_abs_err={err:.3e}")
    check(out["mesh_lambda"]["k2"] == MESH_SHARDS,
          "the sharded λ did not launch K2 once per shard")
    check(err <= TOL, f"the sharded λ differs from the build's by {err}")
    del lam

    prep = _query_prep(a, index.gl)[1]
    q0 = torch.as_tensor(batches[0], device=dev, dtype=torch.float32)
    _, qlam0 = prep(q0)

    def exact(ids):
        return true_scores(q0, qlam0, a.data, a.lambdas,
                           torch.as_tensor(ids, device=dev))
    for kind in ("binned", "merge"):
        sess = par.DistributedSearchSession.from_index(
            index, mesh, BATCH, k=K, alpha=ALPHA, kernel=kind)
        check(sess.kernel == kind, f"mesh session kernel {sess.kernel}")
        launches, ms, reps = mesh_stream(
            torch, counters, f"mesh {kind} session", sess, batches, ref,
            dev, exact=exact)
        log(f"  mesh {kind} session {ms:.3f} ms a batch beside the "
            f"single-chip session's {ms_single:.3f}")
        if kind == "binned":
            check(launches["k1"] == MESH_SHARDS * (N_BATCHES + 1),
                  f"the mesh binned session launched K1 {launches['k1']} "
                  "times, not once per shard, batch and warm-up")
            check(reps[0] >= 1, "the mesh binned stream repaired no row")
            check(launches["k3"] >= MESH_SHARDS,
                  "the overflowing row took no K3 exact pass")
        else:
            check(launches["k3"] == MESH_SHARDS * (N_BATCHES + 1)
                  and launches["k1"] == 0,
                  f"the mesh merge session launched {launches}")
        out[f"mesh_cosine_{kind}"] = launches
        merge_share(torch, f"mesh {kind} session, {N_PROFILE} batches",
                    lambda: list(sess.search_stream(batches[:N_PROFILE])),
                    "arrowspace::mesh_merge")
        del sess

    q = q0[:256]
    ql = qlam0[:256]
    mesh2 = par.make_mesh_2d(2, MESH_SHARDS // 2, devices=[dev] * MESH_SHARDS)
    (s1, i1), t1 = timed(torch, dev, lambda: par.distributed_lambda_aware_topk(
        q, ql, a.data, a.lambdas, ALPHA, K, mesh))
    (s2, i2), t2 = timed(torch, dev,
                         lambda: par.distributed_lambda_aware_topk_2d(
                             q, ql, a.data, a.lambdas, ALPHA, K, mesh2))
    log(f"  (2, {MESH_SHARDS // 2}) hierarchical merge of 256 queries in "
        f"{t2:.3f} s vs the 1-D merge's {t1:.3f} s: ids equal "
        f"{bool(torch.equal(i1, i2))}, scores equal "
        f"{bool(torch.equal(s1, s2))}")
    check(bool(torch.equal(i1, i2) and torch.equal(s1, s2)),
          "the hierarchical merge differs from the 1-D merge")

    # the queries and their λ are made before the timed window, and the
    # plain reference is computed after it: the window holds the screen
    # and its K3 fallback alone
    rng = np.random.default_rng(SEED + 40)
    screen_q = []
    for _ in range(MESH_PRUNED_BATCHES):
        qb = a.data[torch.as_tensor(rng.integers(0, a.nitems, 16),
                                    device=dev)] * 1.02
        screen_q.append((qb, prep(qb)[1]))
    reset(counters)
    flagged, results = 0, []
    sync(torch, dev)
    t0 = time.perf_counter()
    for qb, qlb in screen_q:
        s, i, fl = par.distributed_pruned_topk(qb, qlb, cells, ALPHA, K,
                                               mesh)
        rows = torch.nonzero(fl)[:, 0]
        flagged += int(rows.numel())
        if rows.numel():
            fs, fi = par.distributed_lambda_aware_topk(
                qb[rows], qlb[rows], a.data, a.lambdas, ALPHA, K, mesh,
                kernel="merge")
            s[rows], i[rows] = fs.to(s.dtype), fi
        results.append((s, i))
    sync(torch, dev)
    ms = (time.perf_counter() - t0) / MESH_PRUNED_BATCHES * 1e3
    for b, ((qb, qlb), (s, i)) in enumerate(zip(screen_q, results)):
        ps, pi = batched_lambda_aware_topk(qb, qlb, a.data, a.lambdas,
                                           ALPHA, k=K)
        agree(f"mesh pruned batch {b} (B=16) vs the plain full scan", s, i,
              ps, pi, exact=true_scores(qb, qlb, a.data, a.lambdas, i),
              quiet=True)
    out["mesh_pruned"] = {"k1": counters["k1"].launches,
                          "k3": counters["k3"].launches}
    log(f"  mesh cell screen ([4e] device cells, m_cells=8 per shard): "
        f"{MESH_PRUNED_BATCHES} batches of 16, {flagged} of "
        f"{16 * MESH_PRUNED_BATCHES} rows flagged and re-run through the "
        f"mesh's K3, {ms:.3f} ms a batch; launches {out['mesh_pruned']}")
    return out


def mesh_energy_phase(torch, counters, index, exact, batches, dev):
    """[8c] A DistributedEnergySearchSession of MESH_SHARDS shards over the
    energy index: the z-plane made per shard, K6 per shard, the planted
    duplicates of batch 0 through the mesh energy repair; every batch
    held to the single-chip exact session.  Returns the launches."""
    from arrowspace_torch import parallel as par
    mesh = par.make_mesh(devices=[dev] * MESH_SHARDS)
    log(f"[8c] mesh energy session: {MESH_SHARDS} shards on {dev} "
        f"({card_line()})")
    ref, ms_single = stream_ms(torch, dev, exact, batches)
    sess = par.DistributedEnergySearchSession.from_index(
        index, mesh, BATCH, k=K, w_lambda=E_WL, w_dirichlet=E_WD)
    check(sess.kernel == "binned", f"mesh energy kernel {sess.kernel}")
    launches, ms, reps = mesh_stream(torch, counters, "mesh energy session",
                                     sess, batches, ref, dev)
    log(f"  mesh energy session {ms:.3f} ms a batch beside the single-chip "
        f"exact session's {ms_single:.3f}")
    check(launches["k6"] == MESH_SHARDS * (N_BATCHES + 1),
          f"the mesh energy session launched K6 {launches['k6']} times")
    check(reps[1] >= 1, "the mesh energy stream repaired no row")
    merge_share(torch, f"mesh energy session, {N_PROFILE} batches",
                lambda: list(sess.search_stream(batches[:N_PROFILE])),
                "arrowspace::mesh_merge")
    return launches


def mesh_1536_phase(torch, counters, index, session, batches, dev):
    """[13d] A "merge" DistributedSearchSession of MESH_SHARDS shards over
    the 1536-wide index (K3 per shard), MESH_1536_BATCHES batches held to
    the single-chip "merge" session.  Returns the launches."""
    from arrowspace_torch import parallel as par
    mesh = par.make_mesh(devices=[dev] * MESH_SHARDS)
    log(f"[13d] mesh merge session over the 1536-wide index: "
        f"{MESH_SHARDS} shards on {dev} ({card_line()})")
    qbs = batches[:MESH_1536_BATCHES]
    ref, ms_single = stream_ms(torch, dev, session, qbs)
    sess = par.DistributedSearchSession.from_index(index, mesh, BATCH, k=K,
                                                   alpha=ALPHA)
    check(sess.kernel == "merge", f"1536 mesh session kernel {sess.kernel}")
    launches, ms, _ = mesh_stream(torch, counters, "1536 mesh merge session",
                                  sess, qbs, ref, dev)
    log(f"  1536 mesh merge session {ms:.3f} ms a batch beside the "
        f"single-chip merge session's {ms_single:.3f}")
    check(launches["k3"] == MESH_SHARDS * (MESH_1536_BATCHES + 1)
          and launches["k1"] == 0,
          f"the 1536 mesh session launched {launches}")
    merge_share(torch, "1536 mesh merge session, 2 batches",
                lambda: list(sess.search_stream(qbs[:2])),
                "arrowspace::mesh_merge")
    return launches


def build_step_phase(torch, counters, index, rows, canon, dev):
    """[5c] distributed_build_step on the 1M x 128 corpus over
    MESH_SHARDS shards, without sampling, at the unseeded build's K and
    radius.  Its scan is held to the same sharded scan run in float64 on
    a CPU mesh of MESH_SHARDS shards (the same serialisation, so the
    same centroid order): equal n_c, at most BUILD_STEP_ROWS_TOL rows
    assigned otherwise and no cluster's size off by more than
    BUILD_STEP_SIZE_TOL; the sizes sum to the assigned rows.  The
    single-chip chunked scan at the same K, radius and sampling (its
    engine on the card) is printed beside it (another serialisation; at
    the cap the scan's rules drop a row beyond the relaxed radius of its
    nearest centroid, on one chip as on the mesh).  Then the sharded λ
    (K2 per shard) and the top-k of 16 queries; its seconds.  Returns
    the launches."""
    from arrowspace_torch import parallel as par
    from arrowspace_torch.builder import ArrowSpaceBuilder
    from arrowspace_torch.clustering import _incremental_clustering_chunked
    from arrowspace_torch.sampling import SamplerType
    from arrowspace_torch.taumode import TauMode
    a, b = index.aspace, index.builder
    n = a.nitems
    mesh = par.make_mesh(devices=[dev] * MESH_SHARDS)
    k_max, radius = b.cluster_max_clusters, b.cluster_radius
    log(f"[5c] distributed_build_step {n}x{a.nfeatures} over "
        f"{MESH_SHARDS} shards on {dev}, K={k_max} radius={radius:.6g}, "
        f"no sampling ({card_line()})")
    builder = ArrowSpaceBuilder(device=dev)
    builder.sampling = None
    info = {}
    q = rows[:16] * 1.01
    reset(counters)
    (cent, lam, s, i), t = timed(
        torch, dev, lambda: par.distributed_build_step(
            a.data, builder, q, TauMode.median(), index.gl.graph_params, K,
            mesh, max_clusters=k_max, radius=radius, clustering=info))
    launches = {key: counters[key].launches for key in ("k1", "k2", "k3")}
    assign = info["assignments"].array
    sizes = np.asarray(info["sizes"])
    assigned = int((assign >= 0).sum())
    hits = int((canon[i[:, 0].cpu().numpy()] == canon[:16]).sum())

    ref_builder = ArrowSpaceBuilder(device="cpu")
    ref_builder.sampling = None
    t0 = time.perf_counter()
    c64, a64, s64 = par.sharded_incremental_clustering(
        a.data.cpu().double(), ref_builder, k_max, radius,
        SamplerType.simple(1.0).make(seed=1),
        par.make_mesh(devices=["cpu"] * MESH_SHARDS))
    t64 = time.perf_counter() - t0
    a64, s64 = a64.array, np.asarray(s64)
    same_nc = cent.shape[0] == c64.shape[0]
    rows_off = int((assign != a64).sum())
    size_off = int(np.abs(sizes - s64).max()) if same_nc else -1

    one = ArrowSpaceBuilder(device=dev)
    one.sampling = None
    (c1, a1, _s1), t1 = timed(torch, dev, lambda: (
        _incremental_clustering_chunked(
            one, rows, a.nfeatures, k_max, radius,
            SamplerType.simple(1.0).make(seed=1), device_data=a.data)))
    assigned1 = int((a1.array >= 0).sum())
    log(f"  build step {t:.3f} s (sharded clustering {info['seconds']:.3f} "
        f"s): n_c={cent.shape[0]}, assigned {assigned} of {n}, sizes sum "
        f"{int(sizes.sum())}; the float64 CPU mesh scan {t64:.3f} s: n_c="
        f"{c64.shape[0]}, assigned {int((a64 >= 0).sum())}, {rows_off} "
        f"rows assigned otherwise (at most {BUILD_STEP_ROWS_TOL}), largest "
        f"size difference {size_off} (at most {BUILD_STEP_SIZE_TOL}); "
        f"single-chip chunked scan {t1:.3f} s: n_c={c1.shape[0]}, assigned "
        f"{assigned1}; the unseeded build's n_c {a.n_clusters} (sampling "
        f"0.6); self-match {hits}/16; launches {launches}")
    check(bool(((assign == -1) | ((assign >= 0) & (assign < cent.shape[0])))
               .all()) and int(sizes.sum()) == assigned,
          "the sharded build's assignments and sizes disagree")
    check(same_nc and rows_off <= BUILD_STEP_ROWS_TOL
          and size_off <= BUILD_STEP_SIZE_TOL,
          "the sharded build differs from its float64 CPU mesh scan")
    check(launches["k2"] == MESH_SHARDS,
          "the build step's λ did not launch K2 once per shard")
    check(hits == 16, f"build step self-match {hits}/16")
    check(bool(torch.isfinite(s).all()) and bool(
        torch.isfinite(lam.local()).all()), "build step output not finite")
    return launches


def multiprocess_phase(torch, dev):
    """[4j] The multi-process runtime with one process (NCCL refuses two
    ranks on one card): run_multiprocess_dryrun launches one mp_worker
    that joins an NCCL group of world size 1 on cuda:0 and runs the
    sharded build, λ, the hierarchical top-k and the mesh sessions on
    four shards at MP_ROWS x MP_FEAT, every check asserted inside it.
    Returns its launches."""
    from arrowspace_torch import parallel as par
    log(f"[4j] multi-process runtime: 1 process, NCCL, 4 shards on "
        f"cuda:0, {MP_ROWS}x{MP_FEAT} ({card_line()})")
    t0 = time.perf_counter()
    try:
        r = par.run_multiprocess_dryrun(
            num_processes=1, local_devices=4, n_rows=MP_ROWS, f=MP_FEAT,
            timeout=300, device=f"cuda:{dev.index}")
    except RuntimeError as exc:
        raise SmokeFailure(f"the multi-process dry run failed: {exc}")
    wall = time.perf_counter() - t0
    log(f"  worker: process_count={r['process_count']} shards="
        f"{r['global_devices']} centroids={r['centroids']} build_s="
        f"{r['build_s']} self_match={r['self_match']} session="
        f"{r['session_self_match']} binned={r['binned_self_match']} "
        f"hierarchical_equal={r['hierarchical_topk_equal']}; launches "
        f"{r['launches']}; {wall:.3f} s with the process start")
    check(r["ok"] and r["process_count"] == 1 and r["device"].startswith(
        "cuda"), "the dry run reported " + str(
            {k: v for k, v in r.items() if not k.endswith("_ids")}))
    check(r["self_match"] == r["session_self_match"] ==
          r["binned_self_match"] == "16/16", "dry run self-match below 16/16")
    check(r["launches"]["bintopk"] > 0 and r["launches"]["taulambda"] > 0
          and r["launches"]["energy_bintopk"] > 0,
          f"the dry run launched {r['launches']}")
    # one process holds every shard: its binned sessions repair through
    # the strided mesh repair, as [4i] and [8c] do
    log(f"  strided mesh repairs in the worker: {r['strided_repairs']}")
    check(r["strided_repairs"]["lambda"] > 0
          and r["strided_repairs"]["energy"] > 0,
          "the dry run never took the strided mesh repair")
    return r["launches"]


def bf16_operands(torch, xh, q_np, qlam, dev):
    """The bf16 operands of a query batch against a prepared bf16 corpus
    xh (prepare_binned_corpus(use_bf16=True)): (qh, qlam, c1), α·q̂
    prescaled in float32 and then cast, as the wrappers do."""
    from arrowspace_torch.ops.search import operand_query
    q = torch.as_tensor(q_np, device=dev, dtype=torch.float32)
    qh, c1 = operand_query(q, ALPHA, torch.float32, xh)
    return qh, qlam.float().contiguous(), c1


def bf16_scan(torch, xh, xl, n, qh, qlam, c1):
    """The plain bf16 full scan: the same bf16 operands, a float32
    product (dot_plane), the stable two-key sort; (scores, ids) with c1
    restored."""
    from arrowspace_torch.ops.search import dot_plane, exact_topk, \
        lambda_term
    s, i = exact_topk(dot_plane(qh, xh[:n]) - lambda_term(qlam, xl[:n], c1),
                      K)
    return s + c1, i


def bf16_session(torch, counters, index, session, batches, dev, step, name):
    """A bf16 SearchSession of the index beside its float32 session
    ``session``: both timed over the same 16 batches in this call (the
    float32 one first), the bf16 one with the counters set to 0 just
    before its construction and read right after its stream.  It must
    resolve "binned" (K1's bf16 gate admits F <= 1536) and launch K1's
    bf16 mode once a batch and for its warm-up, K3's bf16 mode for batch
    0's overflowing repair, and no float32 K1 or K3.  256 queries of
    batch 0 are held against the plain bf16 full scan (agree, scores
    against float64 of the bf16 operands too); the top-10 overlap with
    the float32 session is logged, not gated.  Returns (session, its
    launches, ms a batch, the float32 session's ms)."""
    from arrowspace_torch.index import _query_prep
    from arrowspace_torch.ops import bintopk as bt

    log(f"[{step}] bf16 session on the {name} index")
    ref, ms32 = stream_ms(torch, dev, session, batches)
    reset(counters)
    sess = index.make_search_session(batch_size=BATCH, k=K, alpha=ALPHA,
                                     precision="bf16")
    check((sess.kernel, sess.precision) == ("binned", "bf16"),
          f"bf16 session: {sess.kernel} {sess.precision}")
    sess.warmup()
    got, ms16 = stream_ms(torch, dev, sess, batches)
    launches = {key: counters[c].launches for key, c in (
        ("bintopk_bf16", "k1b"), ("merge_topk_bf16", "k3b"),
        ("bintopk", "k1"), ("merge_topk", "k3"))}
    log(f"  launches: {launches}; ms a batch: bf16 {ms16:.3f}, float32 "
        f"{ms32:.3f}")
    check(launches["bintopk_bf16"] == N_BATCHES + 1,
          "K1's bf16 mode did not launch once a batch and for the warm-up")
    check(launches["merge_topk_bf16"] >= 1,
          "batch 0's repair never reached K3's bf16 mode")
    check(launches["bintopk"] == 0 and launches["merge_topk"] == 0,
          "the bf16 session launched a float32 kernel")
    check(all(r[0].shape == (BATCH, K) and np.isfinite(r[0]).all()
              for r in got), "bf16 session output shape/finiteness")
    a = index.aspace
    q = torch.as_tensor(batches[0][:256], device=dev, dtype=torch.float32)
    _, qlam = _query_prep(a, index.gl)[1](q)
    xh, xl = bt.prepare_binned_corpus(a.data, a.lambdas, use_bf16=True)
    qh, qlam, c1 = bf16_operands(torch, xh, batches[0][:256], qlam, dev)
    ps, pi = bf16_scan(torch, xh, xl, a.nitems, qh, qlam, c1)
    s0, i0 = got[0][0][:256], got[0][1][:256]
    agree(f"bf16 session vs plain bf16 full scan ({name}, 256 queries)",
          s0, i0, ps, pi, exact=exact_scores(
              qh, qlam, xh, xl, c1, torch.as_tensor(i0, device=dev)) + c1)
    overlap = np.mean([len(set(r16) & set(r32)) / K for r16, r32 in zip(
        np.concatenate([g[1] for g in got]),
        np.concatenate([r[1] for r in ref]))])
    gap = max(float(np.abs(g[0] - r[0]).max()) for g, r in zip(got, ref))
    log(f"  top-{K} overlap with the float32 session over {N_BATCHES} "
        f"batches: {overlap:.4f}; max |score bf16 - float32| {gap:.3e}")
    return sess, launches, ms16, ms32


def k1_bf16_vs_plain(torch, index, batches, dev, name):
    """K1's bf16 mode against its plain version on batch 0 of the index
    (the session's shapes), flushed, det too; its time, the plain
    version's, its bound (bf16_bounds) and torch.matmul of the bf16
    product alone, as context; what the launch runs (``config``: query
    block, ring stages, shared bytes, registers and spilled bytes, from
    the library).  Returns (record, the operands)."""
    from arrowspace_torch.ops import bintopk as bt

    log(f"  bf16 kernels against their plain versions ({name})")
    a = index.aspace
    n = a.nitems
    xh, xl = bt.prepare_binned_corpus(a.data, a.lambdas, use_bf16=True)
    qlam = a.prepare_query_items_batch(batches[0], index.gl)
    qh, qlam, c1 = bf16_operands(torch, xh, batches[0], qlam, dev)
    depth, bins = bt.binned_topk_depth_for(K), bt.bins_target(K)
    chunks = bt._default_chunks(bt.grid_ctas(BATCH, bins, qh.shape[1], True),
                                -(-n // bins), dev)
    args = (qh, qlam, xh, xl, c1, n)
    kw = dict(depth=depth, bins=bins, chunks=chunks)
    out_k = bt.flush_pool(*bt.binned_topk_pool(*args, **kw), K, c1)
    out_p = bt.flush_pool(*bt.binned_topk_pool_plain(*args, **kw), K, c1)
    err = agree(f"K1 bf16 {name} {BATCH}x{n}x{qh.shape[1]} chunks={chunks}",
                out_k[0], out_k[1], out_p[0], out_p[1],
                exact=exact_scores(qh, qlam, xh, xl, c1, out_k[1]) + c1)
    det_err = float((out_k[3] - out_p[3]).abs().max())
    check(det_err <= TOL, f"K1 bf16 det disagrees at {name}: {det_err}")
    pool = bt.binned_topk_pool(*args, **kw)
    b_ms, b_by = bf16_bounds(BATCH, n, qh.shape[1], 5,
                             nbytes(qh, qlam, xh[:n], xl[:n], *pool))
    rec = dict(max_abs_err=max(err, det_err), bound_ms=b_ms, bound_by=b_by,
               library_ms=None,
               ms=cuda_ms(lambda: bt.binned_topk_pool(*args, **kw)),
               plain_ms=cuda_ms(lambda: bt.binned_topk_pool_plain(
                   *args, **kw), reps=2),
               matmul_ms=matmul_ms(torch, qh, xh[:n]),
               config=bt.bf16_config(qh.shape[1], BATCH, depth))
    log(f"    K1 bf16 {name}: ms={rec['ms']:.3f} plain_ms="
        f"{rec['plain_ms']:.3f} bound_ms={b_ms:.3f} ({b_by}) bf16 matmul "
        f"context {rec['matmul_ms']:.3f} ms; flags kernel="
        f"{int(out_k[2].sum())} plain={int(out_p[2].sum())}")
    qb = rec["config"]["query_block"]
    l2 = -(-BATCH // qb) * n * qh.shape[1] * 2
    log(f"    K1 bf16 {name} launch: {rec['config']}; corpus read from L2 "
        f"{l2 / 1e9:.3f} GB a batch, {l2 / rec['ms'] / 1e9:.3f} TB/s")
    check(rec["config"]["stages"] >= 3 and rec["config"]["spill_bytes"] == 0,
          f"K1 bf16 {name}: ring below 3 stages or spilled registers")
    return rec, args


def k3_bf16_record(torch, qh, qlam, xh, xl, c1, n, name):
    """K3's bf16 mode against its plain version (k3_vs_plain), with what
    its launch runs (``config``: query block, tile rows, ring stages,
    shared bytes, registers, spilled bytes, query residency, CTAs an SM,
    from the library; a ring below 3 stages or a spilled register fails)
    and the bytes its CTAs read from L2 a batch: the corpus (B / 64)·N·F·2
    and, where the query block is streamed, its slices B·N·F·2 / (tile
    rows)."""
    from arrowspace_torch.ops import topk as tk
    bsz, f = qh.shape
    rec = k3_vs_plain(torch, qh, qlam, xh, xl, c1, n, name)
    rec["config"] = cfg = tk.merge_bf16_config(f, K)
    l2 = -(-bsz // cfg["query_block"]) * n * f * 2
    if not cfg["resident"]:
        l2 += bsz * n * f * 2 / cfg["tile_rows"]
    log(f"    {name} launch: {cfg}; read from L2 {l2 / 1e9:.3f} GB a "
        f"batch, {l2 / rec['ms'] / 1e9:.3f} TB/s")
    check(cfg["stages"] >= 3 and cfg["spill_bytes"] == 0,
          f"{name}: ring below 3 stages or spilled registers")
    return rec


def k3_bf16_vs_plain(torch, qh, qlam, xh, xl, c1, n):
    """K3's bf16 mode against its plain version on the whole batch and at
    a repair's single row (k3_bf16_record): its record, without
    launches."""
    k3 = k3_bf16_record(torch, qh, qlam, xh, xl, c1, n, "K3 bf16 merge_topk")
    k3["at_repair"] = k3_bf16_record(torch, qh[:1], qlam[:1], xh, xl, c1, n,
                                     "K3 bf16 merge_topk at a repair's row")
    return k3


def merge_bf16_phase(torch, counters, index, batches, ops, ms_binned, dev):
    """[14c] A bf16 session on the 1536-wide index that resolves "merge",
    the kind a bf16 session takes above K1's bf16 gate (F > 1536): made
    through make_search_session with the gate answering "merge", so each
    batch runs ops.topk.fused_lambda_topk(use_bf16=True, prepared=True)
    as such a session does.  The counters are set to 0 just before the
    session is made and read right after its 16-batch stream: K3's bf16
    mode once a batch and for the warm-up, no other top-k kernel.  256
    queries of batch 0 are held against the plain bf16 full scan; then
    K3's bf16 mode against its plain version at 1M x 1536 on batch 0's
    bf16 operands ``ops`` (k3_bf16_record).  Returns (its launches, ms a
    batch, the record)."""
    import arrowspace_torch.index as index_mod
    from arrowspace_torch.index import _query_prep
    from arrowspace_torch.ops import bintopk as bt

    log("[14c] bf16 \"merge\" session on the 1536-wide index (K3's bf16 "
        "mode)")
    reset(counters)
    gate = index_mod.session_kernel_kind
    index_mod.session_kernel_kind = lambda *a: "merge"
    try:
        sess = index.make_search_session(batch_size=BATCH, k=K, alpha=ALPHA,
                                         precision="bf16")
    finally:
        index_mod.session_kernel_kind = gate
    check((sess.kernel, sess.precision) == ("merge", "bf16"),
          f"bf16 merge session: {sess.kernel} {sess.precision}")
    sess.warmup()
    got, ms = stream_ms(torch, dev, sess, batches)
    launches = {key: counters[c].launches for key, c in (
        ("merge_topk_bf16", "k3b"), ("bintopk_bf16", "k1b"),
        ("bintopk", "k1"), ("merge_topk", "k3"))}
    log(f"  launches: {launches}; ms a batch: bf16 merge {ms:.3f}, bf16 "
        f"binned (K1) {ms_binned:.3f}")
    check(launches["merge_topk_bf16"] == N_BATCHES + 1,
          "K3's bf16 mode did not launch once a batch and for the warm-up")
    check(launches["bintopk_bf16"] == launches["bintopk"]
          == launches["merge_topk"] == 0,
          "the bf16 merge session launched another top-k kernel")
    check(all(r[0].shape == (BATCH, K) and np.isfinite(r[0]).all()
              for r in got), "bf16 merge session output shape/finiteness")
    a = index.aspace
    q = torch.as_tensor(batches[0][:256], device=dev, dtype=torch.float32)
    _, qlam = _query_prep(a, index.gl)[1](q)
    xh, xl = bt.prepare_binned_corpus(a.data, a.lambdas, use_bf16=True)
    qh, qlam, c1 = bf16_operands(torch, xh, batches[0][:256], qlam, dev)
    ps, pi = bf16_scan(torch, xh, xl, a.nitems, qh, qlam, c1)
    s0, i0 = got[0][0][:256], got[0][1][:256]
    agree("bf16 merge session vs plain bf16 full scan (1536-wide, 256 "
          "queries)", s0, i0, ps, pi, exact=exact_scores(
              qh, qlam, xh, xl, c1, torch.as_tensor(i0, device=dev)) + c1)
    del sess, xh, xl, ps, pi
    torch.cuda.empty_cache()
    rec = k3_bf16_record(torch, *ops, "K3 bf16 merge_topk at 1536")
    return launches["merge_topk_bf16"], ms, rec


def live_bf16_phase(torch, counters, index, static, batches, rows, dev):
    """A live bf16 session on the cosine index (capacity n + 8192): its
    first BF16_LIVE_BATCHES batches bitwise the static bf16 session's,
    then BF16_LIVE_ADD rows added, then BF16_LIVE_AFTER batches held by
    buffer position against the plain bf16 scan of the live rows (bf16
    operands made anew from the live raw rows and λ).  Counters are read
    around each stream.  Returns its K1 bf16 launches."""
    from arrowspace_torch.ops import bintopk as bt

    n0 = index.nitems
    log(f"[3d] live bf16 session on the cosine index, capacity {n0 + 8192}")
    live = index.make_live_session(batch_size=BATCH, k=K, alpha=ALPHA,
                                   capacity=n0 + 8192, precision="bf16")
    check((live.kernel, live.precision) == ("binned", "bf16"),
          f"live bf16 session: {live.kernel} {live.precision}")
    live.warmup()
    ref = list(static.search_stream(batches[:BF16_LIVE_BATCHES]))
    reset(counters)
    got, ms = stream_ms(torch, dev, live, batches[:BF16_LIVE_BATCHES])
    k1b = counters["k1b"].launches
    check(k1b == BF16_LIVE_BATCHES and counters["k1"].launches == 0,
          f"live bf16 stream: K1 bf16 {k1b}, float32 "
          f"{counters['k1'].launches}")
    same_results("live bf16 session vs the static bf16 session", got, ref)
    added = more_rows(BF16_LIVE_ADD, N_FEAT, SEED + 20)
    _, t = timed(torch, dev, lambda: live.add(added))
    qb = live_batches(np.concatenate([rows[:4096], added]), SEED + 21,
                      BF16_LIVE_AFTER)
    reset(counters)
    res = list(live.search_stream(qb))
    check(counters["k1b"].launches == BF16_LIVE_AFTER,
          "live bf16 after add: K1 bf16 not once a batch")
    k1b += counters["k1b"].launches
    n = live.nitems
    xh, xl = bt.prepare_binned_corpus(live._raw[:n], live._lam[:n],
                                      use_bf16=True)
    for b, (q_np, r) in enumerate(zip(qb, res)):
        q = torch.as_tensor(q_np[:256], device=dev, dtype=torch.float32)
        _, qlam = live._prepare(q)
        qh, qlam, c1 = bf16_operands(torch, xh, q_np[:256], qlam, dev)
        ps, pi = bf16_scan(torch, xh, xl, n, qh, qlam, c1)
        pos = live_positions(live, r[1][:256])
        agree(f"live bf16 after add {BF16_LIVE_ADD}, batch {b} vs plain "
              "bf16 scan of the live rows", r[0][:256], pos, ps, pi,
              exact=exact_scores(qh, qlam, xh, xl, c1,
                                 torch.as_tensor(pos, device=dev)) + c1)
    log(f"  live bf16: {ms:.3f} ms a batch; add {BF16_LIVE_ADD} rows "
        f"{t * 1e3:.3f} ms; nitems={n}")
    return k1b


# The migration surface ([15]): the JAX package's names and options that
# the port serves, on the indexes above.  BELOW_ROWS lies under
# core.BINNED_MIN_ITEMS, where only use_pallas=True takes K1.
BELOW_ROWS = 60_000
MERGE_PC_BATCHES = 4


def count(counters, key) -> int:
    c = counters[key]
    return c.launches if hasattr(c, "launches") else c.calls


def resident_bytes(torch, dev, make):
    """(make(), the bytes it left allocated on the card:
    torch.cuda.memory_allocated after minus before)."""
    sync(torch, dev)
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    obj = make()
    sync(torch, dev)
    after = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    return obj, after - before


def prepare_corpus_pair(torch, counters, name, make, batches, dev, kernels,
                        plane_bytes):
    """A session made by make(True) (prepare_corpus=True) and one by
    make(False), each with the bytes its construction left resident, both
    warmed up and fed ``batches``; the counters are set to 0 just before
    the False session's stream and read just after it.  Both streams must
    be bitwise equal, the True session must hold at least the prepared
    plane's ``plane_bytes`` and the False one less than 1 % of it, and
    every counter of ``kernels`` ({name: (counter key, least count)})
    must reach its count.  Returns (the False stream's counts, ms a batch
    of each, resident bytes of each)."""
    prep, b_prep = resident_bytes(torch, dev, lambda: make(True))
    raw, b_raw = resident_bytes(torch, dev, lambda: make(False))
    check(prep.kernel == raw.kernel, f"{name}: kinds {prep.kernel} and "
          f"{raw.kernel} differ")
    log(f"  {name} ({raw.kernel}): resident bytes after construction "
        f"prepare_corpus=True {b_prep} ({b_prep / plane_bytes:.4f} x the "
        f"prepared plane's {plane_bytes}), prepare_corpus=False {b_raw}")
    if dev.type == "cuda":
        check(b_prep >= plane_bytes,
              f"{name}: the prepared session holds {b_prep} bytes")
        check(b_raw < plane_bytes // 100,
              f"{name}: the unprepared session holds {b_raw} bytes")
    prep.warmup()
    raw.warmup()
    want, ms_prep = stream_ms(torch, dev, prep, batches)
    reset(counters)
    got, ms_raw = stream_ms(torch, dev, raw, batches)
    launches = {k: count(counters, key) for k, (key, _) in kernels.items()}
    log(f"  {name}: {len(batches)} batches, ms_per_batch "
        f"prepare_corpus=False {ms_raw:.3f} beside True {ms_prep:.3f}; "
        f"launches in the False stream {launches}")
    for k, (_key, least) in kernels.items():
        check(launches[k] >= least, f"{name}: {k} counted {launches[k]}, "
              f"fewer than {least}")
    same_results(f"{name}: prepare_corpus=False vs True", got, want)
    return launches, (ms_raw, ms_prep), (b_raw, b_prep)


def migration_phase(torch, counters, index, spectral, rows, batches, dev):
    """[15a] The migration surface on the seeded cosine index, before the
    API phase mutates it: ArrowIndex.build(spectral=True) against the
    builder-route spectral index of [4d] (λ, signals and a 2048-query
    search bitwise); search with use_pallas None, True and False (K1 and
    the repair's K3 for the first two, no kernel for False), each held to
    the plain full scan; use_pallas=True on a BELOW_ROWS-row slice, below
    the row floor (K1); SearchSessions with prepare_corpus=True and False
    (prepare_corpus_pair, 16 batches); ops.search.hybrid_search_device
    on one query against the float64 hybrid_plain64.  Returns the launch
    counts by route."""
    from arrowspace_torch import core
    from arrowspace_torch.core import ArrowSpace
    from arrowspace_torch.index import ArrowIndex
    from arrowspace_torch.ops.search import (batched_lambda_aware_topk,
                                             hybrid_search_device)

    a, gl = index.aspace, index.gl
    n, f = a.nitems, a.nfeatures
    out = {}
    log("[15a] migration surface on the cosine corpus")

    reset(counters)
    spec, t_spec = timed(torch, dev, lambda: ArrowIndex.build(
        rows, eps=EPS, spectral=True, seed=SEED, device=dev))
    out["spectral_build"] = {"taulambda": counters["k2"].launches}
    check(bool(torch.equal(spec.aspace.lambdas, spectral.aspace.lambdas)),
          "build(spectral=True): λ differ from the builder route's")
    check(bool(torch.equal(spec.aspace.signals, spectral.aspace.signals)),
          "build(spectral=True): signals differ from the builder route's")
    q = batches[0]
    got = spec.search(q, k=K, alpha=ALPHA)
    ref = spectral.search(q, k=K, alpha=ALPHA)
    same_results("build(spectral=True) search vs the builder route's",
                 [got], [ref])
    log(f"  ArrowIndex.build(spectral=True) in {t_spec:.3f}s, K2 launches "
        f"{out['spectral_build']['taulambda']}: λ and signals bitwise the "
        f"builder route's")
    del spec, got, ref

    qlam = a.prepare_query_items_batch(q, gl)
    qt = torch.as_tensor(q, device=dev, dtype=a.dtype)
    (ref_s, ref_i), t_ref = timed(torch, dev, lambda: (
        batched_lambda_aware_topk(qt, qlam, a.data, a.lambdas, ALPHA, k=K)))
    ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
    for mode in (None, True, False):
        reset(counters)
        (s, i), t = timed(torch, dev, lambda: index.search(
            q, k=K, alpha=ALPHA, use_pallas=mode))
        c = {key: count(counters, key) for key in counters}
        out[f"use_pallas_{mode}"] = {"bintopk": c["k1"],
                                     "merge_topk": c["k3"]}
        log(f"  search(use_pallas={mode}) at B={BATCH}: {t * 1e3:.3f} ms; "
            f"launches K1={c['k1']} K3={c['k3']} repairs={c['repair']}")
        if mode is False:
            check(not any(c.values()),
                  f"use_pallas=False launched a kernel: {c}")
            check(np.array_equal(i, ref_i) and np.array_equal(s, ref_s),
                  "use_pallas=False differs from the plain full scan")
        else:
            check(c["k1"] >= 1 and c["k3"] >= 1 and c["repair"] >= 1,
                  f"use_pallas={mode} did not take K1 and its repair: {c}")
        agree(f"search(use_pallas={mode}) vs plain full scan", s, i, ref_s,
              ref_i, exact=true_scores(qt, qlam, a.data, a.lambdas,
                                       torch.as_tensor(i, device=dev)))
    log(f"  plain full scan of the batch: {t_ref * 1e3:.3f} ms")

    check(not core.merge_fits(BELOW_ROWS, K), "BELOW_ROWS is not below "
          "the row floor")
    sub = ArrowSpace(nfeatures=f, nitems=BELOW_ROWS,
                     data=a.data[:BELOW_ROWS].contiguous(),
                     lambdas=a.lambdas[:BELOW_ROWS].contiguous(),
                     taumode=a.taumode)
    reset(counters)
    (s, i), t = timed(torch, dev, lambda: sub.search_lambda_aware_batch(
        qt, qlam, K, ALPHA, use_pallas=True))
    c = {key: count(counters, key) for key in ("k1", "k3", "repair")}
    out["use_pallas_True_below_gate"] = {"bintopk": c["k1"],
                                         "merge_topk": c["k3"]}
    log(f"  use_pallas=True on a {BELOW_ROWS}-row slice: {t * 1e3:.3f} ms; "
        f"launches K1={c['k1']} K3={c['k3']} repairs={c['repair']}")
    check(c["k1"] >= 1, "use_pallas=True below the row floor skipped K1")
    rs, ri = batched_lambda_aware_topk(qt, qlam, sub.data, sub.lambdas,
                                       ALPHA, k=K)
    agree(f"use_pallas=True on {BELOW_ROWS} rows vs plain full scan", s, i,
          rs, ri, exact=true_scores(qt, qlam, sub.data, sub.lambdas, i))
    del sub, rs, ri, s, i

    launches, _ms, _b = prepare_corpus_pair(
        torch, counters, "cosine session",
        lambda pc: index.make_search_session(batch_size=BATCH, k=K,
                                             alpha=ALPHA, prepare_corpus=pc),
        batches, dev, {"bintopk": ("k1", N_BATCHES),
                       "merge_topk": ("k3", 1), "repair": ("repair", 1)},
        n * f * 4)
    out["unprepared_cosine"] = launches

    host = a.host_rows
    xunit = host / np.maximum(np.linalg.norm(host, axis=1), 1e-300)[:, None]
    lam = a.lambdas.double().cpu().numpy()
    qv = q[2]
    ql1 = a.prepare_query_item(qv, gl)
    top_s, top_i, sem, cos, high = hybrid_search_device(
        torch.as_tensor(qv, device=dev), ql1, a.data, a.lambdas, ALPHA, k=K)
    _eff, _ids, cos64, blend, _kth = hybrid_plain64(qv, ql1, xunit, lam, K)
    ref_top = topk_by_score(blend, K)
    err = agree("hybrid_search_device λ-aware top-k vs float64", top_s[None],
                top_i[None], blend[ref_top][None], ref_top[None],
                exact=blend[top_i.cpu().numpy()][None])
    cos_h = cos.cpu().numpy()
    cos_err = float(np.abs(cos_h - cos64).max())
    tol = 2.0 * max(err, cos_err, 1e-12)
    edge = np.abs(cos64 - 0.9999) <= tol
    check(cos_err <= TOL, f"hybrid_search_device: cos error {cos_err}")
    check(bool((high.cpu().numpy() == (cos64 > 0.9999))[~edge].all()),
          "hybrid_search_device: high-cosine mask differs")
    s_i = int(sem)
    check(s_i == int(np.argmax(cos64))
          or abs(cos64[s_i] - cos64.max()) <= tol,
          f"hybrid_search_device: semantic top-1 {s_i}")
    log(f"  hybrid_search_device at {n}x{f}: cos max_abs_err={cos_err:.3e}, "
        f"semantic top-1 {s_i}, {int(high.sum())} high-cosine rows")
    return out


def energy_prepare_phase(torch, counters, index, batches, dev):
    """[15b] EnergySearchSessions of the exact energy index with
    prepare_corpus=True and False (prepare_corpus_pair, K6 and the
    strided energy repair), and approx=True with prepare_corpus=False,
    which must raise."""
    from arrowspace_torch.index import energy_z_plane
    log("[15b] migration surface: unprepared energy session")
    z = energy_z_plane(index.aspace)
    launches, _ms, _b = prepare_corpus_pair(
        torch, counters, "energy session",
        lambda pc: index.make_energy_session(
            batch_size=BATCH, k=K, w_lambda=E_WL, w_dirichlet=E_WD,
            prepare_corpus=pc),
        batches, dev, {"energy_bintopk": ("k6", N_BATCHES),
                       "erepair": ("erepair", 1)},
        z.shape[0] * z.shape[1] * 4)
    try:
        index.make_energy_session(batch_size=BATCH, k=K, approx=True,
                                  prepare_corpus=False)
        check(False, "approx=True with prepare_corpus=False did not raise")
    except ValueError as exc:
        log(f"  approx=True, prepare_corpus=False raises: {exc}")
    return {"unprepared_energy": launches}


def merge_prepare_phase(torch, counters, index, batches, dev):
    """[15c] "merge" SearchSessions of the 1536-wide index with
    prepare_corpus=True and False over MERGE_PC_BATCHES batches
    (prepare_corpus_pair, K3 once a batch)."""
    log("[15c] migration surface: unprepared merge session at 1536")
    a = index.aspace
    launches, _ms, _b = prepare_corpus_pair(
        torch, counters, "1536-wide merge session",
        lambda pc: index.make_search_session(batch_size=BATCH, k=K,
                                             alpha=ALPHA, prepare_corpus=pc),
        batches[:MERGE_PC_BATCHES], dev,
        {"merge_topk": ("k3", MERGE_PC_BATCHES)},
        a.nitems * a.nfeatures * 4)
    check(launches["merge_topk"] == MERGE_PC_BATCHES,
          f"the unprepared merge session launched K3 "
          f"{launches['merge_topk']} times")
    return {"unprepared_merge_1536": launches}


KERNELS = {
    # name: (source, TPU kernel it replaces)
    "bintopk": ("arrowspace_torch/csrc/bintopk.cu",
                "arrowspace_tpu/ops/pallas_bintopk.py:667"),
    "taulambda": ("arrowspace_torch/csrc/taulambda.cu",
                  "arrowspace_tpu/ops/pallas_taulambda.py:151"),
    "merge_topk": ("arrowspace_torch/csrc/merge_topk.cu",
                   "arrowspace_tpu/ops/pallas_topk.py:263"),
    "select_tau": ("arrowspace_torch/csrc/select_tau.cu",
                   "arrowspace_tpu/ops/pallas_tau.py:475"),
    "lambda_batch": ("arrowspace_torch/csrc/lambda_batch.cu",
                     "arrowspace_tpu/ops/pallas_lambda.py:166"),
    "energy_bintopk": ("arrowspace_torch/csrc/energy_bintopk.cu",
                       "arrowspace_tpu/ops/pallas_bintopk.py:934"),
    "energy_chord": ("arrowspace_torch/csrc/energy_chord.cu",
                     "arrowspace_tpu/ops/energy_approx.py:404"),
    # the bf16 modes (the TPU kernels' use_bf16=True)
    "bintopk_bf16": ("arrowspace_torch/csrc/bintopk_bf16.cu",
                     "arrowspace_tpu/ops/pallas_bintopk.py:667"),
    "merge_topk_bf16": ("arrowspace_torch/csrc/merge_topk_bf16.cu",
                        "arrowspace_tpu/ops/pallas_topk.py:263"),
}


class Bf16Count:
    """The bf16 launch count of a wrapper (``launches_bf16``) under the
    ``launches`` name the counters are read and reset by."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.launches_bf16

    @launches.setter
    def launches(self, value):
        self.fn.launches_bf16 = value


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    try:
        from arrowspace_torch.ops import (_build, bin_repair, bintopk,
                                          energy_approx, energy_bintopk,
                                          lambda_batch, select_tau,
                                          taulambda, topk)
    except ImportError as exc:
        print(f"FAIL: arrowspace_torch not importable ({exc}); run from "
              "the root of a checkout", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    counters = {"k1": bintopk.binned_topk_pool, "k2": taulambda.fused_taulambda,
                "k3": topk.merge_topk_partial,
                "k4": select_tau.fused_select_tau,
                "k5": lambda_batch.fused_lambda_batch,
                "k6": energy_bintopk.binned_energy_pool,
                "k7": energy_approx.binned_energy_approx_pool,
                "repair": bin_repair.strided_lambda_repair,
                "erepair": bin_repair.strided_energy_repair,
                "k1b": Bf16Count(bintopk.binned_topk_pool),
                "k3b": Bf16Count(topk.merge_topk_partial)}
    try:
        card = card_line()
        log(f"[1] card: {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        t0 = time.perf_counter()
        path, build_log = _build.build()
        _build.lib()
        log(f"  kernels built in {time.perf_counter() - t0:.2f}s -> "
            f"{path.name}")
        for line in build_log.splitlines():   # ptxas, per kernel
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"  {line.strip()}")
        t0 = time.perf_counter()
        from arrowspace_torch import native
        native.lib()
        log(f"  native clustering scan built in "
            f"{time.perf_counter() - t0:.2f}s -> {native.build().name}")

        rows = clustered_rows(N_ROWS, N_FEAT, SEED)
        canon = plant_duplicates(rows)
        index, session, batches, launches = main_path(torch, counters, rows,
                                                      canon, dev)
        rec = kernels_vs_plain(torch, index, batches, dev)
        bf16_sess, l16, _, _ = bf16_session(torch, counters, index, session,
                                            batches, dev, "3b", "cosine")
        rec["bintopk_bf16"], ops16 = k1_bf16_vs_plain(torch, index, batches,
                                                      dev, "cosine")
        rec["merge_topk_bf16"] = k3_bf16_vs_plain(torch, *ops16)
        del ops16
        k1b_live = live_bf16_phase(torch, counters, index, bf16_sess,
                                   batches, rows, dev)
        where_time_goes(torch, (("cosine session", session),
                                ("cosine bf16 session", bf16_sess)),
                        batches, step=4)
        del bf16_sess
        ref, ms_static, k1_reloaded = persistence_phase(
            torch, counters, index, batches, dev)
        k1_live = live_phase(torch, counters, index, rows, canon, batches,
                             ref, ms_static, dev)
        spectral, spec_index = spectral_path(torch, counters, rows, canon,
                                             dev)
        migration = migration_phase(torch, counters, index, spec_index, rows,
                                    batches, dev)
        del spec_index
        torch.cuda.empty_cache()
        pruned, cells = pruned_phase(torch, counters, index, rows, dev)
        hyper = hypergraph_phase(torch, counters, index, batches, ms_static,
                                 dev)
        torch.cuda.empty_cache()
        mesh = mesh_phase(torch, counters, index, ref, ms_static, batches,
                          cells, dev)
        del ref, cells
        torch.cuda.empty_cache()
        s128_lam, s128_topk = streaming_phase(
            torch, counters, index, session, rows.astype(np.float32),
            batches, dev, "4g", ("k2",), ("k1", "k3"))
        torch.cuda.empty_cache()
        api_phase(torch, counters, index, batches, dev)
        small_reference(torch, dev)
        del index, session, batches
        torch.cuda.empty_cache()

        index = unseeded_path(torch, counters, rows, canon, dev)
        chunked_engine_vs_host(torch, index, rows, dev)
        build_step = build_step_phase(torch, counters, index, rows, canon,
                                      dev)
        del index
        torch.cuda.empty_cache()
        mp = multiprocess_phase(torch, dev)
        torch.cuda.empty_cache()
        jax_corpus = jax_corpus_phase(torch, counters, dev)
        torch.cuda.empty_cache()

        index, exact, approx, batches, e_launches, res_e, res_a = \
            energy_path(torch, counters, rows, canon, dev)
        launches.update(e_launches)
        energy_vs_plain_scan(torch, index, exact, res_e, res_a, batches, dev)
        rec.update(energy_kernels_vs_plain(torch, index, exact, approx,
                                           batches, dev))
        where_time_goes(torch, (("exact energy session", exact),
                                ("approx energy session", approx)), batches,
                        step=8)
        k6_live = live_energy_phase(torch, counters, index, exact, rows,
                                    canon, batches, res_e, dev)
        migration.update(energy_prepare_phase(torch, counters, index,
                                              batches, dev))
        mesh_e = mesh_energy_phase(torch, counters, index, exact, batches,
                                   dev)
        del index, exact, approx, batches, res_e, res_a, rows
        torch.cuda.empty_cache()

        index, session, batches, w_launches = wide_path(torch, counters,
                                                        dev)
        launches["lambda_batch"] = w_launches["lambda_batch"]
        k5_rec, k3_wide, k4_wide = wide_kernels_vs_plain(torch, index,
                                                         batches, dev)
        rec.update(k5_rec)
        w16_sess, w16, _, _ = bf16_session(torch, counters, index, session,
                                           batches, dev, "11b", "wide 768")
        k1b_768, _ = k1_bf16_vs_plain(torch, index, batches, dev,
                                      "wide 768")
        where_time_goes(torch, (("wide projected session", session),
                                ("wide bf16 session", w16_sess)),
                        batches, step=11)
        del w16_sess
        k1_snapshot = wide_snapshot_phase(torch, counters, index, batches,
                                          dev)
        wide_pruned = wide_pruned_phase(torch, counters, index, batches, dev)
        del index, session, batches
        torch.cuda.empty_cache()

        index, session, batches, x_launches, x_ms = x_path(torch, counters,
                                                           dev)
        k4_x, k5_x, k3_x = x_kernels_vs_plain(torch, index, batches, dev)
        migration.update(merge_prepare_phase(torch, counters, index,
                                             batches, dev))
        torch.cuda.empty_cache()
        x16_sess, x16, x16_ms, _ = bf16_session(
            torch, counters, index, session, batches, dev, "14b", "1536-wide")
        k1b_1536, ops1536 = k1_bf16_vs_plain(torch, index, batches, dev,
                                             "1536-wide")
        where_time_goes(torch, (("1536-wide bf16 session", x16_sess),),
                        batches, step=14)
        del x16_sess
        torch.cuda.empty_cache()
        k3b_merge, k3b_merge_ms, k3b_1536 = merge_bf16_phase(
            torch, counters, index, batches, ops1536, x16_ms, dev)
        del ops1536
        torch.cuda.empty_cache()
        plain, plain_ms = x_plain_session(torch, index, batches, dev)
        log(f"  1536-wide sessions: merge {x_ms:.3f} ms a batch, plain "
            f"{plain_ms:.3f} ms a batch")
        where_time_goes(torch, (("1536-wide merge session", session),),
                        batches, step=14)
        where_time_goes(torch, (("1536-wide plain session", plain),),
                        batches, step=14, n_batches=2)
        del plain
        x_lam, x_topk = streaming_phase(
            torch, counters, index, session, index.aspace.host_rows, batches,
            dev, "13c", ("k4", "k5"), ("k3",))
        k3_live = live_merge_phase(torch, counters, index, batches, dev)
        mesh_x = mesh_1536_phase(torch, counters, index, session, batches,
                                 dev)
        k5 = rec["lambda_batch"]
        k5["max_abs_err"] = max(k5["max_abs_err"], k5_x["max_abs_err"])
        k5["max_abs_err_f64"] = max(k5["max_abs_err_f64"],
                                    k5_x["max_abs_err_f64"])
        k5["at_1536"] = k5_x
        k4 = rec["select_tau"]
        k4["max_abs_err"] = max(k4["max_abs_err"], k4_wide["max_abs_err"],
                                k4_x["max_abs_err"])
        k4["at_768"], k4["at_1536"] = k4_wide, k4_x
        k4["launches_by_path"] = {
            "energy": launches["select_tau"],
            "wide_768": w_launches["select_tau"],
            "wide_1536": x_launches["select_tau"],
            "streamed_1536": x_lam["k4"],
            "hypergraph": hyper["select_tau"]}
        k3 = rec["merge_topk"]
        k3["max_abs_err"] = max(k3["max_abs_err"], k3_wide["max_abs_err"],
                                k3_x["max_abs_err"])
        k3["at_1536"] = {key: k3_x[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_fp32_ms", "matmul_ms")}
        k3["wide_repair_768"] = {key: k3_wide[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_fp32_ms")}
        k3["launches_by_path"] = {
            "cosine": launches["merge_topk"],
            "wide_768": w_launches["merge_topk"],
            "wide_1536": x_launches["merge_topk"]}
        launches["merge_topk"] = x_launches["merge_topk"]
        k1b = rec["bintopk_bf16"]
        k1b["max_abs_err"] = max(k1b["max_abs_err"], k1b_768["max_abs_err"],
                                 k1b_1536["max_abs_err"])
        k1b["at_768"], k1b["at_1536"] = (
            {key: v for key, v in r.items() if key != "config"}
            for r in (k1b_768, k1b_1536))
        k3b = rec["merge_topk_bf16"]
        k3b["max_abs_err"] = max(k3b["max_abs_err"],
                                 k3b["at_repair"]["max_abs_err"],
                                 k3b_1536["max_abs_err"])
        k3b["at_1536"] = {key: k3b_1536[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "matmul_ms")}
        k3b["at_1536"]["session_ms_per_batch"] = k3b_merge_ms
        launches["bintopk_bf16"] = l16["bintopk_bf16"]
        launches["merge_topk_bf16"] = l16["merge_topk_bf16"]
        k1b["launches_by_path"] = {
            "cosine": l16["bintopk_bf16"], "live_cosine": k1b_live,
            "wide_768": w16["bintopk_bf16"],
            "wide_1536": x16["bintopk_bf16"]}
        k3b["launches_by_path"] = {
            "cosine": l16["merge_topk_bf16"],
            "wide_768": w16["merge_topk_bf16"],
            "wide_1536": x16["merge_topk_bf16"],
            "merge_1536": k3b_merge}
        for name, by_path in {
                "bintopk": {"cosine": launches["bintopk"],
                            "reloaded_cosine": k1_reloaded,
                            "live_cosine": k1_live,
                            "spectral": spectral["bintopk"],
                            "wide_768": w_launches["bintopk"],
                            "reloaded_wide_snapshot": k1_snapshot,
                            **pruned["k1"], **jax_corpus["k1"],
                            "pruned_wide_768_b16": wide_pruned["k1"],
                            "streamed_128": s128_topk["k1"],
                            "mesh_cosine": mesh["mesh_cosine_binned"]["k1"],
                            "mesh_pruned": mesh["mesh_pruned"]["k1"],
                            "multiprocess_nccl": mp["bintopk"],
                            **{f"migration_{r}": migration[r]["bintopk"]
                               for r in ("use_pallas_None",
                                         "use_pallas_True",
                                         "use_pallas_True_below_gate",
                                         "unprepared_cosine")}},
                "taulambda": {"cosine": launches["taulambda"],
                              "spectral": spectral["taulambda"],
                              "streamed_128": s128_lam["k2"],
                              "mesh_lambda": mesh["mesh_lambda"]["k2"],
                              "mesh_build_step": build_step["k2"],
                              "multiprocess_nccl": mp["taulambda"],
                              "migration_spectral_build":
                                  migration["spectral_build"]["taulambda"]},
                "merge_topk": {"spectral": spectral["merge_topk"],
                               "live_merge_1536": k3_live,
                               **pruned["k3"], **jax_corpus["k3"],
                               "pruned_wide_768_b16": wide_pruned["k3"],
                               "streamed_128": s128_topk["k3"],
                               "streamed_1536": x_topk["k3"],
                               "mesh_cosine_repair":
                                   mesh["mesh_cosine_binned"]["k3"],
                               "mesh_cosine_merge":
                                   mesh["mesh_cosine_merge"]["k3"],
                               "mesh_pruned": mesh["mesh_pruned"]["k3"],
                               "mesh_1536": mesh_x["k3"],
                               "multiprocess_nccl": mp["merge_topk"],
                               **{f"migration_{r}": migration[r]["merge_topk"]
                                  for r in ("use_pallas_None",
                                            "use_pallas_True",
                                            "use_pallas_True_below_gate",
                                            "unprepared_cosine",
                                            "unprepared_merge_1536")}},
                "lambda_batch": {"wide_768": w_launches["lambda_batch"],
                                 "wide_1536": x_launches["lambda_batch"],
                                 "streamed_1536": x_lam["k5"]},
                "energy_bintopk": {"exact_energy": launches["energy_bintopk"],
                                   "live_energy": k6_live,
                                   "mesh_energy": mesh_e["k6"],
                                   "multiprocess_nccl":
                                       mp["energy_bintopk"],
                                   "migration_unprepared_energy":
                                       migration["unprepared_energy"][
                                           "energy_bintopk"]}}.items():
            rec[name].setdefault("launches_by_path", {}).update(by_path)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(artifacts_dir(), ignore_errors=True)

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                **{key: rec[name][key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                **{key: v for key, v in rec[name].items()
                   if key in ("bound_fp32_ms", "matmul_ms", "at_768",
                              "at_1536", "wide_repair_768", "at_repair",
                              "launches_by_path", "max_abs_err_f64",
                              "at_build")}}
               for name, (src, rep) in KERNELS.items()]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
