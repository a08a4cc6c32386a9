#!/usr/bin/env python3
"""Smoke run of arrowspace_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels (nvcc, sm_90a), drives the main
path once at full width (a seeded ArrowIndex.build of a clustered
1,000,000 x 128 corpus, then a SearchSession serving batched λ-aware
top-k at B=2048, k=10, α=0.9), and holds every kernel against its plain
PyTorch version on the card at the main path's shapes.  The corpus
carries exact duplicate rows, as real corpora do, placed so that more
than the binned kernel's depth of them share a bin: the first streamed
batch then needs the strided repair and its K3 fallback.  Any failed
check exits non-zero.  Without CUDA, or without the package beside it,
it exits non-zero and prints no result.

Output: progress lines, then the card's name and power limit, then one
JSON line with each kernel's launches (counted over the main path's run:
build, session warm-up and stream), error against its plain version and
mean times, then the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_ROWS, N_FEAT, N_CENTRES, NOISE = 1_000_000, 128, 64, 0.05
SEED = 11
# The default ε (1e-3) leaves this corpus's feature graph without an edge,
# so every λ would be 0 and neither K2 nor the λ term would be tested.
EPS = 1.0
BATCH, K, ALPHA, N_BATCHES = 2048, 10, 0.9, 16
TAULAMBDA_ROWS = 262_144
TOL = 1e-5              # kernel vs plain version, float32 scores and λ


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
    return centres[rng.integers(0, N_CENTRES, n)] \
        + rng.normal(0, NOISE, (n, f))


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


def agree(name, s, i, ref_s, ref_i, exact=None, tol=TOL) -> float:
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
    log(f"  {name}: max_abs_err={err:.3e} id_mismatches={bad} "
        f"near_tie_swaps={swaps}")
    check(bad == 0, f"{name}: {bad} ids differ from the reference's "
          "outside near-ties")
    return err


def main_path(torch, counters, rows, canon, dev):
    """The main path, through the user entry points: build, session,
    warm-up, stream.  The kernel counters are read right after the
    stream, before any check runs a kernel.  Returns the index, the query
    batches and the launch counts."""
    from arrowspace_torch.index import ArrowIndex
    from arrowspace_torch.ops.search import batched_lambda_aware_topk

    log(f"[2] main path: ArrowIndex.build {rows.shape[0]}x{rows.shape[1]} "
        f"eps={EPS} seed={SEED} on {dev}")
    t0 = time.perf_counter()
    index = ArrowIndex.build(rows, eps=EPS, seed=SEED, device=dev)
    sync(torch, dev)
    t_build = time.perf_counter() - t0
    st = index.builder.stage_seconds
    log(f"  build_s={t_build:.3f} clustering_s={st['clustering']:.3f} "
        f"laplacian_s={st['laplacian']:.3f} taumode_s={st['taumode']:.3f} "
        f"clusters={index.aspace.n_clusters} graph={tuple(index.gl.shape())}")

    session = index.make_search_session(batch_size=BATCH, k=K, alpha=ALPHA)
    check(session.kernel == "binned", f"session kernel {session.kernel}")
    session.warmup()
    repairs_warm = counters["repair"].calls
    rng = np.random.default_rng(SEED + 1)
    picks = [rng.integers(0, rows.shape[0], BATCH) for _ in range(N_BATCHES)]
    picks[0][:2] = (0, 1)            # the duplicated rows: repair and K3
    batches = [rows[p] * 1.02 for p in picks]
    sync(torch, dev)
    t0 = time.perf_counter()
    results = list(session.search_stream(batches))
    sync(torch, dev)
    t_stream = time.perf_counter() - t0
    launches = {"bintopk": counters["k1"].launches,
                "taulambda": counters["k2"].launches,
                "merge_topk": counters["k3"].launches}
    repairs = counters["repair"].calls - repairs_warm
    log(f"  main-path launches: {launches}; strided repairs in the "
        f"stream: {repairs}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(repairs > 0, "the stream repaired no flagged row")

    lam = index.aspace.lambdas
    lam_h = lam.cpu().numpy()
    check(lam.shape == (rows.shape[0],) and bool(np.isfinite(lam_h).all()),
          "λ not finite or wrong shape")
    n_distinct = int(np.unique(lam_h).size)
    log(f"  λ: min={lam_h.min():.6g} max={lam_h.max():.6g} "
        f"distinct={n_distinct}")
    check(n_distinct >= 1000, "λ nearly constant")
    check(bool((lam_h == lam_h[canon]).all()),
          "identical rows got different λ")

    ms_batch = t_stream / N_BATCHES * 1e3
    self_hits = np.mean([float(np.mean(canon[r[1][:, 0]] == canon[p]))
                         for r, p in zip(results, picks)])
    log(f"  session: {N_BATCHES} batches of {BATCH}, ms_per_batch="
        f"{ms_batch:.3f}, queries_per_s={BATCH / ms_batch * 1e3:.1f}, "
        f"self_match_rate={self_hits}")
    check(all(r[0].shape == (BATCH, K) and np.isfinite(r[0]).all()
              for r in results), "session output shape/finiteness")
    check(self_hits == 1.0, f"self-match rate {self_hits} != 1.0")

    # 256 queries, the two duplicated rows among them, against the plain
    # full scan (matmul + stable sort)
    q = torch.as_tensor(batches[0][:256], device=dev, dtype=torch.float32)
    qlam = index.aspace.prepare_query_items_batch(batches[0][:256], index.gl)
    ps, pi = batched_lambda_aware_topk(q, qlam, index.aspace.data, lam,
                                       ALPHA, k=K)
    s0, i0 = results[0][0][:256], results[0][1][:256]
    agree("session vs plain full scan (256 queries)", s0, i0, ps, pi,
          exact=true_scores(q, qlam, index.aspace.data, lam,
                            torch.as_tensor(i0, device=dev)))
    log(f"  row 0 (3 overflowing bins, K3) top-{K}: {i0[0].tolist()}")
    log(f"  row 1 (1 fired bin, strided repair) top-{K}: {i0[1].tolist()}")
    return index, batches, launches


def kernels_vs_plain(torch, index, batches, dev):
    """Each kernel against its plain version on the card, at the main
    path's shapes; returns the per-kernel records (without launches)."""
    from arrowspace_torch.ops import bintopk as bt
    from arrowspace_torch.ops import taulambda as tl
    from arrowspace_torch.ops import topk as tk
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
    tau_eq = bool(torch.equal(tau_k, tau_p))
    n_distinct = int(torch.unique(lam_p).numel())
    log(f"  K2 taulambda {TAULAMBDA_ROWS}x{x.shape[1]}: λ max_abs_err="
        f"{err:.3e}, τ bitwise equal={tau_eq}; plain λ min="
        f"{float(lam_p.min()):.6g} max={float(lam_p.max()):.6g} "
        f"distinct={n_distinct}")
    check(n_distinct >= 1000, "K2 compared on nearly constant λ")
    check(err <= TOL and tau_eq, "K2 disagrees with its plain version")
    rec["taulambda"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: tl.fused_taulambda(x, lap, aspace.taumode)),
        plain_ms=cuda_ms(lambda: tl.taulambda_plain(x, lap,
                                                    aspace.taumode)))

    # K1 at k=10 (depth 3, bins 128) and k=64 (depth 4, bins 512)
    k1_err = 0.0
    for k in (K, 64):
        depth, bins = bt.binned_topk_depth_for(k), bt.bins_target(k)
        chunks = bt._default_chunks(BATCH, bins, -(-n // bins), q.device)
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
        if k == K:
            rec["bintopk"] = dict(
                ms=cuda_ms(lambda: bt.binned_topk_pool(*args, **kw)),
                plain_ms=cuda_ms(lambda: bt.binned_topk_pool_plain(
                    *args, **kw), reps=2))
        else:
            log(f"    k=64: ms={cuda_ms(lambda: bt.binned_topk_pool(*args, **kw)):.3f}")
    rec["bintopk"]["max_abs_err"] = k1_err

    # K3 at k=10 over the whole batch; each (query, chunk) partial top-k
    # is held against its plain version as one row
    rows_pc = tk._chunk_rows(BATCH, n, q.device)
    args = (qhat, qlam, xhat, xlam, c1, n)
    s_k, i_k = tk.merge_topk_partial(*args, k=K, rows_per_chunk=rows_pc)
    s_p, i_p = tk.merge_topk_partial_plain(*args, k=K,
                                           rows_per_chunk=rows_pc)
    chunks = s_k.shape[1]
    err = agree(f"K3 merge_topk k={K} rows_per_chunk={rows_pc} "
                f"chunks={chunks}", s_k.reshape(-1, K), i_k.reshape(-1, K),
                s_p.reshape(-1, K), i_p.reshape(-1, K),
                exact=exact_scores(qhat.repeat_interleave(chunks, 0),
                                   qlam.repeat_interleave(chunks, 0), xhat,
                                   xlam, c1, i_k.reshape(-1, K).long()))
    rec["merge_topk"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: tk.merge_topk_partial(*args, k=K,
                                                 rows_per_chunk=rows_pc),
                   reps=2),
        plain_ms=cuda_ms(lambda: tk.merge_topk_partial_plain(
            *args, k=K, rows_per_chunk=rows_pc), reps=2))
    return rec


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
    log(f"[4] small reference (4000x32, card f32 vs CPU f64): "
        f"λ max_abs_err={err:.3e}")
    check(err <= 1e-4, "small reference: λ disagrees")
    q = rows[:32] * 1.02
    gs, gi = gpu.search(q, k=K, alpha=ALPHA)
    cs, ci = cpu.search(q, k=K, alpha=ALPHA)
    agree("small reference search", gs, gi, cs, ci, tol=1e-4)


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
        from arrowspace_torch.ops import _build
        from arrowspace_torch.ops import bin_repair, bintopk, taulambda, topk
    except ImportError as exc:
        print(f"FAIL: arrowspace_torch not importable ({exc}); run from "
              "the root of a checkout", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    counters = {"k1": bintopk.binned_topk_pool, "k2": taulambda.fused_taulambda,
                "k3": topk.merge_topk_partial,
                "repair": bin_repair.strided_lambda_repair}
    try:
        card = card_line()
        log(f"[1] card: {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        t0 = time.perf_counter()
        path, build_log = _build.build()
        _build.lib()
        log(f"  kernels built in {time.perf_counter() - t0:.2f}s -> "
            f"{path.name}")
        for line in build_log.splitlines():
            if "Used" in line:                 # ptxas: registers per kernel
                log(f"  {line.strip()}")

        rows = clustered_rows(N_ROWS, N_FEAT, SEED)
        canon = plant_duplicates(rows)
        for name in ("k1", "k2", "k3"):
            counters[name].launches = 0
        counters["repair"].calls = 0
        index, batches, launches = main_path(torch, counters, rows, canon,
                                             dev)
        rec = kernels_vs_plain(torch, index, batches, dev)
        small_reference(torch, dev)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1

    meta = {"bintopk": ("arrowspace_torch/csrc/bintopk.cu",
                        "arrowspace_tpu/ops/pallas_bintopk.py:667"),
            "taulambda": ("arrowspace_torch/csrc/taulambda.cu",
                          "arrowspace_tpu/ops/pallas_taulambda.py:151"),
            "merge_topk": ("arrowspace_torch/csrc/merge_topk.cu",
                           "arrowspace_tpu/ops/pallas_topk.py:263")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": rec[name]["max_abs_err"],
                "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"]}
               for name, (src, rep) in meta.items()]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
