"""Distributed λτ build and query over a sharded corpus.

PyTorch counterpart of ``arrowspace_tpu.parallel.distributed``; every
function keeps its JAX name, arguments and outputs.  The design:

- the graph matrix is tiny (F′×F′) and replicated on the mesh's first
  device (each shard reads it from its own device);
- the N axis is split into a ShardedTensor; the λτ batch is
  data-parallel over shards (each shard runs the same kernels on its
  rows, no collective);
- query scoring runs per shard, and the top-k merge gathers the per-shard
  candidates and takes the final top-k, the reference's per-thread-heap
  fold/reduce (core.rs:818-888).

A JAX ``shard_map`` becomes a loop over this process's shards that
launches on each shard's device (on distinct cards those launches run
concurrently; shards sharing one card run one after another).  Each
collective is a concatenation in shard order on the mesh's first device
in one process, and ``all_gather_into_tensor`` (candidates, det planes),
``all_reduce`` MAX (flags, JAX's ``pmax``) or ``all_reduce`` SUM (the
clustering's grouped sums, ``psum``) across processes (parallel/
multiprocess).  Every final merge is the stable two-key top-k on
(−score, global id), so exact cross-shard ties go to the lowest global
id.  The per-shard kernels are the single-chip ones: K1 (binned), K3
(merge), K2 (the sharded λ with ``use_pallas``) and K6 (energy), each
with its plain PyTorch version on a CPU shard.

The JAX compile caches (the clustering's fetch and gather programs and
their power-of-two buckets, the 128-row padding of the sessions' exact
repair pass, ``bucket_rows`` and ``padded_take``) bound XLA recompiles
and have no counterpart here.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..ops.search import batched_lambda_aware_topk, two_key_topk
from ..taumode import (TauMode, compute_taumode_lambdas, select_tau_batch,
                       synthetic_lambda_batch)
from ..utils.profiling import annotate
from .mesh import Mesh, ShardedTensor, shard_rows
from .multiprocess import all_reduce_max, all_reduce_sum, gather_columns

__all__ = ["sharded_compute_taumode_lambdas",
           "distributed_lambda_aware_topk", "distributed_lambda_aware_topk_2d",
           "distributed_pruned_topk", "distributed_index_step",
           "sharded_incremental_clustering", "distributed_build_step",
           "DistributedSearchSession", "DistributedEnergySearchSession"]


def _replicated(x, mesh: Mesh, dtype=None) -> torch.Tensor:
    """A value every process holds identically, on the mesh's first
    device."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device=mesh.first_device, dtype=dtype or t.dtype)


def _kernel_name(kernel: Optional[str]) -> Optional[str]:
    """The JAX package's "xla" is the port's "plain" (the product and the
    stable sort)."""
    return "plain" if kernel == "xla" else kernel


def _merge(s_parts: List[torch.Tensor], i_parts: List[torch.Tensor],
           mesh: Mesh, k: int):
    """Gather every shard's (B, k_local) candidates in global shard order
    and take the stable two-key top-k (a profiler range,
    "arrowspace::mesh_merge", so a trace can read its device time)."""
    with annotate("arrowspace::mesh_merge"):
        s = gather_columns(s_parts, mesh)
        i = gather_columns(i_parts, mesh)
        return two_key_topk(s, i, min(k, s.shape[1]))


def _shard_topk(kernel: str, q, qlam, x, xlam, alpha: float, k: int, *,
                prepared: bool = False, n_items: int = 0):
    """One shard's (scores, local ids[, flags, det]) by ``kernel``:
    "binned" (K1 and its flush), "merge" (K3) or "plain"."""
    if kernel == "binned":
        from ..ops.bintopk import binned_lambda_topk
        return binned_lambda_topk(q, qlam, x, xlam, alpha, k=k,
                                  prepared=prepared, n_items=n_items)
    if kernel == "merge":
        from ..ops.topk import fused_lambda_topk
        return fused_lambda_topk(q, qlam, x, xlam, alpha, k=k,
                                 prepared=prepared, n_items=n_items)
    assert kernel == "plain", kernel
    return batched_lambda_aware_topk(q, qlam, x, xlam, alpha, k=k)


def sharded_compute_taumode_lambdas(items, laplacian, taumode: TauMode,
                                    mesh: Mesh,
                                    use_pallas: bool = False
                                    ) -> ShardedTensor:
    """λτ with the items axis sharded over the mesh; no collective.
    With ``use_pallas`` each shard runs the fused τ+λ kernel K2 (float32,
    its plain version on a CPU shard); otherwise each shard takes the
    port's own τ and λ route (taumode.compute_taumode_lambdas, whose
    gates pick K2, K4 or K5 by size).  Returns the λ ShardedTensor."""
    x = shard_rows(items, mesh)
    out = []
    for xs in x.shards:
        lap = _replicated(laplacian, mesh).to(device=xs.device)
        if use_pallas:
            from ..ops.taulambda import fused_taulambda
            lam, _tau = fused_taulambda(
                xs.to(torch.float32).contiguous(), lap.to(torch.float32),
                taumode)
            out.append(lam.to(xs.dtype))
        else:
            out.append(compute_taumode_lambdas(xs, lap.to(xs.dtype),
                                               taumode))
    return ShardedTensor(out, mesh, x.n)


def distributed_lambda_aware_topk(queries, query_lambdas, items,
                                  item_lambdas, alpha, k: int, mesh: Mesh,
                                  use_pallas: bool = False,
                                  kernel: Optional[str] = None,
                                  tile: int = 0):
    """Per-shard top-k + gathered two-key merge (the heap-merge analogue).

    kernel="merge" runs K3 per shard; kernel="binned" runs K1 per shard
    and also returns the flags (B,) int32, reduced by max over shards: a
    flagged query's merged result may miss an element to a deep bin
    collision on some shard and must be repaired through an exact path.
    "xla" (the default; "plain" too) is the shifted-plane stable top-k
    per shard.  ``tile`` has no counterpart (the CUDA kernels pick their
    own layout) and is accepted for the JAX signature.  Returns (scores
    (B, k), global ids (B, k)) or, for "binned", (scores, ids, flags)."""
    kernel = _kernel_name(kernel or ("merge" if use_pallas else "xla"))
    x = shard_rows(items, mesh)
    xl = shard_rows(item_lambdas, mesh, x.dtype)
    k_local = min(k, x.shard_n)
    q = _replicated(queries, mesh, x.dtype)
    ql = _replicated(query_lambdas, mesh, x.dtype)
    s_parts, i_parts, fl_parts = [], [], []
    for j, (xs, ls) in enumerate(zip(x.shards, xl.shards)):
        out = _shard_topk(kernel, q.to(xs.device), ql.to(xs.device), xs, ls,
                          float(alpha), k_local)
        s_parts.append(out[0].to(x.dtype))
        i_parts.append(out[1].long() + x.global_offset(j))
        if kernel == "binned":
            fl_parts.append(out[2].to(torch.int32))
    s, i = _merge(s_parts, i_parts, mesh, min(k, x.n))
    if kernel == "binned":
        return s, i, all_reduce_max(fl_parts, mesh)
    return s, i


def distributed_lambda_aware_topk_2d(queries, query_lambdas, items,
                                     item_lambdas, alpha, k: int,
                                     mesh: Mesh):
    """Hierarchical top-k merge over a (dcn, ici) mesh.

    Stage 1: per-shard shifted-plane top-k.  Stage 2: the two-key merge
    within each ici group (this process's shards).  Stage 3: only the
    k_grp winners of each group cross the dcn axis (gathered across
    processes), and the final two-key top-k."""
    _dcn, ici = mesh.shape
    x = shard_rows(items, mesh)
    xl = shard_rows(item_lambdas, mesh, x.dtype)
    k_local = min(k, x.shard_n)
    q = _replicated(queries, mesh, x.dtype)
    ql = _replicated(query_lambdas, mesh, x.dtype)
    dev = mesh.first_device
    s_loc, i_loc = [], []
    for j, (xs, ls) in enumerate(zip(x.shards, xl.shards)):
        s, i = batched_lambda_aware_topk(q.to(xs.device), ql.to(xs.device),
                                         xs, ls, float(alpha), k=k_local)
        s_loc.append(s.to(dev))
        i_loc.append(i.to(dev) + x.global_offset(j))
    grp_s, grp_i = [], []
    for g0 in range(0, mesh.n_local, ici):
        s_ici = torch.cat(s_loc[g0:g0 + ici], dim=1)
        i_ici = torch.cat(i_loc[g0:g0 + ici], dim=1)
        sg, ig = two_key_topk(s_ici, i_ici, min(k, s_ici.shape[1]))
        grp_s.append(sg)
        grp_i.append(ig)
    return _merge(grp_s, grp_i, mesh, min(k, x.n))


def distributed_pruned_topk(queries, query_lambdas, cells, alpha, k: int,
                            mesh: Mesh, m_cells: int = 8,
                            margin: float = 1e-3):
    """Cell-screened exact top-k over the mesh: each shard screens its own
    slice of the cell layout's unit axis (pruned.pruned_topk on the local
    units, ``return_next_bound``) and the per-shard winners merge with
    the two-key (score, global id) sort, so cross-shard exact ties
    resolve to the lowest global id as on one device.

    Certification rides the merged GLOBAL k-th: it dominates every
    shard-local k-th, so "no unscanned cell's bound, on any shard (the
    max of the shards' next bounds), reaches the merged k-th" certifies
    the row.  A flagged query re-runs through the distributed full scan,
    the single-chip flag/fallback contract.  Per-shard ``m_cells`` means
    the mesh scans size·m_cells cells in all.  ``cells`` is a PrunedCells
    that every process holds; each shard reads its unit range.

    Returns (scores (B, k), global ids (B, k), flags (B,))."""
    from ..pruned import _alpha_of, pruned_topk

    u_pad = cells.cent.shape[0]
    assert u_pad % mesh.size == 0, (
        f"unit axis {u_pad} must be a multiple of the mesh size "
        f"{mesh.size} (pruned._unit_pad pads to pow2/1024-multiples, both "
        f"divisible by typical mesh sizes)")
    u_s, cap = u_pad // mesh.size, cells.cap
    dt = cells.x.dtype
    q = _replicated(queries, mesh, dt)
    ql = _replicated(query_lambdas, mesh, dt)
    s_parts, i_parts, nb_parts = [], [], []
    for j, s in enumerate(mesh.local_shards):
        dev = mesh.devices[j]
        u0, u1 = s * u_s, (s + 1) * u_s
        rows = [a[u0 * cap:u1 * cap].to(dev)
                for a in (cells.x, cells.lam, cells.ids)]
        units = [a[u0:u1].to(dev) for a in (
            cells.cent, cells.radius, cells.cosr, cells.sinr, cells.lam_lo,
            cells.lam_hi)]
        st, it, nb = pruned_topk(q.to(dev), ql.to(dev), *rows, *units, alpha,
                                 k=k, m_cells=m_cells, cap=cap, margin=margin,
                                 return_next_bound=True)
        s_parts.append(st)
        i_parts.append(it.long())
        nb_parts.append(nb)
    nb_max = all_reduce_max(nb_parts, mesh)
    top_s, top_i = _merge(s_parts, i_parts, mesh, k)
    _a, c1 = _alpha_of(alpha, dt)
    kth_shifted = top_s[:, k - 1] - c1
    fl = (nb_max + margin >= kth_shifted) | ~torch.isfinite(kth_shifted)
    return top_s, top_i, fl


def sharded_incremental_clustering(items_sharded, builder,
                                   max_clusters: int, radius: float,
                                   sampler, mesh: Mesh,
                                   rounds_chunk: int = 65536):
    """Sharded unseeded incremental clustering: the build-stage scan over
    a mesh-sharded corpus.

    Each round every shard computes nearest-centroid distances for its
    next ``rounds_chunk`` rows against the round-start snapshot (no
    collective), and the host applies the per-row create/assign/soft-
    outlier rules chunk by chunk in shard order through
    clustering._apply_chunk_decisions, the single-chip chunked mode's
    rules: the same snapshot relaxation with a race window of mesh.size
    chunks a round, still a valid serialisation of the reference's racy
    rayon semantics (clustering.rs:570-660).  Rows that centroids made
    earlier in the round are closer to are refreshed against them.

    The corpus stays on its shards: the host reads the few creator rows
    (``fetch_at``) and the bootstrap block, and the running-mean sums are
    taken shard-locally on the device (``segsum``) and summed across
    processes.  Across processes every host applies the same rules to
    the gathered per-chunk results.

    Returns (centroids (X, F) host float64, Assignments, sizes)."""
    from ..clustering import Assignments, _apply_chunk_decisions

    x = shard_rows(items_sharded, mesh)
    n, f = x.shape
    n_dev, shard_n = mesh.size, x.shard_n
    chunk = min(rounds_chunk, shard_n)
    dt = x.dtype
    first = mesh.first_device
    local = {s: j for j, s in enumerate(mesh.local_shards)}

    def window(s: int, start: int) -> torch.Tensor:
        # the window clamps to [shard_n - chunk, shard_n) on a partial
        # final round: the wanted rows are its LAST m entries
        lo = min(start, shard_n - chunk)
        return x.shards[local[s]][lo:lo + chunk]

    def nearest(rows: torch.Tensor, cent: np.ndarray):
        c = torch.as_tensor(cent).to(device=rows.device, dtype=dt)
        d2 = ((rows * rows).sum(dim=1)[:, None] - 2.0 * (rows @ c.T)
              + (c * c).sum(dim=1)[None, :]).clamp_min(0.0)
        best = d2.argmin(dim=1)
        return best, d2.gather(1, best[:, None])[:, 0]

    def dist_all(start: int, cent: np.ndarray):
        b_parts, d_parts = [], []
        for s in mesh.local_shards:
            best, bd = nearest(window(s, start), cent)
            b_parts.append(best[None, :])
            d_parts.append(bd[None, :])
        best = gather_columns(b_parts, mesh)[0]
        bd = gather_columns(d_parts, mesh)[0]
        return (best.cpu().numpy().astype(np.int64),
                bd.cpu().numpy().astype(np.float64))

    def owned_sum(t: torch.Tensor) -> torch.Tensor:
        # rows, sums and distances owned by one process: the others
        # contribute zeros, so the sum is the owner's value exactly
        return all_reduce_sum([t], mesh) if mesh.grouped else t

    def fetch_rows(lo: int, hi: int) -> np.ndarray:
        out = torch.zeros((hi - lo, f), dtype=dt, device=first)
        for s, j in local.items():
            a, b = max(lo, s * shard_n), min(hi, (s + 1) * shard_n)
            if a < b:
                out[a - lo:b - lo] = x.shards[j][a - s * shard_n:
                                                 b - s * shard_n].to(first)
        return owned_sum(out).double().cpu().numpy()

    def fetch_rows_at(global_idx: np.ndarray) -> np.ndarray:
        g = np.asarray(global_idx, dtype=np.int64)
        out = torch.zeros((g.size, f), dtype=dt, device=first)
        for s, j in local.items():
            pos = np.nonzero(g // shard_n == s)[0]
            if pos.size:
                loc = torch.as_tensor(g[pos] - s * shard_n,
                                      device=x.shards[j].device)
                out[torch.as_tensor(pos, device=first)] = \
                    x.shards[j][loc].to(first)
        return owned_sum(out).double().cpu().numpy()

    cent = np.zeros((max_clusters, f), dtype=np.float64)
    counts = np.zeros(max_clusters, dtype=np.int64)
    assign = np.full(n, -1, dtype=np.int64)
    state = {"n_c": 0}

    # bootstrap centroid 0 from the first kept row (a host scan over
    # small fetched blocks; with any realistic keep rate one block)
    sampling_enabled = builder.sampling is not None
    boot = 0
    for b0 in range(0, n, 1024):
        block = fetch_rows(b0, min(b0 + 1024, n))
        for j in range(block.shape[0]):
            kept = (not sampling_enabled) or sampler.should_keep(
                block[j], float("inf"), 0, max_clusters)
            boot = b0 + j + 1
            if kept:
                cent[0] = block[j]
                counts[0] = 1
                assign[b0 + j] = 0
                state["n_c"] = 1
                break
        if state["n_c"]:
            break
    if state["n_c"] == 0:
        raise RuntimeError("No clusters created from data (all rows "
                           "rejected by sampling)")

    for start in range(0, shard_n, chunk):
        m = min(chunk, shard_n - start)
        round_start_nc = state["n_c"]
        best_all, bd_all = dist_all(start, cent[:round_start_nc])
        # shard-order serialisation: apply each shard's chunk in turn
        for d in range(n_dev):
            offset = d * shard_n + start
            lo, hi = d * chunk + (chunk - m), (d + 1) * chunk
            sl = slice(0, m)
            if offset + m > boot > offset:
                # rows consumed by the bootstrap scan are already decided
                sl = slice(boot - offset, m)
            elif offset + m <= boot:
                continue
            best_c = best_all[lo:hi][sl].copy()
            bd_c = bd_all[lo:hi][sl].copy()
            offs = offset + sl.start
            m_eff = m - sl.start
            if state["n_c"] > round_start_nc and bd_c.size:
                # refresh against the centroids created by earlier chunks
                # of this round (the round's distances saw its start)
                fb = torch.zeros(m_eff, dtype=torch.int64, device=first)
                fd = torch.zeros(m_eff, dtype=dt, device=first)
                if d in local:
                    rows = x.shards[local[d]][offs - d * shard_n:
                                              offs - d * shard_n + m_eff]
                    b_, d_ = nearest(rows, cent[round_start_nc:state["n_c"]])
                    fb, fd = b_.to(first), d_.to(first)
                fbest = owned_sum(fb).cpu().numpy().astype(np.int64)
                fbd = owned_sum(fd).cpu().numpy().astype(np.float64)
                closer = fbd < bd_c
                best_c = np.where(closer, fbest + round_start_nc, best_c)
                bd_c = np.where(closer, fbd, bd_c)

            def segsum(tgt_local, _d=d, _offs=offs, _m=m_eff):
                sums = torch.zeros((max_clusters, f), dtype=dt, device=first)
                cnts = torch.zeros(max_clusters, dtype=torch.int64,
                                   device=first)
                if _d in local:
                    tl = np.asarray(tgt_local, dtype=np.int64)
                    sel = np.nonzero(tl >= 0)[0]
                    if sel.size:
                        shard = x.shards[local[_d]]
                        rows = shard[torch.as_tensor(
                            sel + (_offs - _d * shard_n),
                            device=shard.device)].to(first)
                        tgt = torch.as_tensor(tl[sel], device=first)
                        sums.index_add_(0, tgt, rows)
                        cnts.index_add_(0, tgt, torch.ones_like(tgt))
                return (owned_sum(sums).double().cpu().numpy(),
                        owned_sum(cnts).cpu().numpy().astype(np.int64))

            _apply_chunk_decisions(
                None, best_c, bd_c, offs, builder, sampler, radius,
                max_clusters, cent, counts, assign, state,
                segsum=segsum,
                fetch_at=lambda li, _offs=offs: fetch_rows_at(
                    np.asarray(li, dtype=np.int64) + _offs),
                nfeatures=f)

    if state["n_c"] == 0:
        raise RuntimeError("No clusters created from data")
    n_c = state["n_c"]
    return cent[:n_c].copy(), Assignments(assign), counts[:n_c].tolist()


def distributed_build_step(items, builder, queries, taumode: TauMode,
                           graph_params, k: int, mesh: Mesh,
                           max_clusters: int, radius: float,
                           clustering: Optional[dict] = None):
    """Full sharded build -> query: sharded clustering (device distance
    tiles, host rules), the graph from the centroids, sharded λτ and the
    distributed top-k; the end-to-end multi-device path of the dry run.
    ``clustering``, when given, receives the scan's "centroids",
    "assignments", "sizes" and "seconds".  Returns (centroids, λ
    ShardedTensor, scores, ids)."""
    x = shard_rows(items, mesh)
    if (mesh.multiprocess and builder.sampling is not None
            and builder.clustering_seed is None):
        # every process replays the same host create/assign rules; an
        # unseeded sampler draws per-process OS entropy and the
        # processes would silently diverge (clustering.rs:842-846's
        # determinism, lifted to the process level)
        raise ValueError(
            "multi-process builds require a seeded builder "
            "(with_seed) when inline sampling is enabled — unseeded "
            "samplers draw per-process entropy and host decisions "
            "would diverge across processes")
    sampler = (builder.sampling.make(seed=builder.clustering_seed)
               if builder.sampling is not None else None)
    if sampler is None:
        from ..sampling import SamplerType
        sampler = SamplerType.simple(1.0).make(seed=1)
        builder.sampling = None
    t0 = time.perf_counter()
    cent, assignments, sizes = sharded_incremental_clustering(
        x, builder, max_clusters, radius, sampler, mesh)
    if clustering is not None:
        clustering.update(centroids=cent, assignments=assignments,
                          sizes=sizes, seconds=time.perf_counter() - t0)
    centroids = torch.as_tensor(cent).to(device=mesh.first_device,
                                         dtype=x.dtype)
    lambdas, scores, idx = distributed_index_step(
        x, centroids, queries, taumode, graph_params, k, mesh)
    return centroids, lambdas, scores, idx


def distributed_index_step(items, centroids, queries, taumode: TauMode,
                           graph_params, k: int, mesh: Mesh):
    """One full index + query step over the mesh, the dry run's
    "training step":

    1. build the F′×F′ λτ-graph from the (replicated) centroids;
    2. compute λτ for every (sharded) item;
    3. prepare the queries' λ and run the distributed top-k (α 0.9).

    Returns (λ ShardedTensor, scores (B, k), ids (B, k))."""
    from ..laplacian import build_laplacian_matrix

    x = shard_rows(items, mesh)
    dt = x.dtype
    cent = centroids if torch.is_tensor(centroids) else \
        torch.as_tensor(np.asarray(centroids))
    gl = build_laplacian_matrix(cent.T, graph_params, n_items=x.n,
                                device=mesh.first_device, dtype=dt)
    lambdas = sharded_compute_taumode_lambdas(x, gl.matrix, taumode, mesh)
    q = _replicated(queries, mesh, dt)
    q_lambdas = synthetic_lambda_batch(q, gl.matrix,
                                       select_tau_batch(q, taumode))
    scores, idx = distributed_lambda_aware_topk(
        q, q_lambdas, x, lambdas, 0.9, k, mesh)
    return lambdas, scores, idx


def _query_lambda(q_prep, lap, taumode: TauMode, pad_tall: bool):
    """Query λ of projected queries against the replicated graph (the
    single-chip sessions' preparation, index._query_prep)."""
    taus = select_tau_batch(q_prep, taumode)
    return synthetic_lambda_batch(q_prep, lap, taus, pad_items=pad_tall)


class DistributedSearchSession:
    """Pipelined streaming search over a mesh, the multi-device
    counterpart of index.SearchSession.

    One step a batch: query-λ preparation on the mesh's first device,
    then each shard's top-k by the session's kernel (chosen per shard
    like the single-chip session, index.session_kernel_kind on the shard
    size: K1 "binned", K3 "merge" or "plain"), then the gathered two-key
    merge.  The binned and merge kernels read a prepared copy of each
    shard (normalised and padded once, here).  On the binned kernel the
    per-shard det planes are gathered along the columns (column s·bins +
    b is shard s's bin b) and a flagged row is repaired exactly by the
    strided repair over the mesh (bin_repair, ``shard_n``), rows whose
    fired count overflows taking the distributed exact pass (K3 per
    shard, as the single-chip repair's fallback).  When more than one
    process holds shards every flagged row takes the exact pass (the
    strided repair reads rows of this process's shards only).  The stream
    keeps ``depth`` batches in flight (index.stream_search)."""

    def __init__(self, items, item_lambdas, laplacian, mesh: Mesh,
                 batch_size: int, k: int = 10, alpha: float = 0.9,
                 taumode: TauMode = None, depth: int = 2,
                 projection=None, pad_tall: bool = False,
                 kernel: str = None, prepare_corpus: bool = True):
        from ..index import session_kernel_kind
        from ..ops.bintopk import prepare_binned_corpus

        x = shard_rows(items, mesh)
        xl = shard_rows(item_lambdas, mesh, x.dtype)
        self.batch_size = int(batch_size)
        self.depth = max(1, int(depth))
        self.mesh = mesh
        n, f = x.shape
        shard_n = x.shard_n
        self.k = k_eff = min(int(k), n)
        k_local = min(k_eff, shard_n)
        self.alpha = alpha_f = float(alpha)
        taumode = taumode if taumode is not None else TauMode.median()
        self.device, self.dtype = mesh.first_device, x.dtype
        self._dim = f
        knl = _kernel_name(kernel) or session_kernel_kind(shard_n, k_local,
                                                          f)
        self.kernel = knl
        lap = _replicated(laplacian, mesh, x.dtype)
        proj = None if projection is None else \
            _replicated(projection, mesh, x.dtype)
        if proj is None and not pad_tall and lap.shape[0] != f:
            raise ValueError(
                f"graph has {lap.shape[0]} nodes but items have {f} "
                f"coordinates — a dims-reduced index needs the projection "
                f"matrix (projection=...), a tall energy graph needs "
                f"pad_tall=True")
        prepped = knl in ("binned", "merge") and prepare_corpus
        if prepped:
            pairs = [prepare_binned_corpus(xs, ls)
                     for xs, ls in zip(x.shards, xl.shards)]
            step_x, step_l = [p[0] for p in pairs], [p[1] for p in pairs]
        else:
            step_x, step_l = x.shards, xl.shards
        n_items = shard_n if prepped else 0

        def prepare(q):
            return _query_lambda(q if proj is None else q @ proj, lap,
                                 taumode, pad_tall)

        def shards_topk(q, qlam, kind):
            s_parts, i_parts, fl_parts, det_parts = [], [], [], []
            for j, (xs, ls) in enumerate(zip(step_x, step_l)):
                if kind == "plain" and prepped:
                    xs, ls = x.shards[j], xl.shards[j]
                out = _shard_topk(kind, q.to(xs.device), qlam.to(xs.device),
                                  xs, ls, alpha_f, k_local,
                                  prepared=prepped and kind != "plain",
                                  n_items=n_items)
                s_parts.append(out[0].to(x.dtype))
                i_parts.append(out[1].long() + x.global_offset(j))
                if kind == "binned":
                    fl_parts.append(out[2].to(torch.int32))
                    det_parts.append(out[3])
            s, i = _merge(s_parts, i_parts, mesh, k_eff)
            if kind != "binned":
                return s, i, None, None
            return (s, i, all_reduce_max(fl_parts, mesh) > 0,
                    gather_columns(det_parts, mesh))

        def step(q):
            qlam = prepare(q)
            s, i, flags, det = shards_topk(q, qlam, knl)
            return s, i, flags, qlam, det

        def full_exact(q_rows, ql_rows):
            s, i, _fl, _det = shards_topk(q_rows, ql_rows, "merge")
            return s.cpu().numpy(), i.cpu().numpy()

        def repair(q, qlam, det, scores, ids, flags):
            from ..ops.bin_repair import strided_lambda_repair
            rows = np.nonzero(flags)[0]
            if not rows.size:
                return scores, ids
            rt = torch.as_tensor(rows, device=self.device)
            q_rows = (q[rt] if torch.is_tensor(q) else torch.as_tensor(
                q[rows])).to(device=self.device, dtype=x.dtype)
            ql_rows = qlam[rt]
            scores, ids = scores.copy(), ids.copy()
            if mesh.multiprocess:
                scores[rows], ids[rows] = full_exact(q_rows, ql_rows)
                return scores, ids

            def fallback(rel_rows):
                rel = torch.as_tensor(rel_rows, device=self.device)
                return full_exact(q_rows[rel], ql_rows[rel])

            scores[rows], ids[rows] = strided_lambda_repair(
                q_rows, ql_rows, det[rt].cpu().numpy(),
                scores[rows, k_eff - 1], ids[rows], step_x, step_l, alpha_f,
                k=k_eff, n=n, prepared=prepped, fallback=fallback,
                cur_scores=scores[rows], shard_n=shard_n)
            return scores, ids

        self._step = step
        self._repair = repair if knl == "binned" else None
        self._det_width = 0
        if knl == "binned":
            from ..ops.bintopk import bins_target
            self._det_width = mesh.size * bins_target(k_local)

    @classmethod
    def from_index(cls, index, mesh: Mesh, batch_size: int, k: int = 10,
                   alpha: float = 0.9, depth: int = 2,
                   **kw) -> "DistributedSearchSession":
        """A mesh session over a built or loaded ArrowIndex: the corpus
        and λ split over the mesh's shards (views where a shard shares
        the index's device); the graph and any JL projection replicate."""
        aspace, gl = index.aspace, index.gl
        proj = None
        if aspace.projection_matrix is not None:
            proj = aspace.projection_matrix.matrix(dtype=aspace.dtype,
                                                   device=aspace.device)
        return cls(aspace.data, aspace.lambdas, gl.matrix, mesh, batch_size,
                   k=k, alpha=alpha, taumode=aspace.taumode, depth=depth,
                   projection=proj, pad_tall=aspace.pad_tall_graphs, **kw)

    def warmup(self) -> None:
        """One full batch through the stream loop and, on the binned
        kernel, one synthetic mesh repair, so that kernel builds and
        first-call costs land here and not on the first real batch."""
        _warmup(self)

    def search_stream(self, batches):
        """Yield (scores, ids) per input batch with ``depth`` batches in
        flight (index.stream_search)."""
        from ..index import stream_search
        return stream_search(self._step, batches, self.batch_size,
                             self.depth, self.device, self.dtype,
                             dim=self._dim, repair=self._repair)


def _warmup(session) -> None:
    """The sessions' warm-up: one batch of ones, then one repair of a row
    whose det fires shard 0's bin 0."""
    ones = np.ones((session.batch_size, session._dim))
    list(session.search_stream([ones]))
    if session._repair is not None and session._det_width:
        k = session.k
        det = torch.full((1, session._det_width), -1.0,
                         device=session.device, dtype=session.dtype)
        det[0, 0] = 1.0
        session._repair(ones[:1], torch.zeros(1, device=session.device,
                                              dtype=session.dtype), det,
                        np.zeros((1, k)), np.arange(k)[None, :],
                        np.ones(1, dtype=bool))
    if session.device.type == "cuda":
        torch.cuda.synchronize(session.device)


class DistributedEnergySearchSession:
    """Multi-device ENERGY serving session (search_energy semantics,
    energymaps.rs:368-407), the counterpart of index.EnergySearchSession
    sharing DistributedSearchSession's design.

    The z-plane is made per shard at construction (z = (x·P)·Sᵀ on each
    shard's rows, the projection P and the signals graph S replicated),
    so the (N, G) z corpus never exists on one device.  Each shard serves
    through K6 ("binned", where energymaps.energy_binned_fits admits the
    shard) over a prepared copy centred on the z-plane's global mean
    (distances unchanged; d² rounds less, as in ops.bin_repair.
    BinnedEnergyTopK; one centre for every shard, so identical rows on
    different shards tie bitwise), else through the plain chunked scan.
    Flagged rows repair through the strided energy repair over the mesh
    (``shard_n``), with the distributed chunked scan for rows whose fired
    count overflows (and for every flagged row across processes)."""

    def __init__(self, items, item_lambdas, laplacian, mesh: Mesh,
                 batch_size: int, k: int = 10, w_lambda: float = 1.0,
                 w_dirichlet: float = 0.5, taumode: TauMode = None,
                 depth: int = 2, projection=None, signals=None,
                 pad_tall: bool = False, kernel: str = None,
                 prepare_corpus: bool = True):
        from ..index import energy_session_config
        from ..ops.energy_bintopk import (binned_energy_topk, dtype_scalar,
                                          energy_topk_chunked,
                                          prepare_binned_energy_corpus)

        x = shard_rows(items, mesh)
        xl = shard_rows(item_lambdas, mesh, x.dtype)
        self.batch_size = int(batch_size)
        self.depth = max(1, int(depth))
        self.mesh = mesh
        n, f = x.shape
        shard_n = x.shard_n
        self.k = k_eff = min(int(k), n)
        k_local = min(k_eff, shard_n)
        taumode = taumode if taumode is not None else TauMode.median()
        dt = x.dtype
        self.device, self.dtype = mesh.first_device, dt
        self._dim = f
        lap = _replicated(laplacian, mesh, dt)
        proj = None if projection is None else \
            _replicated(projection, mesh, dt)
        sig = None
        if signals is not None and np.shape(signals)[0] > 0:
            sig = _replicated(signals, mesh, dt)
        if proj is None and not pad_tall and lap.shape[0] != f:
            raise ValueError(
                f"graph has {lap.shape[0]} nodes but items have {f} "
                f"coordinates — a dims-reduced index needs projection=..., "
                f"a tall energy graph needs pad_tall=True")

        def to_z(rows):
            p = rows if proj is None else rows @ proj.to(rows.device)
            return p if sig is None else p @ sig.to(rows.device).T

        z = [to_z(xs) for xs in x.shards]
        g = z[0].shape[1]
        self._g = g
        knl = _kernel_name(kernel) or energy_session_config(shard_n, k_local,
                                                            g)
        self.kernel = knl
        self.w_lambda, self.w_dirichlet = float(w_lambda), float(w_dirichlet)

        centre = None
        prep = None
        if knl == "binned":
            sums = [zs.sum(dim=0) for zs in z]
            centre = all_reduce_sum(sums, mesh) / n

            def prepare_shards():
                return [prepare_binned_energy_corpus(zs - centre.to(zs.device),
                                                     ls)
                        for zs, ls in zip(z, xl.shards)]
            if prepare_corpus:
                prep = prepare_shards()
            cdt = torch.float32 if z[0].is_cuda else dt
        else:
            cdt = dt
        wl, wd = dtype_scalar(w_lambda, cdt), dtype_scalar(w_dirichlet, cdt)

        def centred(z_q):
            return z_q.to(cdt) - centre.to(device=z_q.device, dtype=cdt)

        def prepare(q):
            q_prep = q if proj is None else q @ proj
            qlam = _query_lambda(q_prep, lap, taumode, pad_tall)
            return (q_prep if sig is None else q_prep @ sig.T), qlam

        def shards_binned(z_c, qlam, shards):
            s_parts, i_parts, fl_parts, det_parts = [], [], [], []
            for j, (zx, zl, zn) in enumerate(shards):
                s, i, fl, det = binned_energy_topk(
                    z_c.to(zx.device), qlam.to(zx.device), zx, zl, zn, wl, wd,
                    k=k_local, n=shard_n)
                s_parts.append(s)
                i_parts.append(i.long() + x.global_offset(j))
                fl_parts.append(fl.to(torch.int32))
                det_parts.append(det)
            s, i = _merge(s_parts, i_parts, mesh, k_eff)
            return (s, i, all_reduce_max(fl_parts, mesh) > 0,
                    gather_columns(det_parts, mesh))

        def shards_chunked(z_q, qlam, planes, lams, w_l, w_d):
            s_parts, i_parts = [], []
            for j, (zs, ls) in enumerate(zip(planes, lams)):
                s, i = energy_topk_chunked(z_q.to(zs.device),
                                           qlam.to(zs.device), zs, ls, w_l,
                                           w_d, k=k_local)
                s_parts.append(s)
                i_parts.append(i.long() + x.global_offset(j))
            return _merge(s_parts, i_parts, mesh, k_eff)

        def step(q):
            z_q, qlam = prepare(q)
            if knl == "binned":
                s, i, flags, det = shards_binned(
                    centred(z_q), qlam, prep if prep is not None
                    else prepare_shards())
                return s, i, flags, qlam, det
            s, i = shards_chunked(z_q, qlam, z, xl.shards, self.w_lambda,
                                  self.w_dirichlet)
            return s, i, None, qlam, None

        def repair(q, qlam, det, scores, ids, flags):
            from ..ops.bin_repair import strided_energy_repair
            rows = np.nonzero(flags)[0]
            if not rows.size:
                return scores, ids
            shards = prep if prep is not None else prepare_shards()
            rt = torch.as_tensor(rows, device=self.device)
            q_rows = (q[rt] if torch.is_tensor(q) else torch.as_tensor(
                q[rows])).to(device=self.device, dtype=dt)
            zc = centred(to_z(q_rows))
            ql = qlam[rt].to(cdt)

            def full_exact(rel_rows):
                rel = torch.as_tensor(rel_rows, device=self.device)
                s, i = shards_chunked(
                    zc[rel], ql[rel], [zx[:shard_n] for zx, _, _ in shards],
                    [zl[:shard_n] for _, zl, _ in shards], wl, wd)
                return s.cpu().numpy(), i.cpu().numpy()

            scores, ids = scores.copy(), ids.copy()
            if mesh.multiprocess:
                scores[rows], ids[rows] = full_exact(np.arange(rows.size))
                return scores, ids
            scores[rows], ids[rows] = strided_energy_repair(
                zc, ql, det[rt].cpu().numpy(), scores[rows, k_eff - 1],
                ids[rows], [s[0] for s in shards], [s[1] for s in shards],
                [s[2] for s in shards], wl, wd, k=k_eff, n=n,
                fallback=full_exact, cur_scores=scores[rows],
                shard_n=shard_n)
            return scores, ids

        self._step = step
        self._repair = repair if knl == "binned" else None
        self._det_width = 0
        if knl == "binned":
            from ..ops.bintopk import bins_target
            self._det_width = mesh.size * bins_target(k_local)

    @classmethod
    def from_index(cls, index, mesh: Mesh, batch_size: int, k: int = 10,
                   w_lambda: float = 1.0, w_dirichlet: float = 0.5,
                   depth: int = 2, **kw) -> "DistributedEnergySearchSession":
        """A mesh energy session over a built energy ArrowIndex: the raw
        items and λ split over the shards, each shard projecting its own
        rows to the z-plane; the graph, the signals (where they are as
        wide as the projected items) and the projection replicate."""
        from ..energymaps import energy_signals
        aspace, gl = index.aspace, index.gl
        proj = None
        width = aspace.nfeatures
        if aspace.projection_matrix is not None:
            proj = aspace.projection_matrix.matrix(dtype=aspace.dtype,
                                                   device=aspace.device)
            width = proj.shape[1]
        return cls(aspace.data, aspace.lambdas, gl.matrix, mesh, batch_size,
                   k=k, w_lambda=w_lambda, w_dirichlet=w_dirichlet,
                   taumode=aspace.taumode, depth=depth, projection=proj,
                   signals=energy_signals(aspace, width),
                   pad_tall=aspace.pad_tall_graphs, **kw)

    def warmup(self) -> None:
        """One full batch through the stream loop and, on the binned
        kernel, one synthetic mesh repair."""
        _warmup(self)

    def search_stream(self, batches):
        """Yield (scores, ids) per input batch with ``depth`` batches in
        flight (index.stream_search)."""
        from ..index import stream_search
        return stream_search(self._step, batches, self.batch_size,
                             self.depth, self.device, self.dtype,
                             dim=self._dim, repair=self._repair)
