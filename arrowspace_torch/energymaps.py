"""Energy-first (cosine-free) pipeline: optical compression, diffusion,
sub-centroid splitting, energy-distance kNN graph, and energy search.

PyTorch counterpart of ``arrowspace_tpu.energymaps`` (reference:
energymaps.rs:28-896).  Stage mapping:

- optical compression  -> seeded 2D projection + host grid binning
  (energymaps.rs:151-245);
- bootstrap L₀         -> the dense graph build over centroid ROWS (X×X,
  un-transposed, energymaps.rs:247-280);
- heat diffusion       -> X ← X - η·(L@X), ``steps`` products
  (energymaps.rs:283-311);
- splitting            -> dispersion quantile + host neighbour stats
  (energymaps.rs:313-366), numpy as in the JAX package;
- energy-distance kNN  -> pairwise products + stable sorts +
  max-symmetrise (energymaps.rs:706-817);
- search_energy        -> λ proximity + projected-Dirichlet scores
  (energymaps.rs:368-407): on corpora above ENERGY_CHUNK rows through the
  binned energy engine (K6 + strided repair, ops/bin_repair), else a
  plain scan.

Every ``lax.top_k`` of the JAX module is a stable sort here, so ties go
to the lowest index as there.  The build stages run in the index dtype
on the index device, as the JAX module runs them in the corpus dtype.

Documented divergence (as in the JAX package): the reference's
``node_energy_and_dispersion`` computes edge weights as
``-(L_ij.max(0))`` (energymaps.rs:576), identically zero for a true
Laplacian, so its dispersion is always 0 and every node is split.  The
intended w = max(-L_ij, 0) is the default; the reference behaviour is
``EnergyParams.reference_dispersion_bug=True``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .core import ArrowSpace
from .graph import GraphLaplacian, GraphParams
from .laplacian import build_laplacian_matrix
from .ops.bin_repair import BinnedEnergyTopK
from .ops.energy_bintopk import ENERGY_CHUNK, energy_topk_chunked
from .reduction import ImplicitProjection
from .utils.log import get_logger

logger = get_logger("arrowspace.energymaps")

__all__ = ["EnergyParams", "ProjectedEnergyParams", "ENERGY_CHUNK",
           "energy_binned_fits", "optical_compress_centroids",
           "bootstrap_centroid_laplacian", "diffuse_and_split_subcentroids",
           "node_energy_and_dispersion", "build_energy_laplacian",
           "search_energy", "search_energy_batch", "build_energy",
           "robust_scale", "bounded_l2_energy"]


@dataclass
class EnergyParams:
    """Energy-pipeline parameters (reference: energymaps.rs:28-71)."""

    optical_tokens: Optional[int] = None
    trim_quantile: float = 0.1
    eta: float = 0.1
    steps: int = 4
    split_quantile: float = 0.9
    neighbor_k: int = 8
    split_tau: float = 0.15
    w_lambda: float = 1.0
    w_disp: float = 0.5
    w_dirichlet: float = 0.25
    candidate_m: int = 32
    # opt-in reproduction of the reference's zero-dispersion behaviour
    reference_dispersion_bug: bool = False
    # Lift the reference's n <= F λ ceiling (taumode.rs:574): λ zero-pads
    # items to graphs with more sub-centroids than item coordinates.
    # Default False = reference parity (raises on a tall graph).
    allow_tall_graphs: bool = False


@dataclass
class ProjectedEnergyParams:
    """Projection-aware scoring weights (reference: energymaps.rs:825-836)."""
    w_lambda: float = 1.0
    w_dirichlet: float = 0.5
    eps_norm: float = 1e-9


def robust_scale(x) -> float:
    """1.4826·MAD robust scale, floored at 1e-9
    (reference: energymaps.rs:525-539)."""
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        return 1.0
    v = np.sort(x)
    median = v[v.size // 2]
    devs = np.sort(np.abs(v - median))
    mad = devs[devs.size // 2]
    return max(1.4826 * mad, 1e-9)


def bounded_l2_energy(diff) -> float:
    """‖d‖/(1+‖d‖), capped at 1 (reference: energymaps.rs:844-847)."""
    num = float(np.linalg.norm(np.asarray(diff, dtype=np.float64)))
    return min(num / (1.0 + num), 1.0)


def energy_binned_fits(nitems: int, k: int, g: int) -> bool:
    """The energy engine gate, keyed on size alone: a corpus past
    ENERGY_CHUNK rows, k up to 128 and any z-width take the binned engine
    (K6, or K7 with approx) on every device (the energy tile's shared
    memory does not grow with G); the CPU runs it through the kernels'
    plain versions."""
    return nitems > ENERGY_CHUNK and k <= 128 and g >= 1


def _as_tensor(x, device, dtype) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
        device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Optical compression (energymaps.rs:151-245)
# ---------------------------------------------------------------------------

def optical_compress_centroids(centroids, token_budget: int,
                               trim_quantile: float,
                               seed: Optional[int] = None) -> torch.Tensor:
    """2D spatial binning with low-activation pooling.  The 2D projection
    is seed-deterministic when a seed is supplied; its numbers are
    torch's (reduction.py), so the bins differ from the JAX package's."""
    cent_t = centroids if torch.is_tensor(centroids) \
        else torch.as_tensor(np.asarray(centroids, dtype=np.float64))
    cent = cent_t.double().cpu().numpy()
    x, f = cent.shape
    if token_budget == 0 or token_budget >= x:
        logger.info("Optical compression skipped: budget %d >= centroids %d",
                    token_budget, x)
        return cent_t

    proj = ImplicitProjection(f, 2, **({"seed": seed}
                                       if seed is not None else {}))
    xy = proj.project_device(cent_t).double().cpu().numpy()     # (x, 2)

    g = math.ceil(math.sqrt(token_budget))
    minx, maxx = xy[:, 0].min(), xy[:, 0].max()
    miny, maxy = xy[:, 1].min(), xy[:, 1].max()
    bx = np.clip(np.floor((xy[:, 0] - minx) / (maxx - minx + 1e-9) * g),
                 0, g - 1).astype(int)
    by = np.clip(np.floor((xy[:, 1] - miny) / (maxy - miny + 1e-9) * g),
                 0, g - 1).astype(int)
    bin_ids = by * g + bx

    norms = np.linalg.norm(cent, axis=1)
    out_rows = []
    for b in range(g * g):
        members = np.nonzero(bin_ids == b)[0]
        if members.size == 0:
            continue
        if members.size > 4:
            # trim the top trim_quantile by norm (energymaps.rs:431-448);
            # floor(x+0.5) is Rust's f64::round, not banker's rounding
            order = members[np.argsort(norms[members], kind="stable")]
            cut = int(np.clip(
                np.floor(members.size * (1.0 - trim_quantile) + 0.5),
                1, members.size))
            members = order[:cut]
        out_rows.append(cent[members].mean(axis=0))
        if len(out_rows) >= token_budget:
            break

    if len(out_rows) < token_budget:
        # top-up with lowest-norm original centroids (energymaps.rs:217-240)
        for i in np.argsort(norms, kind="stable"):
            if len(out_rows) >= token_budget:
                break
            out_rows.append(cent[i])

    out = np.stack(out_rows, axis=0)
    logger.info("Optical compression complete: %d -> %d centroids", x,
                out.shape[0])
    return torch.as_tensor(out).to(device=cent_t.device, dtype=cent_t.dtype)


# ---------------------------------------------------------------------------
# Bootstrap Laplacian (energymaps.rs:247-280)
# ---------------------------------------------------------------------------

def bootstrap_centroid_laplacian(centroids: torch.Tensor, k: int,
                                 normalise: bool,
                                 sparsity_check: bool) -> GraphLaplacian:
    """L₀ over centroid ROWS (X×X, un-transposed, energymaps.rs:270), on
    the centroids' device in their dtype."""
    x = centroids.shape[0]
    params = GraphParams(eps=1e-3, k=min(k, x - 1), topk=min(k, 4, x - 1),
                         p=2.0, sigma=None, normalise=normalise,
                         sparsity_check=False)  # disabled for small matrices
    gl = build_laplacian_matrix(centroids, params, n_items=x,
                                device=centroids.device,
                                dtype=centroids.dtype)
    assert gl.nnodes == x, f"L0 must be in centroid space ({x}x{x})"
    return gl


# ---------------------------------------------------------------------------
# Diffusion + splitting (energymaps.rs:283-366)
# ---------------------------------------------------------------------------

def _diffuse(work: torch.Tensor, lap: torch.Tensor, eta: float,
             steps: int) -> torch.Tensor:
    """x ← x - η·Lx for ``steps`` iterations."""
    for _ in range(steps):
        work = work - eta * (lap @ work)
    return work


def _pairwise_d2(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between rows, +inf on the diagonal."""
    sq = (x * x).sum(dim=1)
    d2 = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    return d2.fill_diagonal_(float("inf"))


def node_energy_and_dispersion(x, gl: GraphLaplacian, k: int,
                               bug_compat: bool = False):
    """(lambda, gini) per node as numpy (reference: energymaps.rs:550-596):
    the Rayleigh quotient of each node row and the dispersion of its
    edge energy over its k nearest rows by L2."""
    lap = gl.matrix
    x = _as_tensor(x, lap.device, lap.dtype)
    n = x.shape[0]
    lx = lap @ x
    denom = (x * x).sum(dim=1).clamp_min(1e-9)
    lam = (x * lx).sum(dim=1) / denom

    d2 = _pairwise_d2(x)
    kk = min(k, n - 1)
    nbr = torch.argsort(d2, dim=1, stable=True)[:, :kk]
    nd2 = d2.gather(1, nbr).clamp_min(0.0)
    lnb = lap.gather(1, nbr)
    if bug_compat:
        # reference: w = -(L_ij.max(0)) -> 0 for true Laplacians
        w = -lnb.clamp_min(0.0)
    else:
        w = (-lnb).clamp_min(0.0)
    parts = (w * nd2).clamp_min(0.0)
    s = parts.sum(dim=1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    shares = torch.where(s[:, None] > 0.0,
                         parts / s[:, None].clamp_min(1e-30), zero)
    gini = torch.where(s > 0.0, (shares * shares).sum(dim=1), zero)
    return lam.cpu().numpy(), gini.cpu().numpy()


def diffuse_and_split_subcentroids(centroids, l0: GraphLaplacian,
                                   p: EnergyParams) -> torch.Tensor:
    """Diffusion smoothing + split of high-dispersion nodes
    (reference: energymaps.rs:283-366)."""
    lap = l0.matrix
    cent = _as_tensor(centroids, lap.device, lap.dtype)
    x = cent.shape[0]
    work = _diffuse(cent, lap, p.eta, p.steps)

    lam, gini = node_energy_and_dispersion(
        work, l0, p.neighbor_k, bug_compat=p.reference_dispersion_bug)

    g_sorted = np.sort(gini)
    q_idx = int(np.floor((g_sorted.size - 1) * p.split_quantile + 0.5))
    thresh = g_sorted[q_idx]

    work_np = work.double().cpu().numpy()
    rows = [work_np]
    split_idx = np.nonzero(gini >= thresh)[0]
    if split_idx.size:
        sq = np.sum(work_np * work_np, axis=1)
        d2 = sq[split_idx][:, None] - 2.0 * work_np[split_idx] @ work_np.T \
            + sq[None, :]
        d2[np.arange(split_idx.size), split_idx] = np.inf
        kk = min(p.neighbor_k, x - 1)
        nbrs = np.argpartition(d2, kk - 1, axis=1)[:, :kk]   # (S, kk)
        means = work_np[nbrs].mean(axis=1)                   # (S, F)
        diffs = work_np[split_idx] - means
        nrms = np.maximum(np.linalg.norm(diffs, axis=1, keepdims=True), 1e-9)
        directions = diffs / nrms
        d_means = diffs.mean(axis=1, keepdims=True)
        std_locs = np.sqrt(np.mean((diffs - d_means) ** 2, axis=1))
        taus_s = (p.split_tau * np.maximum(std_locs, 1e-6))[:, None]
        rows.append(work_np[split_idx] + taus_s * directions)
        rows.append(work_np[split_idx] - taus_s * directions)

    out = np.concatenate(rows, axis=0)
    logger.info("Sub-centroid generation: %d -> %d centroids (%d splits)",
                x, out.shape[0], split_idx.size)
    return torch.as_tensor(out).to(device=cent.device, dtype=cent.dtype)


# ---------------------------------------------------------------------------
# Energy Laplacian (energymaps.rs:706-817)
# ---------------------------------------------------------------------------

def _energy_knn(xs, lam, gini, s_l: float, s_g: float, w_lambda: float,
                w_disp: float, w_dirichlet: float, *, m: int, keep_k: int):
    """Energy-distance kNN with candidate-M pruning, w = exp(-d),
    max-symmetrisation, L = D - A.  Returns (adjacency, Laplacian,
    off-diagonal nnz)."""
    n = xs.shape[0]
    d2 = _pairwise_d2(xs)
    mm = min(m, n - 1)
    cand = torch.argsort(d2, dim=1, stable=True)[:, :mm]       # (n, mm)

    d_lambda = (lam[:, None] - lam[cand]).abs() / s_l
    d_gini = (gini[:, None] - gini[cand]).abs() / s_g
    l2 = d2.gather(1, cand).clamp_min(0.0).sqrt()
    r_pair = (l2 / (1.0 + l2)).clamp_max(1.0)
    dist = w_lambda * d_lambda + w_disp * d_gini + w_dirichlet * r_pair

    kk = min(keep_k, mm)
    sel = torch.argsort(dist, dim=1, stable=True)[:, :kk]      # k smallest
    sel_j = cand.gather(1, sel)
    w = torch.exp(-dist.gather(1, sel))

    rows = torch.arange(n, device=xs.device)[:, None].expand(n, kk)
    adj = torch.zeros(n * n, dtype=xs.dtype, device=xs.device)
    adj.scatter_reduce_(0, (rows * n + sel_j).reshape(-1), w.reshape(-1),
                        reduce="amax")
    adj = adj.reshape(n, n)
    adj = torch.maximum(adj, adj.T)                            # symmetrise
    adj.fill_diagonal_(0.0)
    lap = torch.diag(adj.sum(dim=1)) - adj
    return adj, lap, int((adj > 0).sum())


def build_energy_laplacian(builder, sub_centroids, energy_params: EnergyParams
                           ) -> Tuple[GraphLaplacian, np.ndarray, np.ndarray]:
    """Energy-distance kNN Laplacian (reference: energymaps.rs:706-817),
    on the builder's device in its dtype."""
    xs = _as_tensor(sub_centroids, builder.device, builder.dtype)
    x = xs.shape[0]
    logger.info("build_energy_laplacian: %d sub-centroids, k=%d", x,
                builder.lambda_k)
    kb = max(energy_params.neighbor_k, builder.lambda_k)
    l_boot = bootstrap_centroid_laplacian(xs, kb, builder.normalise,
                                          builder.sparsity_check)
    lam, gini = node_energy_and_dispersion(
        xs, l_boot, kb, bug_compat=energy_params.reference_dispersion_bug)
    s_l = max(robust_scale(lam), 1e-9)
    s_g = max(robust_scale(gini), 1e-9)

    dt, dev = xs.dtype, xs.device
    _, lap, nnz_off = _energy_knn(
        xs, torch.as_tensor(lam).to(device=dev, dtype=dt),
        torch.as_tensor(gini).to(device=dev, dtype=dt), s_l, s_g,
        energy_params.w_lambda, energy_params.w_disp,
        energy_params.w_dirichlet,
        m=max(energy_params.candidate_m, builder.lambda_k),
        keep_k=builder.lambda_k)

    gl = GraphLaplacian(
        init_data=xs,
        matrix=lap,
        nnodes=x,
        graph_params=GraphParams(
            eps=builder.lambda_eps, k=builder.lambda_k,
            topk=builder.lambda_topk, p=2.0, sigma=None,
            normalise=builder.normalise,
            sparsity_check=builder.sparsity_check),
        structural_nnz=x + nnz_off,
    )
    logger.info("Energy Laplacian built: %dx%d, %d nnz", x, x, gl.nnz())
    return gl, lam, gini


# ---------------------------------------------------------------------------
# Energy search (energymaps.rs:368-407, 849-896)
# ---------------------------------------------------------------------------

def _query_z(aspace: ArrowSpace, queries: np.ndarray) -> torch.Tensor:
    """The queries in the index's projected space on the index device:
    projected on the host in float64 when the build projected, as
    search_energy_batch of the JAX package does."""
    if aspace.projection_matrix is not None:
        queries = aspace.projection_matrix.project_batch_host(queries)
    return torch.as_tensor(queries).to(device=aspace.device,
                                       dtype=aspace.dtype)


def energy_signals(aspace: ArrowSpace, width: int) -> Optional[torch.Tensor]:
    """The signals graph where it is set, non-empty and as wide as the
    projected items (``width``): the energy score then measures
    differences through it (energymaps.rs:865-881); else None."""
    sig = aspace.signals
    if sig is not None and sig.shape[0] > 0 and sig.shape[1] == width:
        return sig.to(device=aspace.device, dtype=aspace.dtype)
    return None


def _projected_dirichlet_batch(aspace: ArrowSpace, diffs: torch.Tensor
                               ) -> torch.Tensor:
    """Bounded projected Dirichlet of (N, F′) differences: ‖S·d‖ through
    the signals graph where its shape lines up, else ‖d‖, mapped to
    min(num/(1+num), 1) (reference: energymaps.rs:865-881)."""
    sig = energy_signals(aspace, diffs.shape[1])
    y = diffs if sig is None else diffs @ sig.T
    num = torch.sqrt((y * y).sum(dim=1))
    return (num / (1.0 + num)).clamp_max(1.0)


def _energy_z_items(aspace: ArrowSpace, items_proj: torch.Tensor,
                    signals: Optional[torch.Tensor]) -> torch.Tensor:
    """The corpus z-plane of the streaming energy search: z = x_proj·Sᵀ,
    computed once and cached on the ArrowSpace (the cache follows the
    signals' shape and the row count, as the JAX package's does, and any
    change of the items drops it); the projected items themselves when
    there is no signals graph.  ‖S(q - x)‖ = ‖Sq - Sx‖, so the scores
    need only z-distances."""
    if signals is None:
        return items_proj
    cache = aspace._energy_z_cache
    if cache is not None and cache[0] == tuple(signals.shape) \
            and cache[1].shape[0] == items_proj.shape[0]:
        return cache[1]
    z = items_proj @ signals.T
    aspace._energy_z_cache = (tuple(signals.shape), z)
    return z


def _energy_score_topk(q_proj, lambda_q, items_proj, item_lambdas,
                       w_lambda: float, w_dirichlet: float, *, k: int,
                       signals: Optional[torch.Tensor] = None):
    """In-memory energy scores of corpora up to ENERGY_CHUNK rows, as the
    JAX package's _energy_score_topk (energymaps.py:397-414): the bounded
    L2 of the (B, N, F′) differences, through the signals graph when
    given, score = -(w_λ·|Δλ| + w_D·d), and a stable top-k.  Returns
    (scores (B, k), ids (B, k))."""
    out_s, out_i = [], []
    width = items_proj.shape[1] if signals is None else signals.shape[0]
    rows = max(1, (1 << 24) // max(1, items_proj.shape[0] * width))
    for b0 in range(0, q_proj.shape[0], rows):
        diffs = q_proj[b0:b0 + rows, None, :] - items_proj[None, :, :]
        if signals is not None:
            diffs = torch.einsum("bnf,gf->bng", diffs, signals)
        num = torch.sqrt((diffs * diffs).sum(dim=2))
        d_dir = (num / (1.0 + num)).clamp_max(1.0)
        d_lambda = (lambda_q[b0:b0 + rows, None]
                    - item_lambdas[None, :]).abs()
        scores = -(w_lambda * d_lambda + w_dirichlet * d_dir)
        _, order = torch.sort(-scores, dim=1, stable=True)
        order = order[:, :k]
        out_s.append(scores.gather(1, order))
        out_i.append(order)
    return torch.cat(out_s), torch.cat(out_i)


def search_energy_batch(aspace: ArrowSpace, queries, gl_energy: GraphLaplacian,
                        k: int, w_lambda: float, w_dirichlet: float):
    """Batched energy-only ranking: (B, F) queries -> host (scores, ids)
    (the serving-path variant of search_energy).  Above ENERGY_CHUNK rows
    the z-plane (_energy_z_items) is served by the binned energy engine
    (K6 + exact repair, the session's engine) where energy_binned_fits
    admits the size, else by the chunked scan; below it the in-memory
    scan."""
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
    lambda_q = aspace.prepare_query_items_batch(queries, gl_energy)
    q_proj = _query_z(aspace, queries)
    items_proj = aspace.projected_items()
    signals = energy_signals(aspace, items_proj.shape[1])
    k_eff = min(k, aspace.nitems)
    if aspace.nitems > ENERGY_CHUNK:
        z_items = _energy_z_items(aspace, items_proj, signals)
        z_q = q_proj if signals is None else q_proj @ signals.T
        if energy_binned_fits(aspace.nitems, k_eff, z_items.shape[1]):
            engine = BinnedEnergyTopK(z_items, aspace.lambdas, w_lambda,
                                      w_dirichlet, k_eff)
            return engine(z_q, lambda_q)
        s, i = energy_topk_chunked(z_q, lambda_q, z_items,
                                   aspace.lambdas, w_lambda, w_dirichlet,
                                   k=k_eff)
        return s.cpu().numpy(), i.cpu().numpy()
    s, i = _energy_score_topk(q_proj, lambda_q.to(aspace.dtype), items_proj,
                              aspace.lambdas, w_lambda, w_dirichlet, k=k_eff,
                              signals=signals)
    return s.cpu().numpy(), i.cpu().numpy()


def search_energy(aspace: ArrowSpace, query, gl_energy: GraphLaplacian,
                  k: int, w_lambda: float, w_dirichlet: float):
    """Energy-only ranking: score = -(wλ·|Δλ| + wD·Dirichlet)
    (reference: energymaps.rs:368-407).  The query λ is computed once,
    as in the JAX package (the reference recomputes it per item)."""
    lambda_q = aspace.prepare_query_item(query, gl_energy)
    q_proj = torch.as_tensor(aspace.project_query(query)).to(
        device=aspace.device, dtype=aspace.dtype)
    d_dir = _projected_dirichlet_batch(
        aspace, q_proj[None, :] - aspace.projected_items())
    d_lambda = (lambda_q - aspace.lambdas).abs()
    scores = -(w_lambda * d_lambda + w_dirichlet * d_dir)
    k_eff = min(k, aspace.nitems)
    _, order = torch.sort(-scores, stable=True)
    order = order[:k_eff]
    return [(int(i), float(s)) for i, s in
            zip(order.tolist(), scores[order].tolist())]


# ---------------------------------------------------------------------------
# Builder entry point (energymaps.rs:677-704)
# ---------------------------------------------------------------------------

def build_energy(builder, rows, energy_params: EnergyParams
                 ) -> Tuple[ArrowSpace, GraphLaplacian]:
    """Energy-only build (reference: energymaps.rs:677-704): clustering
    with the JL projection, optional optical compression, L₀ over the
    centroids, diffusion and splitting, the energy kNN Laplacian, then λ
    of the raw rows against it.  Wall seconds per stage land in
    ``builder.stage_seconds``."""
    from . import eigenmaps as em

    assert builder.use_dims_reduction, \
        "When using build energy, dim reduction is needed"
    t = [time.perf_counter()]

    def lap_time():
        builder._sync()
        t.append(time.perf_counter())

    clustered = em.start_clustering(builder, rows)
    aspace = clustered.aspace
    centroids = _as_tensor(clustered.centroids, aspace.device, aspace.dtype)
    lap_time()

    if energy_params.optical_tokens is not None:
        centroids = optical_compress_centroids(
            centroids, energy_params.optical_tokens,
            energy_params.trim_quantile, seed=builder.clustering_seed)
    l0 = bootstrap_centroid_laplacian(
        centroids, max(energy_params.neighbor_k, builder.lambda_k),
        builder.normalise, builder.sparsity_check)
    sub_centroids = diffuse_and_split_subcentroids(centroids, l0,
                                                   energy_params)
    if energy_params.optical_tokens is not None:
        sub_centroids = optical_compress_centroids(
            sub_centroids, energy_params.optical_tokens,
            energy_params.trim_quantile, seed=builder.clustering_seed)
    lap_time()

    gl_energy, _, _ = build_energy_laplacian(builder, sub_centroids,
                                             energy_params)
    lap_time()
    aspace.pad_tall_graphs = energy_params.allow_tall_graphs
    em.compute_taumode(aspace, gl_energy)
    lap_time()
    builder.stage_seconds = {
        name: t[i + 1] - t[i] for i, name in enumerate(
            ("clustering", "subcentroids", "energy_laplacian", "taumode"))}
    return aspace, gl_energy


# The reference's trait impls, attached as the JAX package attaches them
# (energymaps.py:686-694 of the JAX package).
ArrowSpace.optical_compress_centroids = staticmethod(optical_compress_centroids)
ArrowSpace.bootstrap_centroid_laplacian = staticmethod(
    bootstrap_centroid_laplacian)
ArrowSpace.diffuse_and_split_subcentroids = staticmethod(
    diffuse_and_split_subcentroids)
ArrowSpace.search_energy = search_energy

from .builder import ArrowSpaceBuilder  # noqa: E402
ArrowSpaceBuilder.build_energy = build_energy
ArrowSpaceBuilder.build_energy_laplacian = build_energy_laplacian
