"""Exact cell-screened search: the low-latency pruned sessions.

PyTorch counterpart of ``arrowspace_tpu.pruned``.  The serving kernels
stream every corpus row for every batch; this module scores, for a
small or mid-size batch, only the corpus cells whose score upper bound
can reach a query's top-k, and stays exact:

    cells = build_cells(index.aspace.data, index.aspace.lambdas)
    session = index.make_pruned_session(batch_size=16, k=10)
    scores, ids = session.search(queries)

The corpus is grouped into units of at most ``cap`` rows (Lloyd
clusters in cosine space, split λ-sorted), each with the spherical cap
around its unit centroid ĉ that holds its members (cos θr = the least
member dot x̂·ĉ) and its λ range.  On the shifted score plane of
ops/search.shifted_lambda_plane, s' = α·q̂·x̂ − c1·min(|Δλ|, 1), every
member of a unit scores at most

    U'(q, unit) = α·cos(max(0, θq − θr)) − c1·min(dmin, 1),
    cos(max(0, θq − θr)) = 1 if c >= cos θr else c·cos θr + √(1−c²)·sin θr,

with c = q̂·ĉ and dmin the distance from λq to the unit's λ range.  A
query scores the rows of its top-M units by U' exactly; when the
(M+1)-th bound plus a margin stays below its k-th score, no other row
can enter its top-k (ties included: the comparison is strict after the
margin) and the result equals the full scan.  Otherwise the query is
FLAGGED and the session re-runs it through the index's exact engine
(ArrowSpace.search_lambda_aware_batch: K1 with its repair, K3 or the
plain scan, by size), with the query λ the step computed.

Two screens share the bound plane: ``pruned_topk`` (B <= 16, each
query gathers its own units) and ``pruned_topk_union`` (B in (16, 512],
each query votes for its top units and the batch scores one shared
union of them).  Both are plain PyTorch, as the JAX package computes
them outside any Pallas kernel: the bound product, a stable order of
the bounds, a gather of whole (cap, F) units, the scoring product by
the rule of ops/search.dot_plane, and an extraction with ties to the
lowest global id.

Two choices differ from the JAX package:
- the device build takes cos θr from the least member dot, as the host
  build does, and not from 1 − d²/2, which does not hold for a zero row
  (the zero vector lies at d² = 1 from any unit centroid, yet its dot
  is 0): the bound stays sound on corpora with zero rows;
- auto_budget decides only once ``auto_window`` queries are in its
  window.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import numpy_dtype, resolve
from .ops.search import (dot_plane, lambda_term, row_dots, safe_unit,
                         two_key_topk)
from .utils.log import get_logger

logger = get_logger("arrowspace.pruned")

__all__ = ["PrunedCells", "build_cells", "build_cells_device",
           "save_cells", "load_cells", "pruned_topk", "pruned_topk_union",
           "PrunedSearchSession"]

# Slack of the bound metadata the device build computes in the corpus
# dtype (the host build computes it in float64 and adds 1e-6): the d²
# and dot reductions over F unit-scale values err by ~1e-5 in float32,
# and the session's default margin is 1e-3 (pruned.py:447 of the JAX
# package).
_DEV_META_SLACK = 1e-4
# Rows of a Lloyd block and values of a metadata block.
_LLOYD_BLOCK = 8192
_META_ELEMS = 1 << 27
_CELLS_FORMAT = 1
_FIELDS = ("x", "lam", "ids", "cent", "radius", "cosr", "sinr", "lam_lo",
           "lam_hi")


class PrunedCells(NamedTuple):
    """The cell-grouped corpus on one device.

    ``x`` holds the unit-normalised rows in unit order, each unit padded
    to ``cap`` slots, ``ids`` their global ids (-1 in padding).  Units
    past ``n_units`` pad the unit count (_unit_pad) and are dummies:
    radius -2, λ range (+inf, -inf)."""
    x: torch.Tensor        # (U·cap, F)
    lam: torch.Tensor      # (U·cap,) item λ, 0 in padding
    ids: torch.Tensor      # (U·cap,) int32
    cent: torch.Tensor     # (U, F) unit centroids, unit norm (0 in dummies)
    radius: torch.Tensor   # (U,) max ‖x̂ − ĉ‖ (+slack); -2 in dummies
    cosr: torch.Tensor     # (U,) cos of the cap's angular radius (−slack)
    sinr: torch.Tensor     # (U,) sin of it (+slack)
    lam_lo: torch.Tensor   # (U,) least member λ
    lam_hi: torch.Tensor   # (U,) largest member λ
    cap: int
    n_units: int           # real units


def _placement(data, device, dtype):
    """(device, dtype) of a build: a tensor's own unless given, else the
    package defaults, a numpy float array keeping its dtype."""
    if torch.is_tensor(data):
        return (torch.device(device) if device is not None else data.device,
                dtype or data.dtype)
    dev, dt = resolve(device, dtype)
    if dtype is None and getattr(data, "dtype", None) is not None and \
            np.issubdtype(data.dtype, np.floating):
        dt = torch.from_numpy(np.zeros(0, dtype=data.dtype)).dtype
    return dev, dt


def _host64(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().double().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _sync(dev: torch.device) -> float:
    """Host clock once the device's queued work is done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _assign_chunked(xhat: torch.Tensor, cent: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """argmax_c x̂·ĉ per row (the first of equal maxima), in row chunks so
    the (chunk, C) score block is the working set."""
    out = torch.empty(xhat.shape[0], dtype=torch.int64, device=xhat.device)
    for c0 in range(0, xhat.shape[0], chunk):
        out[c0:c0 + chunk] = torch.argmax(xhat[c0:c0 + chunk] @ cent.T,
                                          dim=1)
    return out


def _lloyd(xhat: torch.Tensor, cent0: torch.Tensor, *, iters: int,
           block: int) -> torch.Tensor:
    """Cosine-space Lloyd iterations: assign each row to its max-dot
    centroid, move each centroid to its normalised member mean; an empty
    cluster keeps its centroid.  The member sums are one-hot products
    over ``block``-row blocks (pruned.py:169-215 of the JAX package):
    an atomic index_add_ would make two card builds of one corpus differ."""
    n_cells = cent0.shape[0]
    cells = torch.arange(n_cells, device=xhat.device)
    cent = cent0
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        counts = torch.zeros(n_cells, dtype=torch.int64, device=xhat.device)
        for b0 in range(0, xhat.shape[0], block):
            xb = xhat[b0:b0 + block]
            a = torch.argmax(xb @ cent.T, dim=1)
            sums += (a[:, None] == cells[None, :]).to(xb.dtype).T @ xb
            counts += torch.bincount(a, minlength=n_cells)
        norms = (sums * sums).sum(dim=1, keepdim=True).sqrt()
        ok = (counts[:, None] > 0) & (norms > 0)
        cent = torch.where(ok, sums / torch.where(norms > 0, norms,
                                                  torch.ones_like(norms)),
                           cent)
    return cent


def _assign_chunk_rows(n: int) -> int:
    return min(65536, max(1024, 1 << int(np.ceil(np.log2(max(2, n))))))


def _n_cells(n: int, cap: int, n_clusters: Optional[int]) -> int:
    return max(1, min(n, n_clusters if n_clusters is not None
                      else -(-n // cap)))


def _unit_norm_np(rows: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    return np.where(norms > 0, rows / np.where(norms > 0, norms, 1.0), 0.0)


def _unit_pad(u_real: int) -> int:
    """The unit count padded: powers of two up to 4096, then multiples of
    1024 (pruned.py:223-232 of the JAX package), so that a layout is
    array for array the JAX package's and one .npz serves both."""
    p2 = max(8, 1 << int(np.ceil(np.log2(max(2, u_real)))))
    if p2 <= 4096:
        return p2
    return max(4096, -(-u_real // 1024) * 1024)


def build_cells(data, lambdas, cap: int = 256, seed: int = 0,
                iters: int = 8, dtype=None,
                n_clusters: Optional[int] = None,
                lloyd_sample: Optional[int] = None, *, device=None,
                stages: Optional[dict] = None) -> PrunedCells:
    """Group the corpus into units of at most ``cap`` rows with their
    bound metadata (pruned.py:235-383 of the JAX package).

    The rows are normalised in float64 on the host; a Lloyd pass on the
    device (C = ⌈N/cap⌉ centroids, or ``n_clusters``, seeded from
    ``default_rng(seed).choice`` rows, fitted on ``lloyd_sample`` rows
    when given) assigns them; each cluster is λ-sorted and cut into
    units, whose centroid, cap and λ range come from the unit's own rows
    in float64 (+1e-6 slack).  On the CPU in float64 the units are the
    JAX package's.  The layout lands on ``device`` (a tensor's own by
    default) in ``dtype``; ``stages``, when given, receives each stage's
    seconds.

    Provisioning: set ``n_clusters`` to 2-4x the corpus's expected
    cluster count, never to the count itself.  Seeding from random rows
    leaves about 1/e of the true clusters without a seed, Lloyd merges
    them, and a merged cell's bound is nearly vacuous (the JAX package
    measured every hot query flagged at C = the true count)."""
    t0 = time.perf_counter()
    dev, dt = _placement(data, device, dtype)
    np_dt = numpy_dtype(dt)
    rows = _host64(data)
    lam64 = _host64(lambdas)
    n, f = rows.shape
    cap = int(cap)
    assert cap > 0 and n > 0
    xhat64 = _unit_norm_np(rows)
    n_cells = _n_cells(n, cap, n_clusters)
    rng = np.random.default_rng(seed)
    seed_rows = rng.choice(n, size=n_cells, replace=False)
    t_norm = time.perf_counter()

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np_dt)).to(dev)

    if n_cells == 1:
        assign = np.zeros((n,), dtype=np.int64)
    else:
        chunk = _assign_chunk_rows(n)
        xhat_dev = up(xhat64)
        cent0 = up(xhat64[seed_rows])
        if lloyd_sample is not None and lloyd_sample < n:
            fit = rng.choice(n, size=int(lloyd_sample), replace=False)
            cent = _lloyd(up(xhat64[fit]), cent0, iters=iters,
                          block=min(chunk, int(lloyd_sample), _LLOYD_BLOCK))
        else:
            cent = _lloyd(xhat_dev, cent0, iters=iters,
                          block=min(chunk, _LLOYD_BLOCK))
        assign = _assign_chunked(xhat_dev, cent, chunk).cpu().numpy()
        del xhat_dev
    t_lloyd = _sync(dev)

    # units: each cluster λ-sorted (tight λ ranges for the dmin term),
    # then cut into cap-row pieces
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(n_cells))
    ends = np.searchsorted(sorted_assign, np.arange(n_cells), side="right")
    unit_rows = []
    for c in range(n_cells):
        members = order[starts[c]:ends[c]]
        members = members[np.argsort(lam64[members], kind="stable")]
        for lo in range(0, len(members), cap):
            unit_rows.append(members[lo:lo + cap])
    u_real = len(unit_rows)
    u_pad = _unit_pad(u_real)

    gx = np.zeros((u_pad * cap, f), dtype=np_dt)
    glam = np.zeros((u_pad * cap,), dtype=np_dt)
    gids = np.full((u_pad * cap,), -1, dtype=np.int32)
    cent = np.zeros((u_pad, f), dtype=np.float64)
    radius = np.full((u_pad,), -2.0, dtype=np.float64)
    cosr = np.ones((u_pad,), dtype=np.float64)
    sinr = np.zeros((u_pad,), dtype=np.float64)
    lam_lo = np.full((u_pad,), np.inf, dtype=np.float64)
    lam_hi = np.full((u_pad,), -np.inf, dtype=np.float64)
    for u, members in enumerate(unit_rows):
        m = len(members)
        xs = xhat64[members]
        gx[u * cap:u * cap + m] = xs
        glam[u * cap:u * cap + m] = lam64[members]
        gids[u * cap:u * cap + m] = members
        c_raw = xs.mean(axis=0)
        c_norm = np.linalg.norm(c_raw)
        c_hat = c_raw / c_norm if c_norm > 0 else np.zeros((f,))
        cent[u] = c_hat
        radius[u] = float(np.sqrt(((xs - c_hat) ** 2).sum(axis=1).max())) \
            + 1e-6
        # a zero-norm centroid (cancelled rows) keeps the whole sphere
        cr = float(np.clip((xs @ c_hat).min(), -1.0, 1.0)) - 1e-6 \
            if c_norm > 0 else -1.0
        cosr[u] = max(-1.0, cr)
        sinr[u] = min(1.0, float(np.sqrt(max(0.0, 1.0 - cosr[u] ** 2)))
                      + 1e-6)
        lam_lo[u] = lam64[members].min()
        lam_hi[u] = lam64[members].max()
    cells = PrunedCells(
        x=up(gx), lam=up(glam), ids=torch.from_numpy(gids).to(dev),
        cent=up(cent), radius=up(radius), cosr=up(cosr), sinr=up(sinr),
        lam_lo=up(lam_lo), lam_hi=up(lam_hi), cap=cap, n_units=u_real)
    t_end = _sync(dev)
    if stages is not None:
        stages.update(normalise=t_norm - t0, lloyd=t_lloyd - t_norm,
                      units=t_end - t_lloyd)
    logger.info("pruned cells: %d rows -> %d units (cap %d, %d clusters, "
                "padded to %d) in %.2fs", n, u_real, cap, n_cells, u_pad,
                t_end - t0)
    return cells


def save_cells(cells: PrunedCells, path: str) -> None:
    """One uncompressed .npz of the layout (format 1, the JAX package's):
    bound metadata round-trips bitwise, so a loaded layout certifies the
    same queries.  Either package reads what the other wrote."""
    arrays = {name: getattr(cells, name).cpu().numpy() for name in _FIELDS}
    np.savez(path, format=np.int64(_CELLS_FORMAT),
             cap=np.int64(cells.cap), n_units=np.int64(cells.n_units),
             **arrays)
    logger.info("pruned cells saved to %s (%.2f GB grouped rows)", path,
                arrays["x"].nbytes / 2**30)


def load_cells(path: str, dtype=None, *, device=None) -> PrunedCells:
    """A layout written by save_cells (of either package) on ``device``;
    ``dtype`` overrides the stored float dtype."""
    if not str(path).endswith(".npz"):
        path = str(path) + ".npz"
    with np.load(path) as z:
        fmt = int(z["format"])
        if fmt != _CELLS_FORMAT:
            raise ValueError(f"unsupported cells format {fmt} "
                             f"(this build reads {_CELLS_FORMAT})")
        dev, dt = _placement(z["x"], device, dtype)
        arrays = {name: torch.from_numpy(z[name]).to(
            device=dev, dtype=torch.int32 if name == "ids" else dt)
            for name in _FIELDS}
        return PrunedCells(**arrays, cap=int(z["cap"]),
                           n_units=int(z["n_units"]))


def _meta_block(x: torch.Tensor, glam: torch.Tensor, ids: torch.Tensor):
    """Bound metadata of grouped units x (ub, cap, F), in the corpus
    dtype, with _DEV_META_SLACK.  cos θr is the least member dot x̂·ĉ, as
    the host build takes it (pruned.py:362-366 of the JAX package)."""
    mask = ids >= 0
    cnt = mask.sum(dim=1)
    craw = x.sum(dim=1) / cnt.clamp_min(1)[:, None].to(x.dtype)
    cnorm = (craw * craw).sum(dim=1).sqrt()
    ok = cnorm > 0
    chat = torch.where(ok[:, None], craw / torch.where(
        ok, cnorm, torch.ones_like(cnorm))[:, None], torch.zeros_like(craw))
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    diff = x - chat[:, None, :]
    d2max = torch.where(mask, (diff * diff).sum(dim=2), -inf).amax(dim=1)
    del diff
    dmin = torch.where(mask, (x * chat[:, None, :]).sum(dim=2), inf
                       ).amin(dim=1)
    radius = d2max.clamp_min(0.0).sqrt() + _DEV_META_SLACK
    cosr = (dmin.clamp(-1.0, 1.0) - _DEV_META_SLACK).clamp_min(-1.0)
    # a zero-norm centroid (cancelled rows) keeps the whole sphere
    cosr = torch.where(ok, cosr, -torch.ones_like(cosr))
    sinr = ((1.0 - cosr * cosr).clamp_min(0.0).sqrt()
            + _DEV_META_SLACK).clamp_max(1.0)
    lam_lo = torch.where(mask, glam, inf).amin(dim=1)
    lam_hi = torch.where(mask, glam, -inf).amax(dim=1)
    empty = cnt == 0
    radius = torch.where(empty, -2.0, radius)
    cosr = torch.where(empty, 1.0, cosr)
    sinr = torch.where(empty, 0.0, sinr)
    return chat, radius, cosr, sinr, lam_lo, lam_hi


def build_cells_device(data, lambdas, cap: int = 256, seed: int = 0,
                       iters: int = 8, dtype=None,
                       n_clusters: Optional[int] = None,
                       lloyd_sample: Optional[int] = None,
                       meta_chunk_units: int = 4096,
                       assume_normalised: bool = False, *, device=None,
                       stages: Optional[dict] = None) -> PrunedCells:
    """build_cells with the corpus kept on the device (pruned.py:501-629
    of the JAX package): the host sees only the C cluster counts and an
    O(U·cap) gather plan.

    1. unit-normalise with ops.search.safe_unit, the full scan's own
       normalisation (skipped with ``assume_normalised``);
    2. the Lloyd pass (seed rows and the ``lloyd_sample`` rows sorted,
       as the JAX device build draws them) and one full assign;
    3. a stable two-key sort (cluster, λ) carrying the row ids;
    4. the unit layout planned on the host from the cluster counts, then
       one gather of the grouped rows, λ and ids;
    5. bound metadata in the corpus dtype, ``meta_chunk_units`` units at
       a time (fewer at wide F), with _DEV_META_SLACK; cos θr from the
       least member dot (see the module docstring)."""
    t0 = time.perf_counter()
    dev, dt = _placement(data, device, dtype)
    x = torch.as_tensor(data).to(device=dev, dtype=dt)
    lam = torch.as_tensor(lambdas).to(device=dev, dtype=dt)
    n, f = x.shape
    cap = int(cap)
    assert cap > 0 and n > 0
    xhat = x if assume_normalised else safe_unit(x)
    del x
    n_cells = _n_cells(n, cap, n_clusters)
    rng = np.random.default_rng(seed)
    chunk = _assign_chunk_rows(n)
    if n_cells == 1:
        assign = torch.zeros(n, dtype=torch.int64, device=dev)
    else:
        seed_rows = np.sort(rng.choice(n, size=n_cells, replace=False))
        cent0 = xhat[torch.as_tensor(seed_rows, device=dev)]
        if lloyd_sample is not None and lloyd_sample < n:
            fit = np.sort(rng.choice(n, size=int(lloyd_sample),
                                     replace=False))
            cent = _lloyd(xhat[torch.as_tensor(fit, device=dev)], cent0,
                          iters=iters, block=min(chunk, int(lloyd_sample),
                                                 _LLOYD_BLOCK))
        else:
            cent = _lloyd(xhat, cent0, iters=iters,
                          block=min(chunk, _LLOYD_BLOCK))
        assign = _assign_chunked(xhat, cent, chunk)
    t_lloyd = _sync(dev)

    perm = torch.sort(lam, stable=True).indices
    perm = perm[torch.sort(assign[perm], stable=True).indices]
    counts = torch.bincount(assign, minlength=n_cells).cpu().numpy()
    del assign
    t_sort = time.perf_counter()

    # the unit layout from the C counts: cluster c's sorted rows
    # [starts[c], ends[c]) cut into cap-row units
    ends = np.cumsum(counts)
    starts = ends - counts
    n_units_per = -(-counts // cap)
    u_real = int(n_units_per.sum())
    u_pad = _unit_pad(u_real)
    base_unit = np.concatenate(([0], np.cumsum(n_units_per)))[:-1]
    c_ids = np.repeat(np.arange(n_cells), n_units_per)
    within = np.arange(u_real) - base_unit[c_ids]
    rank_start = starts[c_ids] + within * cap
    rank_end = np.minimum(rank_start + cap, ends[c_ids])
    rank = np.full((u_pad, cap), -1, dtype=np.int64)
    rk = rank_start[:, None] + np.arange(cap)[None, :]
    rank[:u_real] = np.where(rk < rank_end[:, None], rk, -1)
    rank_t = torch.from_numpy(rank.reshape(-1)).to(dev)
    valid = rank_t >= 0
    take = perm[rank_t.clamp_min(0)]
    gids = torch.where(valid, take, -1).to(torch.int32)
    gx = xhat.index_select(0, take).masked_fill_(~valid[:, None], 0.0)
    glam = lam.index_select(0, take).masked_fill_(~valid, 0.0)
    del xhat, lam, perm, rank_t, valid, take
    t_group = _sync(dev)

    ub = max(1, min(int(meta_chunk_units), _META_ELEMS // (cap * f)))
    parts = [_meta_block(gx[u0 * cap:(u0 + ub) * cap].view(-1, cap, f),
                         glam[u0 * cap:(u0 + ub) * cap].view(-1, cap),
                         gids[u0 * cap:(u0 + ub) * cap].view(-1, cap))
             for u0 in range(0, u_pad, ub)]
    cent_u, radius, cosr, sinr, lam_lo, lam_hi = (
        torch.cat(p) for p in zip(*parts))
    t_end = _sync(dev)
    if stages is not None:
        stages.update(lloyd=t_lloyd - t0, sort=t_sort - t_lloyd,
                      group=t_group - t_sort, metadata=t_end - t_group)
    logger.info("pruned cells (device build): %d rows -> %d units (cap %d, "
                "%d clusters, padded to %d) in %.2fs", n, u_real, cap,
                n_cells, u_pad, t_end - t0)
    return PrunedCells(x=gx, lam=glam, ids=gids, cent=cent_u, radius=radius,
                       cosr=cosr, sinr=sinr, lam_lo=lam_lo, lam_hi=lam_hi,
                       cap=cap, n_units=u_real)


# --------------------------------------------------------------------
# The screens
# --------------------------------------------------------------------

def _alpha_of(alpha, dt) -> Tuple[float, float]:
    """(α, c1 = 1 − α), each rounded as ``dt`` holds it."""
    a = torch.tensor(float(alpha), dtype=dt)
    return float(a), float(1.0 - a)


def _cell_bounds(qhat, qlam, cent, radius, cosr, sinr, lam_lo, lam_hi, a,
                 c1):
    """U'(q, unit) for every (query, unit) on the shifted plane (B, U);
    dummy units get -3, below every real bound (>= -α - c1 >= -1)."""
    c = dot_plane(qhat, cent)                                   # q̂·ĉ
    s = (1.0 - c * c).clamp_min(0.0).sqrt()
    cap_sup = torch.where(c >= cosr[None, :], torch.ones_like(c),
                          c * cosr[None, :] + s * sinr[None, :])
    dmin = torch.maximum(lam_lo[None, :] - qlam[:, None],
                         qlam[:, None] - lam_hi[None, :]).clamp_min(0.0)
    bounds = a * cap_sup - c1 * dmin.clamp_max(1.0)
    return torch.where(radius[None, :] < 0.0, -3.0, bounds)


def _stable_desc(values: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m largest values along the last axis, largest
    first and, among equal values, the lowest index first (lax.top_k's
    order; torch.topk leaves ties unordered)."""
    return torch.sort(values, dim=-1, descending=True, stable=True
                      ).indices[..., :m]


def _extract_topk_lowest_id(shifted: torch.Tensor, gids: torch.Tensor,
                            k: int):
    """(top-k scores, global ids) of a (B, W) score plane, ties to the
    LOWEST global id, as lax.top_k over the whole corpus orders them.
    ``gids`` is (W,) shared by every row (the union) or (B, W).  Stable
    sorts on (-score, id), one path for every k (the JAX package takes k
    masked max passes up to k = 32): for shared ids the id order is one
    sort of the columns and each row needs one sort of its scores.  A row
    with fewer than k real candidates ends in -inf scores; with fewer
    than k columns it repeats its least id, as the masked passes do."""
    b, w = shifted.shape
    if w < k:
        gid2 = gids if gids.dim() == 2 else gids[None, :].expand(b, w)
        shifted = torch.cat([shifted, shifted.new_full((b, k - w),
                                                       float("-inf"))], 1)
        gids = torch.cat([gid2, gid2.amin(dim=1, keepdim=True).expand(
            b, k - w)], 1)
    if gids.dim() == 2:
        return two_key_topk(shifted, gids, k)
    order = torch.sort(gids, stable=True).indices
    plane, ids = shifted[:, order], gids[order]
    top = torch.sort(plane, dim=1, descending=True, stable=True
                     ).indices[:, :k]
    return plane.gather(1, top), ids[top]


def _certify(top_s, next_bound, margin: float, k: int):
    """Flags: the k-th score does not beat the next bound plus the
    margin, or fewer than k real candidates were scored."""
    kth = top_s[:, k - 1]
    return (next_bound + margin >= kth) | ~torch.isfinite(kth)


def pruned_topk(queries, query_lambdas, cells_x, cells_lam, cells_ids,
                cent, radius, cosr, sinr, lam_lo, lam_hi, alpha, *,
                k: int, m_cells: int, cap: int, margin: float,
                return_next_bound: bool = False):
    """Cell-screened exact top-k, each query over its own top-``m_cells``
    units (pruned.py:632-726 of the JAX package).  Returns (scores (B, k),
    ids (B, k), flags (B,)): a flagged query is not certified and must
    be re-run through the full scan; an unflagged one equals it.  With
    ``return_next_bound`` the third output is each query's (M+1)-th bound
    on the shifted plane instead, for callers that certify against a
    k-th score merged across shards."""
    b, f = queries.shape
    u = cent.shape[0]
    m = min(m_cells, u)
    dt = queries.dtype
    a, c1 = _alpha_of(alpha, dt)
    qhat = safe_unit(queries)
    qa = qhat * a                                        # α·q̂
    bounds = _cell_bounds(qhat, query_lambdas, cent, radius, cosr, sinr,
                          lam_lo, lam_hi, a, c1)
    order = _stable_desc(bounds, m + 1)
    sel = order[:, :m]
    if m < u:
        next_bound = bounds.gather(1, order[:, m:m + 1])[:, 0]
    else:
        next_bound = torch.full((b,), float("-inf"), dtype=dt,
                                device=queries.device)

    # whole (cap, F) units: the build lays each unit out contiguously
    flat = sel.reshape(-1)
    g = cells_x.view(-1, cap, f).index_select(0, flat).view(b, m * cap, f)
    glam = cells_lam.view(-1, cap).index_select(0, flat).view(b, m * cap)
    gids = cells_ids.view(-1, cap).index_select(0, flat).view(b, m * cap)
    shifted = row_dots(qa, g) - c1 * (query_lambdas[:, None] - glam
                                      ).abs().clamp_max(1.0)
    shifted = torch.where(gids >= 0, shifted, float("-inf"))
    top_s, top_i = _extract_topk_lowest_id(shifted, gids, k)
    if return_next_bound:
        return top_s + c1, top_i, next_bound
    return top_s + c1, top_i, _certify(top_s, next_bound, margin, k)


def pruned_topk_union(queries, query_lambdas, cells_x, cells_lam,
                      cells_ids, cent, radius, cosr, sinr, lam_lo, lam_hi,
                      alpha, *, k: int, m_vote: int, s_cells: int, cap: int,
                      margin: float):
    """Two-level cell-screened exact top-k for batches past 16
    (pruned.py:764-859 of the JAX package).  Each query votes for its
    top-``m_vote`` units; the batch scores one union of ``s_cells`` units
    (most votes first, vote ties by the unit's best bound over the
    batch, then the lowest unit) with one (B, F)·(F, S·cap) product.  A
    query is certified when its k-th score beats, with the margin, the
    best bound among the units OUTSIDE the union, so a union too small
    for the batch flags, never errs.  Returns (scores, ids, flags)."""
    b, f = queries.shape
    u = cent.shape[0]
    m = min(m_vote, u)
    s_c = min(s_cells, u)
    assert k <= s_c * cap, (k, s_c, cap)
    dt = queries.dtype
    a, c1 = _alpha_of(alpha, dt)
    qhat = safe_unit(queries)
    qa = qhat * a                                        # α·q̂
    bounds = _cell_bounds(qhat, query_lambdas, cent, radius, cosr, sinr,
                          lam_lo, lam_hi, a, c1)

    voted = torch.zeros((b, u), dtype=torch.bool, device=queries.device)
    voted.scatter_(1, _stable_desc(bounds, m), True)
    votes = voted.sum(dim=0).to(dt)
    # a real bound lies in [-1, 1], so (best bound + 1) < 4 breaks vote
    # ties without crossing strata
    key = votes * 4.0 + (bounds.amax(dim=0) + 1.0)
    key = torch.where(radius < 0.0, float("-inf"), key)
    sel = _stable_desc(key, s_c)
    in_union = torch.zeros(u, dtype=torch.bool, device=queries.device
                           ).index_fill_(0, sel, True)
    next_bound = torch.where(in_union[None, :], float("-inf"), bounds
                             ).amax(dim=1)

    gx = cells_x.view(-1, cap, f).index_select(0, sel).view(-1, f)
    glam = cells_lam.view(-1, cap).index_select(0, sel).view(-1)
    gids = cells_ids.view(-1, cap).index_select(0, sel).view(-1)
    shifted = dot_plane(qa, gx) - lambda_term(query_lambdas, glam, c1)
    shifted = torch.where(gids[None, :] >= 0, shifted, float("-inf"))
    top_s, top_i = _extract_topk_lowest_id(shifted, gids, k)
    return top_s + c1, top_i, _certify(top_s, next_bound, margin, k)


# --------------------------------------------------------------------
# The session
# --------------------------------------------------------------------

def _to_host(*tensors):
    """Host copies of device tensors, waiting for the device once."""
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [t.numpy() for t in host]


class PrunedSearchSession:
    """Small-batch exact serving with cell screening
    (pruned.py:912-1175 of the JAX package).

    Built once per index (the layout copies the corpus on the device),
    then ``search(queries)`` serves blocks of at most ``batch_size``
    rows: an unflagged query costs the bound product and the gather and
    scoring of its units instead of the corpus stream; a flagged query
    re-runs through the index's exact engine
    (ArrowSpace.search_lambda_aware_batch) with the query λ the step
    computed, so every result equals the full scan.

    batch_size <= 16 runs pruned_topk (each query gathers m_cells
    units); batch_size in (16, 512] runs pruned_topk_union.  Past 512
    the JAX package measured the streaming kernels faster; use
    SearchSession.  Short batches are padded by cyclic replication of
    their queries, which keeps the union's vote order.  On CUDA the step
    (query preparation and screen, a few hundred small launches) is
    captured once as a CUDA graph and replayed for every batch, as the
    JAX package compiles it into one program (``cuda_graph=False`` runs
    it op by op; the results are bitwise the same).

    ``auto_budget=True`` doubles the screening budget (union_cells, or
    m_cells at B <= 16) when more than ``auto_flag_target`` of the last
    ``auto_window`` queries flagged, up to about N/4 gathered rows a
    batch.  It decides only once the window holds ``auto_window``
    queries (the JAX package decides on fewer).  Budgets only grow, and
    results stay exact at every size."""

    def __init__(self, index, batch_size: int = 16, k: int = 10,
                 alpha: float = 0.9, cap: int = 256,
                 m_cells: Optional[int] = None, margin: float = 1e-3,
                 seed: int = 0, iters: int = 8,
                 cells: Optional[PrunedCells] = None,
                 m_vote: int = 8, union_cells: Optional[int] = None,
                 auto_budget: bool = False,
                 auto_flag_target: float = 0.05,
                 auto_window: int = 256,
                 engine: str = "host",
                 n_clusters: Optional[int] = None,
                 lloyd_sample: Optional[int] = None,
                 cuda_graph: bool = True):
        from .index import _query_prep
        aspace, gl = index.aspace, index.gl
        if not (1 <= batch_size <= 512):
            raise ValueError("pruned sessions serve batch_size in "
                             "[1, 512]; use SearchSession for "
                             "larger batches")
        if cells is None and engine not in ("host", "device"):
            raise ValueError(f"unknown cells engine {engine!r}")
        self.batch_size = int(batch_size)
        self.k = min(int(k), index.nitems)
        self.alpha = float(alpha)
        self.margin = float(margin)
        self._index = index
        self.device, self.dtype = aspace.device, aspace.dtype
        self._dim = aspace.nfeatures
        if cells is not None:
            self.cells = cells
        else:
            build = build_cells_device if engine == "device" else build_cells
            self.cells = build(aspace.data, aspace.lambdas, cap=cap,
                               seed=seed, iters=iters, dtype=self.dtype,
                               n_clusters=n_clusters,
                               lloyd_sample=lloyd_sample)
        c = self.cells
        u = c.cent.shape[0]
        if m_cells is None:
            # ~8192 gathered rows a query, and at least k units so that
            # k real rows are certain (pruned.py:990-1000 of the JAX
            # package)
            m_cells = max(self.k, min(u, -(-8192 // c.cap)))
        self.m_cells = min(int(m_cells), u)
        if union_cells is None:
            union_cells = max(self.m_cells, -(-32768 // c.cap))
        self.union_cells = min(int(union_cells), u)
        self.m_vote = min(int(m_vote), u)
        self._prepare = _query_prep(aspace, gl)[1]

        self.auto_budget = bool(auto_budget)
        self.auto_flag_target = float(auto_flag_target)
        self.auto_window = int(auto_window)
        self.budget_growths = 0
        self._win: list = []          # (queries, flagged) per batch
        # growth stops at about N/4 gathered rows a batch, where the
        # screen nears the corpus stream's own cost
        if self.batch_size <= 16:
            self._budget_max = min(u, max(
                self.k, index.nitems // (4 * c.cap * self.batch_size)))
        else:
            self._budget_max = min(u, max(1, index.nitems // (4 * c.cap)))
        self.flagged_total = 0
        self.queries_total = 0
        # the step at the current budgets, captured once as a CUDA graph
        self.cuda_graph = bool(cuda_graph) and self.device.type == "cuda"
        self._graph = None

    def _step(self, q: torch.Tensor):
        """(scores, ids, flags, query λ) of a full batch on the device:
        query preparation, then the screen the batch size takes, at the
        current budget."""
        _, qlam = self._prepare(q)
        c = self.cells
        arrays = (c.x, c.lam, c.ids, c.cent, c.radius, c.cosr, c.sinr,
                  c.lam_lo, c.lam_hi)
        if self.batch_size <= 16:
            s, i, fl = pruned_topk(q, qlam, *arrays, self.alpha, k=self.k,
                                   m_cells=self.m_cells, cap=c.cap,
                                   margin=self.margin)
        else:
            s, i, fl = pruned_topk_union(
                q, qlam, *arrays, self.alpha, k=self.k, m_vote=self.m_vote,
                s_cells=self.union_cells, cap=c.cap, margin=self.margin)
        return s, i, fl, qlam

    def _run_step(self, q: torch.Tensor):
        """The step on a full batch, on CUDA as a replay of its graph:
        the screen is some hundred small launches, which the host would
        otherwise issue one by one.  The graph is captured on the first
        batch and again after a budget grows; its outputs are its own
        tensors, overwritten by the next replay."""
        if not self.cuda_graph:
            return self._step(q)
        key = (self.m_cells, self.union_cells)
        if self._graph is None or self._graph[0] != key:
            self._graph = None
            static_q = q.clone()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._step(static_q)           # first calls off the graph
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = self._step(static_q)
            self._graph = (key, graph, static_q, outs)
        _, graph, static_q, outs = self._graph
        static_q.copy_(q)
        graph.replay()
        return outs

    def _auto_budget_update(self, b: int, n_flagged: int) -> None:
        """Grow the screening budget when the flag rate over the last
        auto_window queries exceeds the target; the window is judged only
        once it holds auto_window queries, and it restarts after a
        growth, so one burst is judged once."""
        self._win.append((b, n_flagged))
        wq = sum(q for q, _ in self._win)
        while wq - self._win[0][0] >= self.auto_window:
            wq -= self._win.pop(0)[0]
        if wq < self.auto_window:
            return
        wf = sum(f for _, f in self._win)
        if wf / wq <= self.auto_flag_target:
            return
        union = self.batch_size > 16
        cur = self.union_cells if union else self.m_cells
        if cur >= self._budget_max:
            return
        new = min(self._budget_max, max(cur + 1, 2 * cur))
        if union:
            self.union_cells = new
        else:
            self.m_cells = new
        self.budget_growths += 1
        self._win.clear()
        logger.info("pruned auto-budget: flag rate %.2f over the last %d "
                    "queries > %.2f; %s %d -> %d (max %d)", wf / wq, wq,
                    self.auto_flag_target,
                    "union_cells" if union else "m_cells", cur, new,
                    self._budget_max)

    def warmup(self) -> None:
        """One batch of ones through the step and the fallback, so first
        calls land here; it does not feed the auto-budget window."""
        auto, self.auto_budget = self.auto_budget, False
        try:
            self.search(np.ones((self.batch_size, self._dim)))
        finally:
            self.auto_budget = auto
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def search(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """(B <= batch_size, F) queries -> host (scores (B, k), ids
        (B, k)), each row equal to the full scan's."""
        q = np.atleast_2d(np.asarray(queries, dtype=numpy_dtype(self.dtype)))
        b = q.shape[0]
        if b > self.batch_size:
            raise ValueError(
                f"pruned session batch is {self.batch_size}; got {b} "
                "(loop on the host or use SearchSession)")
        if q.shape[1] != self._dim:
            raise ValueError(f"query dim {q.shape[1]} != {self._dim}")
        if b < self.batch_size:
            q = np.resize(q, (self.batch_size, q.shape[1]))
        qt = torch.from_numpy(q).to(self.device)
        s_d, i_d, fl_d, qlam = self._run_step(qt)
        s, i, fl = _to_host(s_d[:b], i_d[:b], fl_d[:b])
        i = i.astype(np.int64)
        self.queries_total += b
        n_flagged = int(fl.sum())
        if n_flagged:
            self.flagged_total += n_flagged
            rows = np.nonzero(fl)[0]
            rt = torch.from_numpy(rows).to(self.device)
            rs, ri = self._index.aspace.search_lambda_aware_batch(
                qt[rt], qlam[rt], self.k, self.alpha)
            rs, ri = _to_host(rs, ri)
            s = s.copy()
            s[rows], i[rows] = rs, ri
        if self.auto_budget:
            self._auto_budget_update(b, n_flagged)
        return s, i

    @property
    def flag_rate(self) -> float:
        return (self.flagged_total / self.queries_total
                if self.queries_total else 0.0)
