"""Batched λ-aware search.

The reference scans all N items per query, computing
α·cos(q, x_i) + (1-α)·(1 - min(|λ_q - λ_i|, 1)) and sorting
(reference: core.rs:760-798).  Here that is one normalised product
(Q̂·X̂ᵀ) plus the λ-proximity term and an exact top-k.

Two rules hold everywhere in this package:
- exact top-k is a stable two-key sort on (-score, id), never
  ``torch.topk``, whose tie order is unspecified;
- on the CPU a score plane is computed so that bitwise-identical corpus
  rows get bitwise-identical scores (see ``dot_plane``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NEG_INF", "INT_MAX", "safe_unit", "dot_plane", "row_dots",
           "prepare_query", "shifted_lambda_plane", "two_key_topk", "exact_topk",
           "batched_lambda_aware_topk", "binned_topk_with_repair",
           "rescore_topk_f64", "hybrid_search_device_fused"]

NEG_INF = float(np.finfo(np.float32).min)
INT_MAX = int(np.iinfo(np.int32).max)

# elements of a CPU product-sum block, and query rows per sort block
_CPU_BLOCK = 1 << 24
_SORT_ELEMS = 1 << 27


def safe_unit(rows: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit norm; zero rows stay zero."""
    norms = torch.sqrt((rows * rows).sum(dim=-1, keepdim=True))
    ok = norms > 0.0
    return torch.where(ok, rows / torch.where(ok, norms,
                                              torch.ones_like(norms)),
                       torch.zeros_like(rows))


def dot_plane(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, F)·(N, F)ᵀ -> (B, N).

    On the CPU the blocked BLAS product can round bitwise-identical
    corpus rows one ulp apart (they land in different SIMD remainder
    lanes), which breaks the duplicate-row tie order the reference pins.
    There the plane is a product-sum along F, which reduces every row the
    same way.  On CUDA it is one full-float32 matmul (TF32 is off)."""
    if a.device.type != "cpu":
        return a @ b.T
    out = a.new_empty((a.shape[0], b.shape[0]))
    f = max(1, a.shape[1])
    cols = max(1, _CPU_BLOCK // f)
    rows = max(1, _CPU_BLOCK // (f * max(1, min(cols, b.shape[0]))))
    for n0 in range(0, b.shape[0], cols):
        bb = b[n0:n0 + cols]
        for b0 in range(0, a.shape[0], rows):
            out[b0:b0 + rows, n0:n0 + cols] = (
                a[b0:b0 + rows, None, :] * bb[None, :, :]).sum(dim=-1)
    return out


def row_dots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(R, C) dots of each query row of q (R, F) with its own candidate
    rows (R, C, F), by the rule of dot_plane: a product-sum on the CPU
    (every row reduced alike, so identical rows tie bitwise), one batched
    float32 product on CUDA."""
    if q.device.type == "cpu":
        return (rows * q[:, None, :]).sum(dim=-1)
    return torch.bmm(rows, q[:, :, None])[:, :, 0]


def prepare_query(queries: torch.Tensor, alpha: float, dtype=None):
    """(α·q̂ in ``dtype``, c1 = 1 - α as a Python float of that dtype).

    α rides inside the prescaled query so the product emits α·cos
    directly; scores are then SHIFTED by -c1 (see shifted_lambda_plane).
    The multiply runs in the query's dtype before the cast, as the
    JAX kernels' wrappers do.  α stays a 0-dim CPU tensor, which a CUDA
    multiply reads as a scalar: copying it to the card would synchronise
    the stream."""
    dt = dtype or queries.dtype
    a = torch.tensor(alpha, dtype=dt)
    c1 = float(1.0 - a)
    qhat = (safe_unit(queries).to(dt) * a).to(dt)
    return qhat.contiguous(), c1


def lambda_term(qlam: torch.Tensor, xlam: torch.Tensor,
                c1: float) -> torch.Tensor:
    """c1·min(|Δλ|, 1) for every (query, item) pair."""
    return c1 * (qlam[:, None] - xlam[None, :]).abs().clamp_max(1.0)


def shifted_lambda_plane(queries, query_lambdas, items, item_lambdas,
                         alpha):
    """The canonical score arithmetic, SHIFTED by -c1 = -(1-α):

        s' = (α·q̂)·x̂ᵀ - c1·min(|Δλ|, 1)      (true score = s' + c1)

    a rank-preserving reassociation of the reference expression
    α·cos + (1-α)·(1-min(|Δλ|,1)) (core.rs:135-175), and the arithmetic of
    the binned and merge kernels.  Top-k callers sort on s' and add c1
    back to the returned scores only.  Returns (plane, c1)."""
    qhat, c1 = prepare_query(queries, alpha)
    acos = dot_plane(qhat, safe_unit(items))
    return acos - lambda_term(query_lambdas, item_lambdas, c1), c1


def two_key_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of each row by (-score, id), ascending: the best score first
    and, among equal scores, the lowest id.  Two stable sorts."""
    ids_sorted, p1 = torch.sort(ids, dim=1, stable=True)
    s1 = scores.gather(1, p1)
    _, p2 = torch.sort(-s1, dim=1, stable=True)
    p2 = p2[:, :k]
    return s1.gather(1, p2), ids_sorted.gather(1, p2)


def exact_topk(plane: torch.Tensor, k: int):
    """Exact top-k of a (B, N) plane whose column index is the id: one
    stable sort of -plane keeps the lowest id first among ties."""
    _, order = torch.sort(-plane, dim=1, stable=True)
    order = order[:, :k]
    return plane.gather(1, order), order


def batched_lambda_aware_topk(queries, query_lambdas, items, item_lambdas,
                              alpha, *, k: int):
    """Plain full scan: scoring + exact top-k, (scores (B,k), ids (B,k)).
    Sorts the SHIFTED plane (what the binned kernel's flush sorts) and
    adds c1 back afterwards; query blocks bound the plane's memory."""
    n = items.shape[0]
    xhat = safe_unit(items)
    rows = max(1, _SORT_ELEMS // max(1, n))
    out_s, out_i = [], []
    c1 = 0.0
    for b0 in range(0, queries.shape[0], rows):
        qhat, c1 = prepare_query(queries[b0:b0 + rows], alpha)
        plane = dot_plane(qhat, xhat) - lambda_term(
            query_lambdas[b0:b0 + rows], item_lambdas, c1)
        s, i = exact_topk(plane, k)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s) + c1, torch.cat(out_i)


def hybrid_search_device_fused(query, query_lambda, items, item_lambdas,
                               alpha, *, k: int):
    """The hybrid search's union on the items' device (reference:
    core.rs:802-928; ops/search.py:289-324 of the JAX package): one
    effective score per item, then one exact top-k.

    The λ-aware score here is the reference expression α·cos + (1-α)·(1 -
    min(|Δλ|, 1)), cos through safe_unit, not the serving path's shifted
    score.  Precedence, as the reference's dict union: a high cosine (>
    0.9999) keeps its cosine; membership of the λ-aware top-k keeps the
    blended score; the semantic top-1 (the first maximal cosine) keeps
    its cosine; every other item scores -inf.  The λ-aware top-k holds k
    items, so k <= N rows come back valid.  Both top-k steps are the
    stable sort of exact_topk: ties to the lowest id, as lax.top_k
    orders them.  Returns (scores (k,), ids (k,)) on the items' device."""
    dt = items.dtype
    a = torch.tensor(alpha, dtype=dt)
    q = query.to(device=items.device, dtype=dt).reshape(1, -1)
    cos = dot_plane(safe_unit(q), safe_unit(items))[0]
    dl = (torch.tensor(float(query_lambda), dtype=dt) - item_lambdas).abs()
    lam_score = a * cos + (1.0 - a) * (1.0 - dl.clamp_max(1.0))
    _, top_idx = exact_topk(lam_score[None, :], k)
    n = items.shape[0]
    in_topk = torch.zeros(n, dtype=torch.bool, device=items.device)
    in_topk[top_idx[0]] = True
    is_sem = torch.arange(n, device=items.device) == cos.argmax()
    eff = torch.where(cos > 0.9999, cos,
                      torch.where(in_topk, lam_score,
                                  torch.where(is_sem, cos, float("-inf"))))
    s, i = exact_topk(eff[None, :], k)
    return s[0], i[0]


def binned_topk_with_repair(q, qlam, items, item_lambdas, alpha, *, k: int):
    """Binned streaming top-k (K1) plus exact repair of flagged rows.

    The binned kernel is exact except where more than `depth` true top-k
    elements collide in one bin; it flags those queries.  Flagged rows
    are repaired by rescoring their fired bins' rows plus their current
    top-k (ops/bin_repair), with the exact merge kernel (K3) as the
    fallback for rows with more than MAX_FIRED fired bins, so the result
    equals the full-scan top-k.  The flag check synchronises with the
    device; serving sessions overlap it with the next batch instead (both
    run ops.bin_repair.BinnedTopK)."""
    from .bin_repair import BinnedTopK
    return BinnedTopK(items, item_lambdas, alpha, k)(q, qlam)


def rescore_topk_f64(queries, query_lambdas, host_rows, item_lambdas,
                     alpha: float, cand_idx, k: int):
    """Exact float64 re-ranking of device-produced candidates against the
    original rows on the host.  Returns (scores (B, k) f64, ids (B, k))."""
    q = np.asarray(queries, dtype=np.float64)
    qlam = np.asarray(query_lambdas, dtype=np.float64)
    lam = np.asarray(item_lambdas, dtype=np.float64)
    cand = np.asarray(cand_idx)
    bsz, _m = cand.shape

    rows = np.asarray(host_rows, dtype=np.float64)[cand]     # (B, m, F)
    qn = np.linalg.norm(q, axis=1)
    rn = np.linalg.norm(rows, axis=2)
    dots = np.einsum("bf,bmf->bm", q, rows)
    denom = qn[:, None] * rn
    cos = np.where(denom > 0.0, dots / np.where(denom > 0.0, denom, 1.0),
                   0.0)
    dl = np.abs(qlam[:, None] - lam[cand])
    scores = alpha * cos + (1.0 - alpha) * (1.0 - np.minimum(dl, 1.0))

    top_scores = np.empty((bsz, k), dtype=np.float64)
    top_idx = np.empty((bsz, k), dtype=cand.dtype)
    for b in range(bsz):
        order = np.lexsort((cand[b], -scores[b]))[:k]
        top_scores[b] = scores[b][order]
        top_idx[b] = cand[b][order]
    return top_scores, top_idx
