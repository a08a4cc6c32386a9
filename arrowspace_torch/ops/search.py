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

In bf16 serving (``precision="bf16"``) only the product's operands are
bf16: the query is normalised and α-prescaled in the scoring dtype
(float32 on CUDA, the index dtype on the CPU) and then cast
(``operand_query``), the product upcasts both operands to float32, as the
kernels accumulate bf16 products in float32, and λ, c1 and the scores
stay in the scoring dtype.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NEG_INF", "INT_MAX", "safe_unit", "dot_plane", "row_dots",
           "prepare_query", "as_operand", "operand_query",
           "shifted_lambda_plane", "two_key_topk", "exact_topk",
           "cosine_scores", "lambda_aware_scores",
           "batched_lambda_aware_topk", "masked_lambda_aware_topk",
           "binned_topk_with_repair", "pallas_binned_topk_with_repair",
           "rescore_topk_f64", "hybrid_search_device",
           "hybrid_search_device_fused"]

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


def _f32_operands(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """bf16 operands upcast to float32 (every product of two bf16 values
    is exact in float32), as the bf16 kernels' tensor cores accumulate
    them; any other pair unchanged.  A bf16 matmul would return bf16 and
    may reduce in reduced precision: not the kernels' function."""
    if torch.bfloat16 in (a.dtype, b.dtype):
        return a.float(), b.float()
    return a, b


def dot_plane(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, F)·(N, F)ᵀ -> (B, N); bf16 operands give a float32 plane.

    On the CPU the blocked BLAS product can round bitwise-identical
    corpus rows one ulp apart (they land in different SIMD remainder
    lanes), which breaks the duplicate-row tie order the reference pins.
    There the plane is a product-sum along F, which reduces every row the
    same way.  On CUDA it is one full-float32 matmul (TF32 is off)."""
    a, b = _f32_operands(a, b)
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
    float32 product on CUDA; bf16 operands are upcast to float32 first."""
    q, rows = _f32_operands(q, rows)
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


def as_operand(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """rows cast to like's dtype and zero-padded to its width, as the
    kernels read a prepared corpus ``like`` (a bf16 corpus pads F to
    whole 16-byte rows; zeros add nothing to a dot product)."""
    out = rows.to(like.dtype)
    pad = like.shape[-1] - out.shape[-1]
    return torch.nn.functional.pad(out, (0, pad)) if pad else out


def operand_query(queries: torch.Tensor, alpha: float, dtype,
                  corpus: torch.Tensor):
    """(the kernels' query operand, c1) for a prepared corpus
    (ops.bintopk.prepare_binned_corpus): α·q̂ prescaled in the scoring
    dtype ``dtype`` by prepare_query, then as_operand.  c1 is a Python
    float of the scoring dtype, never of bf16."""
    qhat, c1 = prepare_query(queries, alpha, dtype=dtype)
    return as_operand(qhat, corpus).contiguous(), c1


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


def cosine_scores(queries: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """(B, F) x (N, F) -> (B, N) cosine similarity through safe_unit:
    zero rows score 0 (reference: core.rs:229-239)."""
    return dot_plane(safe_unit(queries), safe_unit(items))


def lambda_aware_scores(queries, query_lambdas, items, item_lambdas,
                        alpha) -> torch.Tensor:
    """(B, N) scores α·cos + (1-α)·(1 - min(|Δλ|, 1)) (core.rs:135-175),
    by the arithmetic of shifted_lambda_plane with c1 added back."""
    plane, c1 = shifted_lambda_plane(queries, query_lambdas, items,
                                     item_lambdas, alpha)
    return plane + c1


def _scan_topk(queries, query_lambdas, items, item_lambdas, alpha, k: int,
               n_live=None):
    """Exact top-k of the SHIFTED plane in query blocks that bound the
    plane's memory, columns at or past ``n_live`` masked to -inf; c1 is
    added back afterwards (-inf stays -inf)."""
    n = items.shape[0]
    xhat = safe_unit(items)
    dead = None
    if n_live is not None:
        dead = torch.arange(n, device=items.device) >= int(n_live)
    rows = max(1, _SORT_ELEMS // max(1, n))
    out_s, out_i = [], []
    c1 = 0.0
    for b0 in range(0, queries.shape[0], rows):
        qhat, c1 = prepare_query(queries[b0:b0 + rows], alpha)
        plane = dot_plane(qhat, xhat) - lambda_term(
            query_lambdas[b0:b0 + rows], item_lambdas, c1)
        if dead is not None:
            plane = plane.masked_fill(dead[None, :], float("-inf"))
        s, i = exact_topk(plane, k)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s) + c1, torch.cat(out_i)


def batched_lambda_aware_topk(queries, query_lambdas, items, item_lambdas,
                              alpha, *, k: int):
    """Plain full scan: scoring + exact top-k, (scores (B,k), ids (B,k)).
    Sorts the SHIFTED plane (what the binned kernel's flush sorts) and
    adds c1 back afterwards; query blocks bound the plane's memory."""
    return _scan_topk(queries, query_lambdas, items, item_lambdas, alpha, k)


def masked_lambda_aware_topk(queries, query_lambdas, items, item_lambdas,
                             alpha, n_live, *, k: int):
    """λ-aware top-k of a capacity buffer of which only the first
    ``n_live`` rows are live (ops/search.py:203-236 of the JAX package):
    the plain scan with rows at or past n_live masked to -inf before the
    stable sort, so stale rows (NaN included) never rank and ties go to
    the lowest id.  Slots past n_live come back with score -inf."""
    return _scan_topk(queries, query_lambdas, items, item_lambdas, alpha, k,
                      n_live=n_live)


def _hybrid_planes(query, query_lambda, items, item_lambdas, alpha):
    """(cos (N,), λ-aware score (N,)) of one query: the reference
    expression α·cos + (1-α)·(1 - min(|Δλ|, 1)), cos through safe_unit,
    not the serving path's shifted score."""
    dt = items.dtype
    a = torch.tensor(alpha, dtype=dt)
    q = query.to(device=items.device, dtype=dt).reshape(1, -1)
    cos = cosine_scores(q, items)[0]
    dl = (torch.tensor(float(query_lambda), dtype=dt) - item_lambdas).abs()
    return cos, a * cos + (1.0 - a) * (1.0 - dl.clamp_max(1.0))


def hybrid_search_device(query, query_lambda, items, item_lambdas, alpha,
                         *, k: int):
    """The hybrid search's components on the items' device (reference:
    core.rs:802-928; ops/search.py:239-263 of the JAX package): (the
    λ-aware top-k's scores (k,) and ids (k,), the semantic top-1 (the
    first maximal cosine) as a 0-dim tensor, the cosines (N,), and the
    high-cosine mask cos > 0.9999 (N,)).  The top-k is exact_topk's
    stable sort: ties to the lowest id, as lax.top_k orders them."""
    cos, lam_score = _hybrid_planes(query, query_lambda, items,
                                    item_lambdas, alpha)
    top_s, top_i = exact_topk(lam_score[None, :], k)
    return top_s[0], top_i[0], cos.argmax(), cos, cos > 0.9999


def hybrid_search_device_fused(query, query_lambda, items, item_lambdas,
                               alpha, *, k: int):
    """The hybrid search's union on the items' device (reference:
    core.rs:802-928; ops/search.py:289-324 of the JAX package): one
    effective score per item, then one exact top-k.

    Precedence, as the reference's dict union: a high cosine (> 0.9999)
    keeps its cosine; membership of the λ-aware top-k keeps the blended
    score (_hybrid_planes); the semantic top-1 (the first maximal
    cosine) keeps its cosine; every other item scores -inf.  The
    λ-aware top-k holds k items, so k <= N rows come back valid.  Both
    top-k steps are the stable sort of exact_topk: ties to the lowest
    id, as lax.top_k orders them.  Returns (scores (k,), ids (k,)) on
    the items' device."""
    cos, lam_score = _hybrid_planes(query, query_lambda, items,
                                    item_lambdas, alpha)
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


def binned_topk_with_repair(q, qlam, items, item_lambdas, alpha, *, k: int,
                            use_bf16: bool = False):
    """Binned streaming top-k (K1) plus exact repair of flagged rows.

    The binned kernel is exact except where more than `depth` true top-k
    elements collide in one bin; it flags those queries.  Flagged rows
    are repaired by rescoring their fired bins' rows plus their current
    top-k (ops/bin_repair), with the exact merge kernel (K3) as the
    fallback for rows with more than MAX_FIRED fired bins, so the result
    equals the full-scan top-k.  The flag check synchronises with the
    device; serving sessions overlap it with the next batch instead (both
    run ops.bin_repair.BinnedTopK).  ``use_bf16`` runs K1, the repair and
    K3 on bf16 operands."""
    from .bin_repair import BinnedTopK
    return BinnedTopK(items, item_lambdas, alpha, k,
                      use_bf16=use_bf16)(q, qlam)


def pallas_binned_topk_with_repair(q, qlam, items, item_lambdas, alpha,
                                   k: int, use_bf16: bool = False):
    """The JAX package's name of binned_topk_with_repair
    (ops/search.py:24-78 there): K1 with the exact repair of its flagged
    rows, (scores (B,k), ids (B,k)) tensors on the query's device."""
    return binned_topk_with_repair(q, qlam, items, item_lambdas, alpha, k=k,
                                   use_bf16=use_bf16)


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
