"""Strided-bin exact repair for the binned top-k (K1).

The binned kernel maps corpus row g to bin ``g mod bins``, so one bin's
rows form a strided slice of the corpus.  A flagged query's missing
top-k candidates can only live in its FIRED bins (``det >= kth``):

* a true top-k element missing from the pool had more than ``depth``
  same-bin (same-chunk) elements scoring >= it, so its bin's det is
  >= its score >= the true kth >= the pool kth: the bin fired;
* a true top-k element in a non-fired bin is in the pool, and fewer than
  k pool elements beat it, so it is already in the current top-k.

Hence true top-k ⊆ current top-k ∪ fired bins' rows.  Both sets are
rescored with the one canonical score expression and merged with the
two-key (-score, id) sort, so the repaired rows equal a full-scan top-k.
Current top-k entries whose bin fired are dropped (the strided block
rescores them).  Rows with more than MAX_FIRED fired bins go to the
caller's fallback, the exact merge kernel (K3).

Counterpart of ``arrowspace_tpu.ops.bin_repair`` (bin_repair.py:78-431)
for a single device.
"""

from __future__ import annotations

import numpy as np
import torch

from .bintopk import binned_lambda_topk, prepare_binned_corpus
from .search import INT_MAX, NEG_INF, prepare_query, safe_unit, two_key_topk

__all__ = ["strided_lambda_repair", "repair_flagged", "fired_bins_host",
           "MAX_FIRED", "BinnedTopK"]

# Rows with more fired bins than this fall back to the full exact repair.
MAX_FIRED = 2

# Bytes of gathered candidate rows per repair chunk.
_GATHER_BUDGET = 384 * 1024 * 1024


def fired_bins_host(det_rows: np.ndarray, kth: np.ndarray):
    """Per flagged row, the fired-bin list (det >= kth, det > NEG_INF), on
    the same float values as the flush's flag reduction.  Returns
    (fired (R, MAX_FIRED) int32 padded with -1,
     ok (R,) bool — False where the row overflowed MAX_FIRED)."""
    det_rows = np.asarray(det_rows)
    kth = np.asarray(kth)
    r = det_rows.shape[0]
    fired = np.full((r, MAX_FIRED), -1, dtype=np.int32)
    ok = np.ones((r,), dtype=bool)
    hit = (det_rows >= kth[:, None]) & (det_rows > NEG_INF)
    for i in range(r):
        bins_i = np.nonzero(hit[i])[0]
        if bins_i.size > MAX_FIRED:
            ok[i] = False
        elif bins_i.size:
            fired[i, :bins_i.size] = bins_i.astype(np.int32)
    return fired, ok


def _repair_chunk(qhat, qlam, fired, out_idx, xhat, xlam, c1, n, k, bins):
    """Rescore one chunk of flagged rows: candidates are the fired bins'
    rows (g = b + j·bins < n) followed by the current top-k ids that no
    fired bin covers.  Returns shifted scores and ids of the exact
    top-k."""
    dev = xhat.device
    r, n_fired = fired.shape
    m = -(-n // bins)
    j = torch.arange(m, device=dev)
    base = fired.long()
    gidx = base.clamp_min(0)[:, :, None] + j[None, None, :] * bins
    valid_g = (base[:, :, None] >= 0) & (gidx < n)
    out_i = out_idx.long()
    in_fired = ((base[:, None, :] >= 0)
                & (out_i[:, :, None] % bins == base[:, None, :])).any(dim=2)
    earlier = torch.ones(k, k, dtype=torch.bool, device=dev).tril(-1)
    rep = ((out_i[:, :, None] == out_i[:, None, :]) & earlier).any(dim=2)
    valid_o = ~in_fired & ~rep & (out_i >= 0) & (out_i < n)
    cand = torch.cat([gidx.reshape(r, n_fired * m), out_i], dim=1)
    valid = torch.cat([valid_g.reshape(r, n_fired * m), valid_o], dim=1)
    safe = torch.where(valid, cand, torch.zeros_like(cand))
    rows = xhat[safe]                                  # (R, C, F)
    if dev.type == "cpu":                              # per-row uniform
        acos = (rows * qhat[:, None, :]).sum(dim=-1)   # rounding (dot_plane)
    else:
        acos = torch.bmm(rows, qhat[:, :, None])[:, :, 0]
    dl = (qlam[:, None] - xlam[safe]).abs().clamp_max(1.0)
    scores = acos - c1 * dl
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    ids = torch.where(valid, cand, torch.full_like(cand, INT_MAX))
    return two_key_topk(scores, ids, k)


def strided_lambda_repair(q_rows, qlam_rows, det_rows, kth, out_idx_rows,
                          items, item_lambdas, alpha, *, k: int, n: int,
                          prepared: bool, fallback=None, cur_scores=None):
    """Exact repair of flagged λ-aware queries through their fired bins.

    q_rows (R, F) raw queries and qlam_rows (R,) (tensors or arrays),
    det_rows (R, bins) and kth (R,) on the host from the flush (c1 shift
    restored), out_idx_rows (R, k) the rows' current ids.  items /
    item_lambdas are the corpus on its device: the prepared corpus
    (prepare_binned_corpus) when prepared=True, else raw rows.
    fallback(rel_rows) -> (scores, ids) serves rows whose fired-bin count
    exceeds MAX_FIRED.  cur_scores (R, k), when given, lets zero-fired
    rows pass through untouched.  Returns host (scores (R, k),
    ids (R, k) int64)."""
    strided_lambda_repair.calls += 1
    det_rows = np.asarray(det_rows)
    bins = det_rows.shape[1]
    fired, ok = fired_bins_host(det_rows, np.asarray(kth))
    r_total = det_rows.shape[0]
    dev, dt = items.device, items.dtype
    xhat = items if prepared else safe_unit(items)
    xlam = item_lambdas.to(dt)
    out_s = np.empty((r_total, k), dtype=torch.empty((), dtype=dt)
                     .numpy().dtype)
    out_i = np.empty((r_total, k), dtype=np.int64)

    zero_fired = (fired < 0).all(axis=1)
    can_pass = zero_fired & ok if cur_scores is not None \
        else np.zeros_like(ok)
    run = np.nonzero(ok & ~can_pass)[0]
    if run.size:
        run_t = torch.as_tensor(run)
        q = torch.as_tensor(q_rows)[run_t].to(dev)
        qhat, c1 = prepare_query(q, alpha, dtype=dt)
        qlam = torch.as_tensor(qlam_rows)[run_t].to(device=dev, dtype=dt)
        fired_t = torch.as_tensor(fired[run], device=dev)
        oi = torch.as_tensor(np.asarray(out_idx_rows)[run], device=dev)
        m = -(-n // bins)
        per_row = (MAX_FIRED * m + k) * xhat.shape[1] * xhat.element_size()
        r_cap = max(1, _GATHER_BUDGET // per_row)
        for lo in range(0, run.size, r_cap):
            hi = min(run.size, lo + r_cap)
            s, i = _repair_chunk(qhat[lo:hi], qlam[lo:hi], fired_t[lo:hi],
                                 oi[lo:hi], xhat, xlam, c1, n, k, bins)
            out_s[run[lo:hi]] = (s + c1).cpu().numpy()
            out_i[run[lo:hi]] = i.cpu().numpy()

    pass_rows = np.nonzero(can_pass)[0]
    if pass_rows.size:
        out_s[pass_rows] = np.asarray(cur_scores)[pass_rows]
        out_i[pass_rows] = np.asarray(out_idx_rows)[pass_rows]
    bad_rows = np.nonzero(~ok)[0]
    if bad_rows.size:
        if fallback is None:
            raise RuntimeError(
                f"{bad_rows.size} flagged rows exceed MAX_FIRED={MAX_FIRED} "
                "fired bins and no fallback repair was provided")
        s, i = fallback(bad_rows)
        out_s[bad_rows] = np.asarray(s)
        out_i[bad_rows] = np.asarray(i)
    return out_s, out_i


strided_lambda_repair.calls = 0


def repair_flagged(q_rows, qlam_rows, det_rows, scores_rows, ids_rows,
                   xhat, xlam, alpha, *, k: int, n: int):
    """Exact top-k of flagged rows on a prepared corpus
    (prepare_binned_corpus): the strided repair, with the exact merge
    kernel (K3) for rows whose fired bins overflow MAX_FIRED.

    q_rows (R, F) raw queries and qlam_rows (R,), as tensors or arrays;
    det_rows (R, bins), scores_rows and ids_rows (R, k) host arrays from
    the flush.  Returns host (scores (R, k), ids (R, k) int64)."""
    from .topk import fused_lambda_topk

    def full_merge(rel_rows):
        rel = torch.as_tensor(rel_rows)
        q = torch.as_tensor(q_rows)[rel].to(xhat.device)
        ql = torch.as_tensor(qlam_rows)[rel].to(xhat.device)
        s, i = fused_lambda_topk(q, ql, xhat, xlam, alpha, k=k,
                                 prepared=True, n_items=n)
        return s.cpu().numpy(), i.cpu().numpy()

    scores_rows = np.asarray(scores_rows)
    return strided_lambda_repair(
        q_rows, qlam_rows, det_rows, scores_rows[:, k - 1], ids_rows, xhat,
        xlam, alpha, k=k, n=n, prepared=True, fallback=full_merge,
        cur_scores=scores_rows)


class BinnedTopK:
    """The binned engine over one prepared copy of a corpus: ``step`` is
    K1 plus its flush, ``repair`` the exact repair of the flagged rows.
    A serving session calls the two apart, so that a batch's repair waits
    on the host while the next batch runs; calling the engine runs both
    for one batch."""

    def __init__(self, items, item_lambdas, alpha: float, k: int):
        self.n, self.alpha, self.k = items.shape[0], float(alpha), int(k)
        self.xhat, self.xlam = prepare_binned_corpus(items, item_lambdas)

    def step(self, q, qlam):
        """(scores (B,k), ids (B,k), flags (B,), det (B, bins)), on the
        device, of raw queries q (B, F) and their λ."""
        return binned_lambda_topk(q, qlam, self.xhat, self.xlam, self.alpha,
                                  k=self.k, prepared=True, n_items=self.n)

    def repair(self, q, qlam, det, scores, ids, flags):
        """Host (scores, ids) with every flagged row's exact top-k.  q is
        the (B, F) batch (array or tensor), qlam and det the step's device
        tensors, scores / ids / flags host arrays of the step's results."""
        rows = np.nonzero(flags)[0]
        if not rows.size:
            return scores, ids
        rt = torch.as_tensor(rows, device=det.device)
        q_rows = q[rt] if torch.is_tensor(q) else q[rows]
        scores, ids = scores.copy(), ids.copy()
        scores[rows], ids[rows] = repair_flagged(
            q_rows, qlam[rt], det[rt].cpu().numpy(), scores[rows], ids[rows],
            self.xhat, self.xlam, self.alpha, k=self.k, n=self.n)
        return scores, ids

    def __call__(self, q, qlam):
        """Exact top-k of one batch: (scores (B,k), ids (B,k)) tensors on
        the query's device.  Reading the flags waits for the device."""
        s, i, flags, det = self.step(q, qlam)
        fl = flags.cpu().numpy()
        if not fl.any():
            return s, i
        rs, ri = self.repair(q, qlam, det, s.cpu().numpy(), i.cpu().numpy(),
                             fl)
        return torch.as_tensor(rs).to(s.device), torch.as_tensor(ri).to(
            i.device)
