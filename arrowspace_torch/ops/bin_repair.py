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

On a bf16 prepared corpus (``use_bf16``) the rescore multiplies the
same bf16 operands as K1's bf16 mode, the query prescaled in float32
(the scoring dtype) before its cast, in float32 (row_dots), and the
overflow fallback is K3's bf16 mode, as the JAX session's is.

The energy kernels (K6, and K7's exact fallback) keep the same bins and
det, so ``strided_energy_repair`` is the same argument with the energy
score.  Counterpart of ``arrowspace_tpu.ops.bin_repair``
(bin_repair.py:78-492) for a single device.

Every host read or upload of a repair that waits on the device's stream
is the utils.profiling span ``repair.sync``; the row triage counts
``rows_passed`` (no bin fired), ``rows_rescored``, ``rows_fallback``
(over MAX_FIRED) and ``repair_chunks`` into the active record.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import numpy_dtype
from ..utils.profiling import count, span
from .bintopk import (binned_lambda_topk, operand_width,
                      prepare_binned_corpus, prepared_rows, scoring_dtype)
from .energy_approx import (binned_energy_topk_approx,
                            prepare_energy_chord_sample)
from .energy_bintopk import (binned_energy_topk, dtype_scalar, energy_u,
                             energy_topk_chunked,
                             prepare_binned_energy_corpus)
from .search import INT_MAX, NEG_INF, operand_query, row_dots, two_key_topk

__all__ = ["strided_lambda_repair", "strided_energy_repair",
           "repair_flagged", "fired_bins_host", "MAX_FIRED", "BinnedTopK",
           "BinnedEnergyTopK"]

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


def _candidates(fired, out_idx, n, k, bins, shard_n=0):
    """Candidate ids of one repair chunk: the fired bins' rows followed
    by the current top-k ids that no fired bin covers (and no earlier
    slot repeats).  Single-chip (``shard_n`` 0 or n) column b is bin b,
    whose rows are g = b + j·bins < n.  A mesh det plane (per-shard det
    planes gathered along the columns, shards of ``shard_n`` rows) has
    column c = s·bins + b for local bin b of shard s, whose rows are
    g = s·shard_n + b + j·bins < min((s+1)·shard_n, n) (bin_repair.py:
    299-310 of the JAX package).  Returns (cand (R, C), valid (R, C),
    safe (R, C): cand with invalid slots at row 0)."""
    dev = out_idx.device
    r, n_fired = fired.shape
    if not shard_n or shard_n >= n:
        shard_n = n
    m = -(-shard_n // bins)
    j = torch.arange(m, device=dev)
    col = fired.long()
    c0 = col.clamp_min(0)
    shard = c0 // bins
    base = shard * shard_n + c0 % bins
    limit = ((shard + 1) * shard_n).clamp_max(n)
    gidx = base[:, :, None] + j[None, None, :] * bins
    valid_g = (col[:, :, None] >= 0) & (gidx < limit[:, :, None])
    out_i = out_idx.long()
    out_col = (out_i // shard_n) * bins + (out_i % shard_n) % bins
    in_fired = ((col[:, None, :] >= 0)
                & (out_col[:, :, None] == col[:, None, :])).any(dim=2)
    earlier = torch.ones(k, k, dtype=torch.bool, device=dev).tril(-1)
    rep = ((out_i[:, :, None] == out_i[:, None, :]) & earlier).any(dim=2)
    valid_o = ~in_fired & ~rep & (out_i >= 0) & (out_i < n)
    cand = torch.cat([gidx.reshape(r, n_fired * m), out_i], dim=1)
    valid = torch.cat([valid_g.reshape(r, n_fired * m), valid_o], dim=1)
    return cand, valid, torch.where(valid, cand, torch.zeros_like(cand))


def _rows_at(parts, idx, shard_n: int):
    """parts[idx]: rows of one corpus tensor, or of a mesh's shards (a
    list; global row g lies in shard g // shard_n at g % shard_n), each
    gathered from the shard that holds it onto the first shard's
    device."""
    if torch.is_tensor(parts):
        return parts[idx]
    dev = parts[0].device
    shard, loc = idx // shard_n, idx % shard_n
    out = parts[0].new_empty(tuple(idx.shape) + tuple(parts[0].shape[1:]))
    for s, p in enumerate(parts):
        sel = shard == s
        out[sel] = p[loc[sel].to(p.device)].to(dev)
    return out


def _merge(scores, cand, valid, k):
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    ids = torch.where(valid, cand, torch.full_like(cand, INT_MAX))
    return two_key_topk(scores, ids, k)


def _repair_chunk(qhat, qlam, fired, out_idx, xhat, xlam, c1, n, k, bins,
                  shard_n=0, like=None):
    """Rescore one chunk of flagged λ-aware rows over their candidates
    (bf16 operands multiplied in float32).  With ``like`` the corpus is
    raw and each gathered row is prepared as a prepared corpus ``like``
    holds it (prepared_rows: safe_unit row by row, then the cast), so it
    scores bitwise as its prepared row would.  Returns shifted scores
    and ids of the exact top-k."""
    cand, valid, safe = _candidates(fired, out_idx, n, k, bins, shard_n)
    rows = _rows_at(xhat, safe, shard_n)
    if like is not None:
        rows = prepared_rows(rows, like)
    acos = row_dots(qhat, rows)
    dl = (qlam[:, None] - _rows_at(xlam, safe, shard_n)).abs().clamp_max(1.0)
    return _merge(acos - c1 * dl, cand, valid, k)


def _energy_repair_chunk(zq, qlam, fired, out_idx, zx, xlam, xn, wl, wd, n,
                         k, bins, shard_n=0):
    """Rescore one chunk of flagged energy rows over their candidates
    with K6's shifted score (bin_repair.py:245-274 of the JAX package).
    Returns shifted scores and ids of the exact top-k."""
    cand, valid, safe = _candidates(fired, out_idx, n, k, bins, shard_n)
    qn = (zq * zq).sum(dim=1)
    d2 = (qn[:, None] + _rows_at(xn, safe, shard_n)) \
        - 2.0 * row_dots(zq, _rows_at(zx, safe, shard_n))
    scores = energy_u(d2, wd) - wl * (
        qlam[:, None] - _rows_at(xlam, safe, shard_n)).abs()
    return _merge(scores, cand, valid, k)


def _strided_repair(det_rows, kth, out_idx_rows, cur_scores, fallback,
                    np_dtype, k, rescore, per_row_bytes):
    """The repair's row triage, shared by the λ-aware and energy repairs:
    rows whose fired-bin count overflows MAX_FIRED go to ``fallback``,
    zero-fired rows with ``cur_scores`` pass through untouched, and the
    rest are rescored by ``rescore(run_rows, fired)`` in chunks that keep
    the gathered candidates within _GATHER_BUDGET.  Returns host
    (scores (R, k), ids (R, k) int64)."""
    det_rows = np.asarray(det_rows)
    fired, ok = fired_bins_host(det_rows, np.asarray(kth))
    r_total = det_rows.shape[0]
    out_s = np.empty((r_total, k), dtype=np_dtype)
    out_i = np.empty((r_total, k), dtype=np.int64)
    zero_fired = (fired < 0).all(axis=1)
    can_pass = zero_fired & ok if cur_scores is not None \
        else np.zeros_like(ok)
    run = np.nonzero(ok & ~can_pass)[0]
    r_cap = max(1, _GATHER_BUDGET // per_row_bytes)
    for lo in range(0, run.size, r_cap):
        rows = run[lo:lo + r_cap]
        s, i = rescore(rows, fired[rows])
        with span("repair.sync"):
            out_s[rows] = s.cpu().numpy()
            out_i[rows] = i.cpu().numpy()
    pass_rows = np.nonzero(can_pass)[0]
    bad_rows = np.nonzero(~ok)[0]
    count("rows_passed", int(pass_rows.size))
    count("rows_rescored", int(run.size))
    count("rows_fallback", int(bad_rows.size))
    count("repair_chunks", -(-int(run.size) // r_cap))
    if pass_rows.size:
        out_s[pass_rows] = np.asarray(cur_scores)[pass_rows]
        out_i[pass_rows] = np.asarray(out_idx_rows)[pass_rows]
    if bad_rows.size:
        if fallback is None:
            raise RuntimeError(
                f"{bad_rows.size} flagged rows exceed MAX_FIRED={MAX_FIRED} "
                "fired bins and no fallback repair was provided")
        s, i = fallback(bad_rows)
        out_s[bad_rows] = np.asarray(s)
        out_i[bad_rows] = np.asarray(i)
    return out_s, out_i


def strided_lambda_repair(q_rows, qlam_rows, det_rows, kth, out_idx_rows,
                          items, item_lambdas, alpha, *, k: int, n: int,
                          prepared: bool, fallback=None, cur_scores=None,
                          shard_n: int = 0, use_bf16: bool = False):
    """Exact repair of flagged λ-aware queries through their fired bins.

    q_rows (R, F) raw queries and qlam_rows (R,) (tensors or arrays),
    det_rows (R, bins) and kth (R,) on the host from the flush (c1 shift
    restored), out_idx_rows (R, k) the rows' current ids.  items /
    item_lambdas are the corpus on its device: the prepared corpus
    (prepare_binned_corpus, bf16 when it was prepared so) when
    prepared=True, else raw rows, each gathered row prepared as
    prepare_binned_corpus would hold it (bf16 with ``use_bf16``), so the
    rescore equals the prepared one bitwise with no corpus-sized copy.
    Scores are in the scoring dtype: the prepared λ's, or
    bintopk.scoring_dtype of the raw rows.
    fallback(rel_rows) -> (scores, ids) serves rows whose fired-bin count
    exceeds MAX_FIRED.  cur_scores (R, k), when given, lets zero-fired
    rows pass through untouched.

    ``shard_n`` > 0 (and < n) marks a mesh det plane: the per-shard det
    planes of shards of shard_n rows gathered along the columns, and
    items / item_lambdas the lists of this mesh's shards (each prepared
    or raw as ``prepared`` says); the rescore gathers each candidate row
    from the shard that holds it.  A true top-k row missing from the
    merged result was dropped by its own shard's pool, so its shard's
    det >= its score >= the merged kth: its column fired.  Returns host
    (scores (R, k), ids (R, k) int64)."""
    strided_lambda_repair.calls += 1
    bins = np.shape(det_rows)[1]
    mesh = isinstance(items, (list, tuple))
    parts = list(items) if mesh else [items]
    lams = list(item_lambdas) if mesh else [item_lambdas]
    # the scoring dtype: the prepared λ's, else the one a prepared copy
    # of the raw rows would have; raw rows are prepared as gathered
    dt = lams[0].dtype if prepared else scoring_dtype(parts[0])
    like = None
    if not prepared:
        op_dt = torch.bfloat16 if use_bf16 else dt
        like = parts[0].new_empty(
            (0, operand_width(parts[0].shape[1], op_dt)), dtype=op_dt)
    lams = [lam.to(dt) for lam in lams]
    if mesh:
        assert shard_n and bins % (-(-n // shard_n)) == 0, (
            np.shape(det_rows), n, shard_n)
        bins //= -(-n // shard_n)
        xhat, xlam = parts, lams
    else:
        shard_n = 0
        xhat, xlam = parts[0], lams[0]
    first = parts[0] if like is None else like
    dev = parts[0].device
    oi_all = np.asarray(out_idx_rows)

    def rescore(rows, fired):
        rt = torch.as_tensor(rows)
        with span("repair.sync"):
            q = torch.as_tensor(q_rows)[rt].to(dev)
            qlam = torch.as_tensor(qlam_rows)[rt].to(device=dev, dtype=dt)
            fired = torch.as_tensor(fired, device=dev)
            out_idx = torch.as_tensor(oi_all[rows], device=dev)
        qhat, c1 = operand_query(q, alpha, dt, first)
        s, i = _repair_chunk(qhat, qlam, fired, out_idx, xhat, xlam, c1, n,
                             k, bins, shard_n, like)
        return s + c1, i

    per_row = (MAX_FIRED * -(-(shard_n or n) // bins) + k) * \
        first.shape[1] * max(parts[0].element_size(), first.element_size())
    return _strided_repair(det_rows, kth, out_idx_rows, cur_scores,
                           fallback, numpy_dtype(dt), k, rescore, per_row)


strided_lambda_repair.calls = 0


def strided_energy_repair(zq_rows, qlam_rows, det_rows, kth, out_idx_rows,
                          zx, xlam, xn, wl: float, wd: float, *, k: int,
                          n: int, fallback=None, cur_scores=None,
                          shard_n: int = 0):
    """Exact repair of flagged energy queries through their fired bins
    (bin_repair.py:434-492 of the JAX package), over a prepared corpus
    (ops/energy_bintopk.prepare_binned_energy_corpus).  zq_rows (R, G)
    are the flagged queries in z-space; the rest as in
    strided_lambda_repair, with scores on the true scale.  ``shard_n`` >
    0 (and < n) marks a mesh det plane, with zx, xlam and xn the lists of
    the mesh's prepared shards, as in strided_lambda_repair.  Returns
    host (scores (R, k), ids (R, k) int64)."""
    strided_energy_repair.calls += 1
    bins = np.shape(det_rows)[1]
    if isinstance(zx, (list, tuple)):
        assert shard_n and bins % (-(-n // shard_n)) == 0, (
            np.shape(det_rows), n, shard_n)
        bins //= -(-n // shard_n)
        first = zx[0]
    else:
        shard_n = 0
        first = zx
    dev, dt = first.device, first.dtype
    oi_all = np.asarray(out_idx_rows)

    def rescore(rows, fired):
        rt = torch.as_tensor(rows)
        with span("repair.sync"):
            zq = torch.as_tensor(zq_rows)[rt].to(device=dev, dtype=dt)
            qlam = torch.as_tensor(qlam_rows)[rt].to(device=dev, dtype=dt)
            fired = torch.as_tensor(fired, device=dev)
            out_idx = torch.as_tensor(oi_all[rows], device=dev)
        s, i = _energy_repair_chunk(zq, qlam, fired, out_idx, zx, xlam, xn,
                                    wl, wd, n, k, bins, shard_n)
        return s - wd, i

    per_row = (MAX_FIRED * -(-(shard_n or n) // bins) + k) * first.shape[1] \
        * first.element_size()
    return _strided_repair(det_rows, kth, out_idx_rows, cur_scores,
                           fallback, numpy_dtype(dt), k, rescore, per_row)


strided_energy_repair.calls = 0


def repair_flagged(q_rows, qlam_rows, det_rows, scores_rows, ids_rows,
                   xhat, xlam, alpha, *, k: int, n: int, prepared: bool = True,
                   use_bf16: bool = False):
    """Exact top-k of flagged rows: the strided repair, with the exact
    merge kernel (K3) for rows whose fired bins overflow MAX_FIRED.
    xhat / xlam are a prepared corpus (prepare_binned_corpus; on a bf16
    corpus both run in bf16) or, with ``prepared=False``, the raw corpus,
    which both prepare as they read it (bf16 with ``use_bf16``).

    q_rows (R, F) raw queries and qlam_rows (R,), as tensors or arrays;
    det_rows (R, bins), scores_rows and ids_rows (R, k) host arrays from
    the flush.  Returns host (scores (R, k), ids (R, k) int64)."""
    from .topk import fused_lambda_topk

    def full_merge(rel_rows):
        rel = torch.as_tensor(rel_rows)
        with span("repair.sync"):
            q = torch.as_tensor(q_rows)[rel].to(xhat.device)
            ql = torch.as_tensor(qlam_rows)[rel].to(xhat.device)
        s, i = fused_lambda_topk(q, ql, xhat, xlam, alpha, k=k,
                                 prepared=prepared, n_items=n,
                                 use_bf16=use_bf16)
        with span("repair.sync"):
            return s.cpu().numpy(), i.cpu().numpy()

    scores_rows = np.asarray(scores_rows)
    return strided_lambda_repair(
        q_rows, qlam_rows, det_rows, scores_rows[:, k - 1], ids_rows, xhat,
        xlam, alpha, k=k, n=n, prepared=prepared, fallback=full_merge,
        cur_scores=scores_rows, use_bf16=use_bf16)


class BinnedTopK:
    """The binned engine over a corpus: ``step`` is K1 plus its flush,
    ``repair`` the exact repair of the flagged rows.  A serving session
    calls the two apart, so that a batch's repair waits on the host
    while the next batch runs; calling the engine runs both for one
    batch.

    ``prepared=True`` takes the buffers of prepare_binned_corpus as they
    are, of which the first ``n`` rows are served: a live session's
    capacity buffers, whose owner writes rows in place and sets ``n``
    (K1, the strided repair and K3 read it as their row count and never
    score a row at or past it).  Otherwise the corpus is prepared here
    once, in bf16 with ``use_bf16``; a bf16 prepared corpus serves K1,
    the repair and K3 in bf16.  With ``prepare_corpus=False`` the engine
    keeps the raw corpus only: each step prepares a transient copy that
    is dropped once K1 is enqueued (the caching allocator hands its block
    to the next step on the same stream), and the repair prepares the
    rows it gathers.  Results equal the resident engine's bitwise: the
    same kernels on the same prepared operands.

    ``flagged_rows`` counts the rows ``repair`` has re-run, as
    BinnedEnergyTopK's does."""

    def __init__(self, items, item_lambdas, alpha: float, k: int, *,
                 prepared: bool = False, n: int = 0, use_bf16: bool = False,
                 prepare_corpus: bool = True):
        self.alpha, self.k = float(alpha), int(k)
        self.use_bf16 = use_bf16
        self.prepared = prepared or prepare_corpus
        if prepared:
            self.n, self.xhat, self.xlam = int(n), items, item_lambdas
        elif prepare_corpus:
            self.n = items.shape[0]
            self.xhat, self.xlam = prepare_binned_corpus(
                items, item_lambdas, use_bf16=use_bf16)
        else:
            self.n, self.xhat, self.xlam = items.shape[0], items, item_lambdas
        self.flagged_rows = 0

    def step(self, q, qlam):
        """(scores (B,k), ids (B,k), flags (B,), det (B, bins)), on the
        device, of raw queries q (B, F) and their λ."""
        return binned_lambda_topk(q, qlam, self.xhat, self.xlam, self.alpha,
                                  k=self.k, prepared=self.prepared,
                                  n_items=self.n, use_bf16=self.use_bf16)

    def repair(self, q, qlam, det, scores, ids, flags):
        """Host (scores, ids) with every flagged row's exact top-k.  q is
        the (B, F) batch (array or tensor), qlam and det the step's device
        tensors, scores / ids / flags host arrays of the step's results."""
        rows = np.nonzero(flags)[0]
        if not rows.size:
            return scores, ids
        self.flagged_rows += rows.size
        with span("repair.sync"):
            rt = torch.as_tensor(rows, device=det.device)
            det_rows = det[rt].cpu().numpy()
        q_rows = q[rt] if torch.is_tensor(q) else q[rows]
        scores, ids = scores.copy(), ids.copy()
        scores[rows], ids[rows] = repair_flagged(
            q_rows, qlam[rt], det_rows, scores[rows], ids[rows],
            self.xhat, self.xlam, self.alpha, k=self.k, n=self.n,
            prepared=self.prepared, use_bf16=self.use_bf16)
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


class BinnedEnergyTopK:
    """The binned energy engine over a z-plane: ``step`` is K6 plus its
    flush (or, with ``approx``, K7 plus its rescore and certification),
    ``repair`` the exact repair of the flagged rows.  Shared by
    EnergySearchSession and energymaps.search_energy_batch, as BinnedTopK
    is by the cosine path.

    ``project`` maps the rows handed to ``repair`` to z-space (the
    session hands it raw query rows); None when they already are z.
    ``flagged_rows`` counts the rows ``repair`` has re-run: K6's
    deep-collision rows, or with ``approx`` K7's uncertified rows.

    The engine serves the z-plane centred on its mean (``centre``), and
    centres every query it is handed: distances are unchanged, and d² =
    (|q|² + |x|²) - 2·q·x, which cancels for near neighbours, rounds
    about ten times less on the serving plane (|z - centre|² ≈ 4 against
    |z|² ≈ 40), in the kernels and their plain versions alike.

    The prepared (centred, padded) plane is made once here, or with
    ``prepare_corpus=False`` by every step and repair that reads it and
    dropped once its kernels are enqueued: the engine then holds no
    corpus-sized tensor of its own, and its results equal the resident
    engine's bitwise (the same arithmetic on the same operands).  K7's
    sample is drawn from the resident plane, so ``approx`` needs it."""

    # flagged rows re-run through K6 in blocks of this many rows
    FALLBACK_BLOCK = 128

    def __init__(self, z_items, item_lambdas, w_lambda: float,
                 w_dirichlet: float, k: int, *, approx: bool = False,
                 project=None, rows: int = 0, prepare_corpus: bool = True):
        if approx and not prepare_corpus:
            raise ValueError("approx=True needs the resident prepared "
                             "z-plane (prepare_corpus=True)")
        self.n, self.k, self.approx = z_items.shape[0], int(k), approx
        self._mean = z_items.mean(dim=0)
        self._raw = (z_items, item_lambdas, rows)
        self.zx = self.xlam = self.xn = None
        if prepare_corpus:
            self.zx, self.xlam, self.xn = self._prepare()
            self._raw = None
        self.dtype = scoring_dtype(z_items)
        self.device = z_items.device
        self.centre = self._mean.to(self.dtype)
        self.wl = dtype_scalar(w_lambda, self.dtype)
        self.wd = dtype_scalar(w_dirichlet, self.dtype)
        self.project = project
        self.flagged_rows = 0
        if approx:
            self.z_samp, self.xn_samp = prepare_energy_chord_sample(
                self.zx, self.xn, self.n)

    def _prepare(self):
        z_items, item_lambdas, rows = self._raw
        return prepare_binned_energy_corpus(z_items - self._mean,
                                            item_lambdas, rows=rows)

    def corpus(self):
        """(zx, xlam, xn) of the prepared plane: the resident one, or a
        transient one made now."""
        if self.zx is None:
            return self._prepare()
        return self.zx, self.xlam, self.xn

    def centred(self, z_q):
        """Queries in z-space, in the prepared corpus's dtype, centred as
        the corpus is."""
        return z_q.to(self.dtype) - self.centre

    def write_rows(self, pos: torch.Tensor, z_rows, lam_rows) -> None:
        """Write corpus rows ``pos`` of a capacity buffer (``rows`` at
        construction) in place: z_rows (m, G) in z-space, centred on the
        centre fixed at construction by the arithmetic of the prepared
        rows, with their squared norms and λ.  The centre is never moved,
        so the distances of the other rows stay as they were."""
        zc = (z_rows - self._mean.to(z_rows.dtype)).to(self.dtype)
        self.zx.index_copy_(0, pos, zc)
        self.xn.index_copy_(0, pos, (zc * zc).sum(dim=1))
        self.xlam.index_copy_(0, pos, lam_rows.to(self.xlam.dtype))

    def step(self, z_q, qlam):
        """(scores (B,k), ids (B,k), flags (B,), det (B, bins) or None),
        on the device, of queries z_q (B, G) in z-space and their λ.
        With ``approx`` the flags mark uncertified rows and det is None."""
        z_q = self.centred(z_q)
        if self.approx:
            s, i, flags = binned_energy_topk_approx(
                z_q, qlam, self.zx, self.xlam, self.xn, self.z_samp,
                self.xn_samp, self.wl, self.wd, k=self.k, n=self.n)
            return s, i, flags, None
        zx, xlam, xn = self.corpus()
        return binned_energy_topk(z_q, qlam, zx, xlam, xn, self.wl, self.wd,
                                  k=self.k, n=self.n)

    def chunked(self, z_rows, qlam_rows, corpus=None):
        """Host exact top-k of centred rows by the plain chunked scan."""
        zx, xlam, _xn = corpus or self.corpus()
        s, i = energy_topk_chunked(z_rows, qlam_rows, zx[:self.n],
                                   xlam[:self.n], self.wl, self.wd, k=self.k)
        with span("repair.sync"):
            return s.cpu().numpy(), i.cpu().numpy()

    def exact_rows(self, z_rows, qlam_rows):
        """Host exact top-k of centred rows through K6 on blocks of
        FALLBACK_BLOCK rows (zero rows pad the last block), with the
        chunked scan for the rows K6 flags (index.py:635-659 of the JAX
        package): the fallback of K7's uncertified rows."""
        m = z_rows.shape[0]
        pad = (-m) % self.FALLBACK_BLOCK
        zs = torch.nn.functional.pad(z_rows, (0, 0, 0, pad))
        qls = torch.nn.functional.pad(qlam_rows, (0, pad))
        s, i, fl, _det = binned_energy_topk(
            zs, qls, self.zx, self.xlam, self.xn, self.wl, self.wd,
            k=self.k, n=self.n)
        with span("repair.sync"):
            s, i = s[:m].cpu().numpy(), i[:m].cpu().numpy()
            bad = np.nonzero(fl[:m].cpu().numpy())[0]
        if bad.size:
            bt = torch.as_tensor(bad, device=z_rows.device)
            s[bad], i[bad] = self.chunked(z_rows[bt], qlam_rows[bt])
        return s, i

    def repair(self, q, qlam, det, scores, ids, flags):
        """Host (scores, ids) with every flagged row's exact top-k.  q is
        the (B, ·) batch (array or tensor) that ``project`` maps to
        z-space, qlam and det the step's device tensors, scores / ids /
        flags host arrays of the step's results."""
        rows = np.nonzero(flags)[0]
        if not rows.size:
            return scores, ids
        self.flagged_rows += rows.size
        dev, dt = self.device, self.dtype
        with span("repair.sync"):
            rt = torch.as_tensor(rows, device=dev)
            q_rows = (q[rt.to(q.device)] if torch.is_tensor(q)
                      else torch.as_tensor(q[rows])).to(device=dev, dtype=dt)
        z = self.centred(q_rows if self.project is None
                         else self.project(q_rows))
        ql = qlam[rt].to(dt)
        scores, ids = scores.copy(), ids.copy()
        if self.approx:
            scores[rows], ids[rows] = self.exact_rows(z, ql)
            return scores, ids
        corpus = self.corpus()
        zx, xlam, xn = corpus

        def fallback(rel_rows):
            rel = torch.as_tensor(rel_rows, device=z.device)
            return self.chunked(z[rel], ql[rel], corpus)

        with span("repair.sync"):
            det_rows = det[rt].cpu().numpy()
        scores[rows], ids[rows] = strided_energy_repair(
            z, ql, det_rows, scores[rows, self.k - 1],
            ids[rows], zx, xlam, xn, self.wl, self.wd, k=self.k, n=self.n,
            fallback=fallback, cur_scores=scores[rows])
        return scores, ids

    def __call__(self, z_q, qlam):
        """Exact top-k of one batch: host (scores (B,k), ids (B,k)).
        Reading the flags waits for the device."""
        s, i, flags, det = self.step(z_q, qlam)
        return self.repair(z_q, qlam, det, s.cpu().numpy(), i.cpu().numpy(),
                           flags.cpu().numpy())
