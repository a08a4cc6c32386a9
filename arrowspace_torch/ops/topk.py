"""K3: exact streaming merge top-k (csrc/merge_topk_tf32.cu).

Replaces ``arrowspace_tpu.ops.pallas_topk.fused_lambda_topk``
(pallas_call at pallas_topk.py:263; body ``_kernel`` :90, ``_merge_topk``
:74).  It scores every corpus row with the shifted λ-aware expression and
keeps an exact per-query top-k, ties going to the lowest global id.  It
serves the λ-aware search and the "merge" SearchSession where K1 is
not the engine for F (core.binned_width: float32 F above 352, bf16 F
above 1536; core.merge_fits), and the rows of the binned path's
repair whose fired bins overflow MAX_FIRED (ops/bin_repair).

The CUDA kernels split the corpus into chunks, one CTA per (block of
QUERY_BLOCK queries, chunk), and keep each query's top-k in shared
memory while they stream the chunk's tiles of TILE_ROWS rows through a
TMA ring (``wgmma`` on the tensor cores, a producer warp keeping the ring
full); each writes a partial top-k per (query, chunk), and the plain
two-key sort merges the partials.  Their rings fill an SM's shared
memory, so one CTA runs an SM and the chunk count fills the SMs in whole
waves (``merge_rows_per_chunk``, the same at every F, k and dtype).
``merge_topk_partial_plain`` is the same computation in plain PyTorch.

float32 (csrc/merge_topk_tf32.cu, ``asp_merge_topk_tf32``): the dot
products as K1's 3×TF32 sequence (within 1e-5 of float32; identical
rows, and a (query, row) pair scored by K1, score bitwise alike), the
batch split once into a hi and a lo tf32 plane that stream beside the
corpus, a ring of ``merge_tf32_stages`` stages of 32 features.  Rows are
zero-padded to whole 16 bytes (ops.bintopk.operand_width), as a tensor
map's row stride must be.  ``merge_topk_partial.launches`` counts its
launches, and the recorder's counter ``k3.f32`` (utils.profiling.count)
those inside a session's or stream's record: in a "merge" session's
stream one a batch, in a "binned" session's only the repair's
fallbacks.

bf16 mode (``use_bf16``, the JAX kernel's ``use_bf16=True``): bf16 query
and corpus operands, a kernel of its own (csrc/merge_topk_bf16.cu,
``asp_merge_topk_bf16``, counted by ``merge_topk_partial.launches_bf16``)
that multiplies them with ``wgmma`` from shared memory, float32
accumulation, the slices arriving by TMA into a ring whose depth and
query residency ``merge_bf16_plan`` gives at each (F, k); λ, c1 and the
scores stay float32, and a (query, row) pair scores bitwise as in K1's
bf16 mode.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count
from ._build import check, lib, stream_of
from .bintopk import check_operands, prepare_binned_corpus, wave_chunks
from .search import (INT_MAX, NEG_INF, dot_plane, exact_topk, lambda_term,
                     operand_query, two_key_topk)

__all__ = ["merge_topk_partial", "merge_topk_partial_plain",
           "fused_lambda_topk", "QUERY_BLOCK", "TILE_ROWS",
           "merge_bf16_plan", "merge_tf32_stages", "merge_smem_bytes",
           "merge_rows_per_chunk", "merge_bf16_config", "merge_tf32_config"]

MAX_K = 128
# Both kernels: QUERY_BLOCK queries (wgmma's N in float32, its M in bf16)
# × TILE_ROWS corpus rows a CTA, two consumer warpgroups of 64 rows each;
# rows staged in the 128-byte swizzle, the tiles aligned to 1024 bytes.
QUERY_BLOCK, TILE_ROWS = 64, 128
_SW128_ROW, _SW128_ALIGN = 128, 1024
_SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block can use
_SORT_ELEMS = 1 << 27      # plain version: plane elements per sort
# The bf16 kernel: rows in slices of 64 features (a query slice 64 × 128
# bytes), a ring of 3 to 8 stages.
_BF16_QSLICE = QUERY_BLOCK * _SW128_ROW
_BF16_MIN_STAGES, _BF16_MAX_STAGES = 3, 8
# The float32 kernel: a ring of 3 to 8 stages of one 32-feature box each
# (the tile's corpus rows and the query block's hi and lo tf32 planes,
# 128 bytes a row), each with two 8-byte barriers.
_TF32_STAGE = (TILE_ROWS + 2 * QUERY_BLOCK) * _SW128_ROW
_TF32_MIN_STAGES, _TF32_MAX_STAGES = 3, 8


def _select_smem(k: int) -> int:
    """Per query of a CTA: its k-th (score, id), top-k list and candidate
    buffer of one tile's rows, and its count."""
    qb = QUERY_BLOCK
    return qb * 8 + qb * k * 8 + qb * TILE_ROWS * 8 + qb * 4


def _bf16_stage(resident: bool) -> int:
    return TILE_ROWS * _SW128_ROW + (0 if resident else _BF16_QSLICE)


def _bf16_smem(f: int, k: int, resident: bool, stages: int) -> int:
    """The bf16 kernel's shared memory (csrc smem_bytes): 1024 bytes to
    align the swizzled tiles, the resident query block (ceil(F/64)
    slices), the stages and their two 8-byte barriers (one more for the
    query block), and the selection state."""
    return (_SW128_ALIGN
            + (-(-f // 64) * _BF16_QSLICE if resident else 0)
            + stages * _bf16_stage(resident) + (2 * stages + 1) * 8
            + _select_smem(k))


def merge_bf16_plan(f: int, k: int) -> tuple:
    """What the bf16 kernel runs at (F, k) (csrc plan, the same rule):
    (query block resident, ring stages).  The query block is resident
    where a ring of 3 stages fits beside it and the selection state,
    which grows with k; the ring is as deep as the shared memory allows,
    at most 8.  Streamed, a ring of 3 stages fits at every F and every
    k <= MAX_K."""
    for resident in (True, False):
        room = _SMEM_LIMIT - _bf16_smem(f, k, resident, 0)
        stages = max(0, min(_BF16_MAX_STAGES,
                            room // (_bf16_stage(resident) + 16)))
        if stages >= _BF16_MIN_STAGES:
            return resident, stages
    return False, 0


def _tf32_smem(k: int, stages: int) -> int:
    """The float32 kernel's shared memory (csrc smem_bytes): 1024 bytes
    to align the swizzled boxes, the stages with their barriers, and the
    selection state."""
    return (_SW128_ALIGN + stages * (_TF32_STAGE + 16) + _select_smem(k))


def merge_tf32_stages(k: int) -> int:
    """Stages of the float32 kernel's ring at k (csrc stages): as many as
    fit beside the selection state, at most 8 (3 at k = 128)."""
    room = _SMEM_LIMIT - _tf32_smem(k, 0)
    return max(0, min(_TF32_MAX_STAGES, room // (_TF32_STAGE + 16)))


def merge_smem_bytes(f: int, k: int, use_bf16: bool = False) -> int:
    """K3's dynamic shared memory at (F, k) (csrc smem_bytes): bf16
    _bf16_smem at merge_bf16_plan's choice, float32 _tf32_smem at
    merge_tf32_stages (the same at every F)."""
    if use_bf16:
        return _bf16_smem(f, k, *merge_bf16_plan(f, k))
    return _tf32_smem(k, merge_tf32_stages(k))


def merge_rows_per_chunk(bsz: int, n: int, sms: int) -> int:
    """Corpus rows per chunk of K3: whole TILE_ROWS tiles, the chunk
    count from ops.bintopk.wave_chunks over the grid's ceil(B /
    QUERY_BLOCK) CTAs a chunk, so that the grid fills the ``sms`` SMs,
    one CTA each, in whole waves: at most one chunk an SM (a batch of one
    query block, a repair's rows, then fills nine tenths of the SMs)."""
    n_tiles = max(1, -(-n // TILE_ROWS))
    chunks = wave_chunks(-(-bsz // QUERY_BLOCK), n_tiles, sms, sms)
    return -(-n_tiles // chunks) * TILE_ROWS


def _chunk_rows(bsz: int, n: int, device) -> int:
    """merge_rows_per_chunk on the SMs of ``device`` (one on the CPU)."""
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    else:
        sms = 1
    return merge_rows_per_chunk(bsz, n, sms)


def merge_bf16_config(f: int, k: int) -> dict:
    """What the bf16 kernel runs at (F, k), from the library (CUDA
    only): query block, tile rows, ring stages, dynamic shared bytes,
    the instantiation's registers and spilled bytes a thread, whether
    the query block is resident, and the CTAs an SM holds."""
    out = (ctypes.c_int * 8)()
    check(lib().asp_merge_topk_bf16_config(f, k, out),
          "asp_merge_topk_bf16_config")
    keys = ("query_block", "tile_rows", "stages", "smem_bytes", "registers",
            "spill_bytes", "resident", "ctas_per_sm")
    return dict(zip(keys, out))


def merge_tf32_config(f: int, k: int) -> dict:
    """What the float32 kernel runs at (F, k), from the library (CUDA
    only), in merge_bf16_config's keys (its query block is never
    resident)."""
    out = (ctypes.c_int * 7)()
    check(lib().asp_merge_topk_tf32_config(f, k, out),
          "asp_merge_topk_tf32_config")
    keys = ("query_block", "tile_rows", "stages", "smem_bytes", "registers",
            "spill_bytes", "ctas_per_sm")
    return dict(zip(keys, out))


def merge_topk_partial(qhat, qlam, xhat, xlam, c1: float, n: int, *,
                       k: int, rows_per_chunk: int):
    """Exact top-k of the shifted scores over each chunk of
    ``rows_per_chunk`` corpus rows: (scores (B, chunks, k),
    ids (B, chunks, k) int32), best first, NEG_INF/INT_MAX in slots a
    short chunk cannot fill.  bf16 qhat and xhat take the bf16 kernel,
    float32 ones the float32 kernel (ops.bintopk.check_operands says what
    the kernels read).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if qhat.device.type == "cpu":
        return merge_topk_partial_plain(qhat, qlam, xhat, xlam, c1, n, k=k,
                                        rows_per_chunk=rows_per_chunk)
    bsz, f = qhat.shape
    bf16 = check_operands("merge_topk_partial", qhat, qlam, xhat, xlam)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"merge_topk_partial: k={k} outside [1, {MAX_K}]")
    if merge_smem_bytes(f, k, bf16) > _SMEM_LIMIT:
        raise ValueError(f"merge_topk_partial: F={f}, k={k} exceeds the "
                         "kernel's shared-memory budget")
    if xhat.shape[0] < n or xhat.shape[1] != f or rows_per_chunk < 1:
        raise ValueError("merge_topk_partial: bad corpus shape")
    chunks = -(-n // rows_per_chunk)
    out_s = torch.empty((bsz, chunks, k), device=qhat.device,
                        dtype=torch.float32)
    out_i = torch.empty((bsz, chunks, k), device=qhat.device,
                        dtype=torch.int32)
    if bsz == 0 or n <= 0:
        return out_s, out_i
    args = (qhat.data_ptr(), qlam.data_ptr(), xhat.data_ptr(),
            xlam.data_ptr(), c1, n, bsz, f, k, chunks, rows_per_chunk,
            out_s.data_ptr(), out_i.data_ptr())
    if bf16:
        check(lib().asp_merge_topk_bf16(*args, stream_of(qhat)),
              "asp_merge_topk_bf16")
        merge_topk_partial.launches_bf16 += 1
        return out_s, out_i
    # the query rows split into a hi and a lo plane
    planes = torch.empty((2, bsz, f), device=qhat.device,
                         dtype=torch.float32)
    check(lib().asp_merge_topk_tf32(*args, planes.data_ptr(),
                                    stream_of(qhat)), "asp_merge_topk_tf32")
    merge_topk_partial.launches += 1
    count("k3.f32")
    return out_s, out_i


merge_topk_partial.launches = 0       # float32
merge_topk_partial.launches_bf16 = 0


def merge_topk_partial_plain(qhat, qlam, xhat, xlam, c1: float, n: int, *,
                             k: int, rows_per_chunk: int):
    """Plain PyTorch version of the K3 kernel, same outputs and layout;
    bf16 operands are multiplied in float32 (dot_plane)."""
    parts_s, parts_i = [], []
    block = max(1, _SORT_ELEMS // rows_per_chunk)    # queries per sort
    for r0 in range(0, n, rows_per_chunk):
        r1 = min(n, r0 + rows_per_chunk)
        s_parts, i_parts = [], []
        for b0 in range(0, qhat.shape[0], block):
            plane = dot_plane(qhat[b0:b0 + block], xhat[r0:r1]) \
                - lambda_term(qlam[b0:b0 + block], xlam[r0:r1], c1)
            s, i = exact_topk(plane, min(k, r1 - r0))
            s_parts.append(s)
            i_parts.append(i)
        s = torch.cat(s_parts)
        i = (torch.cat(i_parts) + r0).to(torch.int32)
        if s.shape[1] < k:
            pad = k - s.shape[1]
            s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
            i = torch.nn.functional.pad(i, (0, pad), value=INT_MAX)
        parts_s.append(s)
        parts_i.append(i)
    return torch.stack(parts_s, dim=1), torch.stack(parts_i, dim=1)


def fused_lambda_topk(queries, query_lambdas, items, item_lambdas, alpha,
                      *, k: int, prepared: bool = False, n_items: int = 0,
                      rows_per_chunk: int = 0, use_bf16: bool = False):
    """Exact λ-aware top-k through K3: (scores (B,k), ids (B,k) int64).

    ``prepared=True`` takes items/item_lambdas from
    ops.bintopk.prepare_binned_corpus (bf16 when that corpus is) and the
    true row count from n_items; otherwise the corpus is normalised here,
    in bf16 with ``use_bf16``.  The query is prescaled in the scoring
    dtype (item_lambdas') before its cast, as in K1's wrapper."""
    if not prepared:
        n_items = items.shape[0]
        items, item_lambdas = prepare_binned_corpus(items, item_lambdas,
                                                    use_bf16=use_bf16)
    n = n_items
    dt = item_lambdas.dtype
    qhat, c1 = operand_query(queries, alpha, dt, items)
    qlam = query_lambdas.to(dt).contiguous()
    rows_per_chunk = rows_per_chunk or _chunk_rows(qhat.shape[0], n,
                                                   qhat.device)
    part_s, part_i = merge_topk_partial(qhat, qlam, items, item_lambdas, c1,
                                        n, k=k,
                                        rows_per_chunk=rows_per_chunk)
    bsz = part_s.shape[0]
    s, i = two_key_topk(part_s.reshape(bsz, -1),
                        part_i.reshape(bsz, -1).long(), k)
    return s + c1, i
