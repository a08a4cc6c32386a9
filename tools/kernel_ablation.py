#!/usr/bin/env python3
"""Ablation of the tensor-core kernels K1 (csrc/bintopk.cu), K1's bf16
mode (csrc/bintopk_bf16.cu), float32 K1's wgmma route
(csrc/bintopk_tf32.cu), float32 K3 (csrc/merge_topk_tf32.cu), K3's bf16
mode (csrc/merge_topk_bf16.cu), K6 (csrc/energy_bintopk.cu), K7
(csrc/energy_chord.cu), and K2 (csrc/taulambda.cu) and K5
(csrc/lambda_batch.cu) on their shared λ body (csrc/lambda_tile.cuh),
and of the τ selection that K4 (csrc/select_tau.cu) and K2 share
(common.cuh), on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/kernel_ablation.py
        [--kernels k1,k1bf16,k1tf32,k3tf32,k3grid,k3bf16,engines,k6,k7,k2,k5,
                   k4]
        [--before DIR]

Where no kernel profiler can be used, this is the way to see what bounds
a kernel: it compiles copies of the kernel's sources with one part taken
out (by text substitution; every substitution must match, or the script
fails) and times each copy on the same inputs at the serving shapes:

- K1: 1,000,000 clustered unit rows at F = 128 and F = 768, B = 2048
  α-scaled queries, 128 bins, depth 3;
- K1's bf16 mode (``--kernels k1bf16``): the same rows at F = 128, 768
  and 1536 as the bf16 sessions' operands, B = 2048, 128 bins, depth 3,
  with its query block, ring stages and shared bytes, its bound (2·B·N·F
  bf16 operations at 989.4 TFLOP/s) and the corpus bytes every query
  block reads from L2, (B / QB)·N·F·2, with the rate they imply;
- float32 K1's wgmma route (``--kernels k1tf32``): the clustered rows at
  the glove cell's 1,183,514 x 100 and at 1M x 128, B = 2048, 128 bins,
  depth 3, at the wrapper's chunking, beside this checkout's mma.sync
  kernel (the pools held bitwise equal) with its ring stages, shared
  bytes, bound (3·2·B·N·F TF32 operations at 494.7 TFLOP/s) and the
  corpus bytes every query block reads from L2, (B / 64)·N·F·4;
- K3's bf16 mode (``--kernels k3bf16``): the same rows as bf16 operands
  at 1M x 128, 1M x 1536 and 1M x 3072 (B = 2048, k = 10), at 1M x 1536
  with k = 128, and the B = 1 repair row at 1M x 128 (the median of 25
  single launches), at the wrapper's chunking, with what each launch runs
  (merge_bf16_plan: ring stages, query residency), its
  bound and the bytes every CTA reads from L2, the corpus (B / 64)·N·F·2
  and, where the query block is not resident, the query slices
  B·N·F·2 / (tile rows), with the rate they imply;
- float32 K3 (``--kernels k3tf32``): the clustered rows at 1M x 128,
  768, 1536 and 3072, B = 2048, k = 10 and 100, at its chunking, with
  its ring stages, shared bytes, bound (3·2·B·N·F TF32 operations at
  494.7 TFLOP/s) and the L2 bytes of its stages a batch (the corpus box
  and both query planes' boxes of every tile), with the rate they imply;
  with ``--before DIR``, beside DIR's mma.sync kernel (merge_topk.cu, at
  its own chunking; the outputs held bitwise equal at this kernel's);
- float32 K3 against the mma.sync kernel it replaced (``--kernels
  k3grid --before DIR``, DIR a csrc holding merge_topk.cu, for instance
  an earlier commit's unpacked with ``git archive``): 1M clustered rows,
  B = 1, 16, 32 and 63 at F = 128, 768 and 1536 (k = 10), B = 1 at F =
  768 with k = 100, and B = 2048 at F = 64, 100, 1537 and 4096, each
  kernel at its own chunking, mean ms of 10 launches in turns, the
  merged top-k and the partials at this kernel's chunking held bitwise
  equal;
- the float32 engines (``--kernels engines``): the binned engine (K1 on
  the route it takes, its flush, and the exact repair of flagged rows,
  ops.bin_repair.BinnedTopK) against the merge engine (K3, its query
  split and its merge of the chunks' partials, ops.topk.fused_lambda_topk)
  on the same prepared corpus of 1M clustered rows, F in ENGINE_WIDTHS, k
  in ENGINE_KS, B in ENGINE_BATCHES (raw queries: the rows × 1.02), each
  at its own chunking: mean ms of 10 calls in turns binned, merge, merge,
  binned (the binned engine's step; the repair's host-clock ms once
  beside it), the mean SM clock and power over each engine's turns, and
  both engines' top-k held bitwise equal on every row K1 did not flag
  (on a flagged row the strided repair rescores in a float32 cuBLAS
  product, so there: scores within 1e-5, ids equal outside near-ties);
- K6 and K7: chip_smoke.py's energy z-plane, made on the card: the
  clustered 1,000,000 x 128 rows projected to G = 64 by a seeded
  Gaussian matrix (scaled by 1/√G, as the JL projection is), queries the
  rows ×1.02, w_λ = 1, w_D = 0.5, 128 bins, depth 3; the plane centred
  on its mean as the binned energy engine serves it, and (precision
  variants) uncentred too;
- K5: 688,128 clustered rows at F = 768 (the wide build's first row
  window) with their median τ, over a graph of n = 185 nodes made on the
  card as the wide build makes it (the builder's λ-graph, ε = 1.0, over
  317 centroid-like rows projected to 185 dimensions by the seeded JL
  projection); K2: the clustered rows at F = 128, 262,144 and 1,000,000
  of them, over the graph made the same way from 128-wide centroid-like
  rows (n = 128), median τ.  Both also on 65,536 cancellation-prone rows
  (0.5 ± 0.05 and 0.5 ± 0.01 over a dense random graph).
- K4 (``--kernels k4``): median τ of the clustered rows at the three
  shapes the builds give it, 1,000,000 x 128 (the energy build),
  688,128 x 768 (the wide build's first row window) and 344,064 x 1536
  (the 1536 build's), and of 1,000,000 x 128 rows whose values share
  every radix digit but the last (the selection's slowest case); then
  K2 as above with the same selection variants.

Variants: "kernel" (as shipped), "no_fold" (no score tail, insertion
network or det), "no_staging" (the first slice only; K1's bf16 mode: no
refill of its ring, each step multiplying what its stage holds),
"no_product", "product_only", "staging_only"; K1 also "one_tf32" and
"lo_truncated";
float32 K1's wgmma route also "one_tf32" (hi·hi alone), "no_x_split"
(the corpus fragments unsplit: what corpus planes split once could save
of the split at most), "planes" and "planes_staging_only" (the corpus
split once on the host into a hi and a lo plane that the ring carries,
no split in registers: the pools bitwise the kernel's), "group4" (two
chains of 4 k8 steps a slice) and
"fold_skip" (the insertion network skipped where a score does not beat
its pool's last: the same pools);
K3's bf16 mode "kernel", "no_select" (no candidate appended, so no merge
runs), "product_only" (no refill of the ring and no selection),
"staging_only" (no wgmma and no selection) and "n32" (wgmma m64n32k16,
32 rows a warpgroup, instead of m64n64k16); float32 K3 "kernel",
"no_select", "product_only" and "staging_only" (the same parts); K6 and
K7 also
"partial_8/16/64" (the truncating accumulate summed in zeroed partials
of 8, 16 or 64 features instead of the shipped 32); K2
and K5 (fold: the epilogue that multiplies the products by the rows'
coordinates; staging: the graph slices) also "no_b_split" (the graph
operands passed to the tensor core unsplit: what splitting them once
per launch could save at most) and "nt4" (a warp on 4 n-tiles of graph
rows instead of 2: 171 registers, one CTA an SM) and "four_tf32" (lo·lo
added to the three products, with its λ errors).  A variant with a part
removed computes garbage: only "kernel" is checked against the plain
version; for K2 and K5 it also reports its λ error against a float64 λ
computed on the card.  For K6 and K7 every variant that keeps the
product also reports its error against float64: K6's pool scores, K7's
pooled d² and u = w_D/(1+√d²) from it, over the first 512 queries.
The τ selection (K4, and K2 under ``--kernels k4``): "kernel" (the
radix select), "range_only" (the row load, the range reductions and one
τ a row: the floor the selection can reach), and three bisections of
the offsets' range in its place: "old_count" (32 passes over the whole
32-bit range, a ballot and popc per held value, the count of earlier
commits), "redux_count" (32 passes, each lane counting with compares
and one warp reduction a pass) and "redux_bounded" (the same inside the
row's [lo, hi], ⌈log2(hi - lo + 1)⌉ passes at most).  Every variant but
"range_only" is held bitwise to the sort.

``--before DIR`` also ablates the K6 and K7 of another checkout's csrc
directory (DIR), for instance the fp32 fold of an earlier commit
unpacked with ``git archive``; its C entry points must be the same.  For
K1 and K1's bf16 mode it builds DIR's kernel beside this one, times
both, and compares their machine code (cuobjdump -sass) instantiation
by instantiation; for K1's bf16 mode it times DIR's
``asp_bintopk_bf16`` as shipped (from DIR's bintopk_bf16.cu, or its
bintopk.cu where the bf16 mode was an instantiation of the float32
kernel); for float32 K3 and ``k3grid`` DIR's mma.sync kernel
(merge_topk.cu) as shipped, at its own chunking; for float32 K1's wgmma
route DIR's float32 K1 as shipped (its
``asp_bintopk``), timed before and after this checkout's variants, and
DIR's ``bintopk_kernel`` machine code against this checkout's; for
K3's bf16 mode DIR's ``asp_merge_topk_bf16`` as shipped (from DIR's
merge_topk_bf16.cu, or its merge_topk.cu, where the bf16 mode was an
instantiation of the float32 kernel, at that kernel's chunking), timed
before and after this one's variants at each shape; for K2 and
K5 it times DIR's kernel as shipped and reports its float64 error beside
this one's; for K4 it times DIR's kernel as shipped (and, where DIR's
gate refuses F, the sort that DIR's builds then take).

Output: the card's name and power limit, each variant's registers and
spills by instantiation (ptxas), then one line per (kernel, plane,
variant) with its mean milliseconds over 5 launches (CUDA events, after
one warm-up).  Build outputs go to arrowspace_torch/_build/ablation/.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from arrowspace_torch.graph import GraphFactory  # noqa: E402
from arrowspace_torch.ops import bin_repair as br  # noqa: E402
from arrowspace_torch.ops import bintopk as bt  # noqa: E402
from arrowspace_torch.ops import lambda_batch as lb  # noqa: E402
from arrowspace_torch.ops import taulambda as tl  # noqa: E402
from arrowspace_torch.ops import energy_approx as ea  # noqa: E402
from arrowspace_torch.ops import energy_bintopk as eb  # noqa: E402
from arrowspace_torch.ops import topk as tk  # noqa: E402
from arrowspace_torch.ops._build import (CSRC, FLAGS, SIGNATURES,  # noqa
                                         _nvcc)
from arrowspace_torch.ops.search import (INT_MAX, operand_query,  # noqa
                                         prepare_query, safe_unit,
                                         two_key_topk)
from arrowspace_torch.reduction import ImplicitProjection  # noqa: E402
from arrowspace_torch.taumode import TauMode, select_tau_sorted  # noqa: E402

OUT = ROOT / "arrowspace_torch" / "_build" / "ablation"
N, B, BINS, DEPTH, K = 1_000_000, 2048, 128, 3, 10
WL, WD = 1.0, 0.5
CANCEL_SPREADS = (0.05, 0.01)   # K2's and K5's rows 0.5 ± spread

# (file, old, new) substitutions of each part, by kernel and design
K1_PARTS = {
    "product": [("bintopk.cu", "asp_fold::kstep(part, qa + kk, QS, xb + kk);",
                 "(void)0;")],
    "fold": [("bintopk.cu", "if (gr < a.n) {",
              "if (gr < a.n && a.c1 > 1e30f) {")],
    "staging": [("bintopk.cu",
                 "    if (step + 1 < steps) {\n      const bool wrap",
                 "    if (false) {\n      const bool wrap")],
}
K1BF16_PARTS = {   # K1's bf16 mode (csrc/bintopk_bf16.cu)
    "product": [("bintopk_bf16.cu", "wgmma_m64n32k16_bf16(part,",
                 "if (false) wgmma_m64n32k16_bf16(part,")],
    "fold": [("bintopk_bf16.cu", "if (gr < n) {",
              "if (gr < n && c1 > 1e30f) {")],
    # no refill: each step multiplies whatever its stage holds, waiting
    # only for the prologue's copies
    "staging": [("bintopk_bf16.cu",
                 "if (tid == 0 && step > 0 && step - 1 + S < total) {",
                 "if (false) {"),
                ("bintopk_bf16.cu", "    mbar_wait(full + 8 * st, phase);",
                 "    if (step < S) mbar_wait(full + 8 * st, phase);")],
}
K1TF32_PARTS = {   # K1's float32 wgmma route (csrc/bintopk_tf32.cu)
    "product": [("bintopk_tf32.cu", "wgmma_m64n32k8_tf32(part,",
                 "if (false) wgmma_m64n32k8_tf32(part,")],
    "fold": [("bintopk_tf32.cu", "if (gr < a.n) {",
              "if (gr < a.n && a.c1 > 1e30f) {")],
    # no refill: each step multiplies whatever its stage holds, waiting
    # only for the prologue's copies
    "staging": [("bintopk_tf32.cu",
                 "if (tid == 0 && step >= lag && step - lag + S < total) {",
                 "if (false) {"),
                ("bintopk_tf32.cu", "    mbar_wait(full + 8 * st, phase);",
                 "    if (step < S) mbar_wait(full + 8 * st, phase);")],
}
K3BF16_PARTS = {   # K3's bf16 mode (csrc/merge_topk_bf16.cu)
    "product": [("merge_topk_bf16.cu", "wgmma_rows<kN>(p,",
                 "if (false) wgmma_rows<kN>(p,")],
    "select": [("merge_topk_bf16.cu",
                "if (live_q[i] && __fsub_rn(dot, lift) >= kth_s) {",
                "if (live_q[i] && a.c1 > 1e30f) {")],
    # no refill: the producer fills the ring once, and each step
    # multiplies whatever its stage holds
    "staging": [("merge_topk_bf16.cu", "const int loads = total;",
                 "const int loads = min(total, S);"),
                ("merge_topk_bf16.cu", "    mbar_wait(full + 8 * st, phase);",
                 "    if (step < S) mbar_wait(full + 8 * st, phase);")],
}
K3TF32_PARTS = {   # float32 K3 (csrc/merge_topk_tf32.cu)
    "product": [("merge_topk_tf32.cu", "wgmma_m64n64k8_tf32(part,",
                 "if (false) wgmma_m64n64k8_tf32(part,")],
    "select": [("merge_topk_tf32.cu",
                "if (__fsub_rn(dot, lift) >= kth_s) {",
                "if (a.c1 > 1e30f) {")],
    # no refill: the producer fills the ring once, and each box multiplies
    # whatever its stage holds
    "staging": [("merge_topk_tf32.cu", "const int loads = tiles * nb;",
                 "const int loads = min(tiles * nb, S);"),
                ("merge_topk_tf32.cu", "      mbar_wait(full + 8 * st, phase);",
                 "      if (tile == 0 && bx < S)\n"
                 "        mbar_wait(full + 8 * st, phase);")],
}
TILE_PARTS = {   # the energy tile (csrc/energy_tile.cuh)
    "product": [("energy_tile.cuh", "      tile_product_full<NT>(acc, qa, xb);",
                 "      (void)0;"),
                ("energy_tile.cuh",
                 "      tile_product<NT>(acc, qa, xb, fk);", "      (void)0;")],
    "fold": [("energy_tile.cuh", "if (gr < a.n) {",
              "if (gr < a.n && a.n < 0) {")],
    "staging": [("energy_tile.cuh",
                 "    if (step + 1 < steps) {\n      const bool wrap",
                 "    if (false) {\n      const bool wrap")],
}
FOLD_PARTS = {   # the fp32 fold of earlier commits (binned_fold.cuh)
    "product": [("binned_fold.cuh",
                 "fma_group<BINS, G, QG, QT>(acc, qb, QS, xb, ff, tx, ty);",
                 "(void)0;")],
    "fold": [("binned_fold.cuh", "if (g < n) {", "if (g < n && n < 0) {")],
    "staging": [("binned_fold.cuh",
                 "    if (step + 1 < steps) {\n      const bool wrap",
                 "    if (false) {\n      const bool wrap")],
}


def variants(parts: dict, extra: dict) -> dict:
    p = parts
    return {"kernel": [], "no_fold": p["fold"], "no_staging": p["staging"],
            "no_product": p["product"],
            "product_only": p["staging"] + p["fold"],
            "staging_only": p["product"] + p["fold"], **extra}


K1_VARIANTS = variants(K1_PARTS, {
    "one_tf32": [("binned_fold.cuh",
                  "    mma_tf32(acc[j], alo, bhi0, bhi1);\n"
                  "    mma_tf32(acc[j], ahi, blo0, blo1);\n", "")],
    # lo passed unrounded: the tensor core then reads its top 19 bits
    "lo_truncated": [("binned_fold.cuh",
                      "  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));",
                      "  lo = __float_as_uint(__fsub_rn(v, "
                      "__uint_as_float(hi)));")]})
TILE_VARIANTS = variants(TILE_PARTS, {
    f"partial_{pk}": [("energy_tile.cuh", "constexpr int kPartial = 32;",
                       f"constexpr int kPartial = {pk};")]
    for pk in (8, 16, 64)})
LAMBDA_PARTS = {   # the λ body of K2 and K5 (csrc/lambda_tile.cuh)
    "product": [("lambda_tile.cuh",
                 "        kstep(P, xa + kk, S, gb + kk, nt_live);",
                 "        (void)0;")],
    "fold": [("lambda_tile.cuh", "      fold(s, P, xs + (m0 + g) * S",
              "      if (n < 0) fold(s, P, xs + (m0 + g) * S")],
    "staging": [("lambda_tile.cuh",
                 "    if (step + 1 < steps) {\n      const int p1",
                 "    if (false) {\n      const int p1")],
}
K1BF16_VARIANTS = variants(K1BF16_PARTS, {})
# The wgmma route with the corpus split on the host: the tensor map reads
# a (rows, 2·FP) plane, hi in columns [0, F) and lo in [FP, FP + F), FP =
# ceil32(F), zeros between (k1tf32_planes); a stage holds both slices,
# the lo boxes 2·8192 bytes past the hi ones, and a fragment is loaded
# from both, unsplit.
K1TF32_PLANES = [
    ("bintopk_tf32.cu", "constexpr int kStage = 2 * kXBox;",
     "constexpr int kStage = 4 * kXBox;"),
    ("bintopk_tf32.cu",
     "  mbar_expect_tx(bar, boxes * kXBox);\n"
     "  tma_load_2d(xs + st * kStage, xmap, f0, row, bar);\n"
     "  if (boxes > 1)\n"
     "    tma_load_2d(xs + st * kStage + kXBox, xmap, f0 + kBox, row, bar);\n",
     "  const int fp = (F + kBox - 1) / kBox * kBox;\n"
     "  mbar_expect_tx(bar, 2 * boxes * kXBox);\n"
     "  for (int b = 0; b < boxes; ++b) {\n"
     "    tma_load_2d(xs + st * kStage + b * kXBox, xmap, f0 + b * kBox, row,\n"
     "                bar);\n"
     "    tma_load_2d(xs + st * kStage + (2 + b) * kXBox, xmap,\n"
     "                fp + f0 + b * kBox, row, bar);\n"
     "  }\n"),
    ("bintopk_tf32.cu",
     "#pragma unroll\n"
     "  for (int e = 0; e < 4; ++e) asp_fold::split_tf32(v[e], hi[e], lo[e]);",
     "  const uint8_t* lbox = box + 2 * kXBox;\n"
     "  const uint32_t off[4] = {sw128_offset(r, c), sw128_offset(r + 8, c),\n"
     "                           sw128_offset(r, c + 4),\n"
     "                           sw128_offset(r + 8, c + 4)};\n"
     "#pragma unroll\n"
     "  for (int e = 0; e < 4; ++e) {\n"
     "    hi[e] = __float_as_uint(v[e]);\n"
     "    lo[e] = *reinterpret_cast<const uint32_t*>(lbox + off[e]);\n"
     "  }"),
    ("bintopk_tf32.cu", "encode_f32_rows(&xmap, xhat, a.n, a.F, kBG)",
     "encode_f32_rows(&xmap, xhat, a.n, 2 * ((a.F + kBox - 1) / kBox * kBox), "
     "kBG)")]
K1TF32_VARIANTS = variants(K1TF32_PARTS, {
    # hi·hi alone: chains a third as long
    "one_tf32": [("bintopk_tf32.cu",
                  "          wgmma_m64n32k8_tf32(part, ahi[kk], dlo + k8, "
                  "k0 + kk > 0);\n"
                  "          wgmma_m64n32k8_tf32(part, alo[kk], dhi + k8, "
                  "1);\n"
                  "          wgmma_m64n32k8_tf32(part, ahi[kk], dhi + k8, "
                  "1);\n",
                  "          wgmma_m64n32k8_tf32(part, ahi[kk], dhi + k8, "
                  "k0 + kk > 0);\n")],
    # the corpus fragments passed unsplit (hi = lo = v): what splitting
    # the corpus once, into planes the ring would carry at twice the
    # bytes, could save at most of the in-register split
    "no_x_split": [("bintopk_tf32.cu",
                    "  for (int e = 0; e < 4; ++e) asp_fold::split_tf32("
                    "v[e], hi[e], lo[e]);",
                    "  for (int e = 0; e < 4; ++e) hi[e] = lo[e] = "
                    "__float_as_uint(v[e]);")],
    # the corpus split once on the host into a hi and a lo plane
    # (K1TF32_PLANES), each stage's slice carried as both: what the ring
    # pays at twice the bytes for the split it no longer does
    "planes": K1TF32_PLANES,
    "planes_staging_only": (K1TF32_PLANES + K1TF32_PARTS["product"]
                            + K1TF32_PARTS["fold"]),
    # DEPTH 4's two chains of 4 k8 steps a slice at every depth
    "group4": [("bintopk_tf32.cu",
                "constexpr int kGroup = DEPTH >= 4 ? 4 : 8;",
                "constexpr int kGroup = 4;")],
    # the insertion network skipped by a thread whose score does not beat
    # its pool's last (the same pools): what a cheaper fold could save
    "fold_skip": [("bintopk_tf32.cu",
                   "            int ci = (int)gr;\n#pragma unroll\n",
                   "            int ci = (int)gr;\n"
                   "            if (cs > s[DEPTH - 1][r])\n")]})
K3BF16_VARIANTS = {
    "kernel": [], "no_select": K3BF16_PARTS["select"],
    "product_only": K3BF16_PARTS["staging"] + K3BF16_PARTS["select"],
    "staging_only": K3BF16_PARTS["product"] + K3BF16_PARTS["select"],
    "n32": [("merge_topk_bf16.cu", "constexpr int kN = 64;",
             "constexpr int kN = 32;")]}
# K3's bf16 mode at (F, B, k): the serving widths, the 3072-wide
# embeddings, the deepest k and the repair's single row
K3BF16_SHAPES = ((128, 2048, 10), (1536, 2048, 10), (3072, 2048, 10),
                 (1536, 2048, 128), (128, 1, 10))
K3TF32_VARIANTS = {
    "kernel": [], "no_select": K3TF32_PARTS["select"],
    "product_only": K3TF32_PARTS["staging"] + K3TF32_PARTS["select"],
    "staging_only": K3TF32_PARTS["product"] + K3TF32_PARTS["select"]}
# float32 K3 at (F, k), B = 2048: the widths first timed, at the dbpedia
# cell's k and at cohere's
K3TF32_SHAPES = tuple((f, k) for f in (128, 768, 1536, 3072)
                      for k in (10, 100))
FOLD_VARIANTS = variants(FOLD_PARTS, {})
LAMBDA_VARIANTS = variants(LAMBDA_PARTS, {
    "no_b_split": [("lambda_tile.cuh",
                    f"asp_fold::split_tf32({v}, {hi}, {lo});",
                    f"{hi} = {lo} = __float_as_uint({v});")
                   for v, hi, lo in (
                       ("b[0]", "lh0", "ll0"), ("b[4]", "lh1", "ll1"),
                       ("b[kNI * kXS]", "wh0", "wl0"),
                       ("b[kNI * kXS + 4]", "wh1", "wl1"),
                       ("b[2 * kNI * kXS]", "vh0", "vl0"),
                       ("b[2 * kNI * kXS + 4]", "vh1", "vl1"))],
    "nt4": [("lambda_tile.cuh", "constexpr int kNT = 2;",
             "constexpr int kNT = 4;")],
    # the fourth product lo·lo too: how much of the λ error the 3×TF32
    # split leaves out
    "four_tf32": [("lambda_tile.cuh",
                   "  mma_tf32_zero(d, al, bh0, bh1);\n",
                   "  mma_tf32_zero(d, al, bh0, bh1);\n"
                   "  asp_fold::mma_tf32(d, al, bl0, bl1);\n")]})
# the bisections that the τ selection's variants put in the radix
# select's place (same arguments; common.cuh)
BISECT = """
template <int NV, bool POPC, bool BOUNDED>
__device__ unsigned asp_bisect_select(const unsigned (&u)[NV], unsigned k,
                                      unsigned range, unsigned*) {
  unsigned lo = 0, hi = BOUNDED ? range : 0xFFFFFFFFu;
  while (lo < hi) {
    const unsigned mid = lo + (hi - lo) / 2;
    unsigned cnt = 0;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      if (POPC)
        cnt += __popc(__ballot_sync(ASP_FULL_MASK, u[m] <= mid));
      else
        cnt += u[m] <= mid;
    }
    if (!POPC) cnt = __reduce_add_sync(ASP_FULL_MASK, cnt);
    if (cnt >= k + 1)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

"""
TAU_ANCHOR = "// τ of one row held as y (see above)"
SELECT_VARIANTS = {
    "kernel": [],
    "range_only": [("common.cuh", "  if (m == 0) return ASP_TAU_FLOOR;\n",
                    "  if (m >= 0) return asp_from_sortable(lo);\n")],
    **{name: [("common.cuh", TAU_ANCHOR, BISECT + TAU_ANCHOR),
              ("common.cuh", "asp_radix_select<NV>(",
               f"asp_bisect_select<NV, {popc}, {bounded}>(")]
       for name, popc, bounded in (("old_count", "true", "false"),
                                   ("redux_count", "false", "false"),
                                   ("redux_bounded", "false", "true"))}}
K4_SHAPES = ((1_000_000, 128), (688_128, 768), (344_064, 1536))
SOURCES = {"k1": "bintopk.cu", "k1bf16": "bintopk_bf16.cu",
           "k1tf32": "bintopk_tf32.cu", "k3bf16": "merge_topk_bf16.cu",
           "k3tf32": "merge_topk_tf32.cu",
           "k6": "energy_bintopk.cu", "k7": "energy_chord.cu",
           "k2": "taulambda.cu", "k5": "lambda_batch.cu",
           "k4": "select_tau.cu"}
ENTRY = {"k1": "asp_bintopk", "k1bf16": "asp_bintopk_bf16",
         "k1tf32": "asp_bintopk_tf32", "k3bf16": "asp_merge_topk_bf16",
         "k3tf32": "asp_merge_topk_tf32",
         "k6": "asp_energy_bintopk", "k7": "asp_energy_chord",
         "k2": "asp_taulambda", "k5": "asp_lambda_batch",
         "k4": "asp_select_tau"}


# the kernels whose machine code --before compares, by function name
SASS_KERNEL = {"k1": "bintopk_kernel", "k1bf16": "bintopk_bf16_kernel",
               "k1tf32": "bintopk_tf32_kernel"}
# float32 K3's mma.sync kernel of earlier commits (their
# csrc/merge_topk.cu), built from --before's csrc: its C entry, the one
# that file exports, took asp_merge_topk_bf16's arguments
OLD_K3 = "merge_topk.cu"


def build(kernel: str, csrc: pathlib.Path, table: dict, tag: str,
          source: str = "") -> dict:
    """One shared library per variant, all nvcc runs started together,
    from ``source`` (default SOURCES[kernel]); prints each variant's
    registers and spills by instantiation.  Binds ENTRY[kernel], or for
    OLD_K3 the C entry that file exports."""
    procs = {}
    for name, subs in table.items():
        src = OUT / f"{tag}_{kernel}_{name}"
        if src.exists():
            shutil.rmtree(src)
        shutil.copytree(csrc, src)
        for fname, old, new in subs:
            path = src / fname
            text = path.read_text()
            if text.count(old) < 1:
                raise SystemExit(f"{tag} {kernel} {name}: substitution "
                                 f"{old!r} not found in {fname}")
            path.write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [_nvcc(), *FLAGS, "-shared", "-I", str(src), "-o",
             str(src / "lib.so"), str(src / (source or SOURCES[kernel]))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag} {kernel} {name}:\n{log}")
        regs = re.findall(r"Compiling entry function '(\w+)'.*?\n(?:.*\n)*?"
                          r".*?(\d+) bytes spill stores.*?\n.*?Used (\d+) "
                          r"registers", log)
        summary = ", ".join(f"{short(fn)}: {r} regs"
                            + (f" {sp} B spilled" if sp != "0" else "")
                            for fn, sp, r in regs if "kernel" in fn)
        print(f"{tag} {kernel} {name}: {summary}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{tag}_{kernel}_{name}" / "lib.so"))
        if source == OLD_K3:
            entry = re.search(r'extern "C" int (\w+)\(',
                              (csrc / OLD_K3).read_text()).group(1)
            fn = getattr(lib, entry)
            fn.argtypes = list(SIGNATURES["asp_merge_topk_bf16"])
        else:
            fn = getattr(lib, ENTRY[kernel])
            fn.argtypes = list(SIGNATURES[ENTRY[kernel]])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def short(mangled: str) -> str:
    """'depth,query block' (K4: 'slots,vector loads'; K3's bf16 mode: 'resident' 1 or 0; ',bf16' for a bf16 instantiation
    of a kernel templated on the operand type) of a mangled kernel
    instantiation."""
    nums = re.findall(r"ILi(\d+)EL[ib](\d+)E", mangled)
    one = re.findall(r"IL[ib](\d+)E", mangled)
    if not nums and not one:
        return mangled[:40]
    key = ",".join(nums[0]) if nums else one[0]
    return key + (",bf16" if "nv_bfloat16" in mangled else "")


def chunking(ctas: int, dev) -> tuple:
    """(chunks, tiles per chunk) as the wrappers choose them."""
    n_tiles = -(-N // BINS)
    tpc = -(-n_tiles // bt._default_chunks(ctas, n_tiles, dev))
    return -(-n_tiles // tpc), tpc


def time_ms(call, reps: int = 5) -> float:
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def clustered(dev, n: int, f: int, seed: int):
    """chip_smoke.py's corpus kind, made on the card: 64 centres in
    [0.2, 0.8], noise 0.05."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cen = torch.rand(64, f, device=dev, generator=gen) * 0.6 + 0.2
    pick = torch.randint(0, 64, (n,), device=dev, generator=gen)
    return cen[pick] + 0.05 * torch.randn(n, f, device=dev, generator=gen), \
        gen


def k1_inputs(dev, f: int):
    x, gen = clustered(dev, N, f, seed=f)
    xl = torch.rand(N, device=dev, generator=gen) * 0.2
    xh, xlh = bt.prepare_binned_corpus(x, xl)
    qh, c1 = prepare_query(x[:B] * 1.02, 0.9, dtype=torch.float32)
    return qh.contiguous(), xl[:B].contiguous(), xh, xlh, c1


def sass(kernel: str, tag: str) -> dict:
    """{short(instantiation): [instructions]} of a built variant's
    SASS_KERNEL[kernel] instantiations."""
    tool = pathlib.Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(
        OUT / f"{tag}_{kernel}_kernel" / "lib.so")], capture_output=True,
        text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            key = short(name) if SASS_KERNEL[kernel] + "I" in name else None
            if key:
                out[key] = []
        elif key and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[key].append(line.split("*/", 1)[1].split(";")[0].strip())
    return out


def compare_sass(kernel: str, now: str = "now") -> None:
    """Prints, per instantiation of this checkout's kernel (built under
    tag ``now``), whether its machine code equals the --before build's."""
    a, b = sass(kernel, "before"), sass(kernel, now)
    for key in sorted(b):
        print(f"{kernel} {key}: {len(b[key])} instructions, machine code "
              f"equal to --before's: {a.get(key) == b[key]}", flush=True)


def run_k1(libs, dev, tag: str = "now") -> None:
    stream = torch.cuda.current_stream().cuda_stream
    for f in (128, 768):
        qh, ql, xh, xlh, c1 = k1_inputs(dev, f)
        chunks, tpc = chunking(bt.grid_ctas(B, BINS, f), dev)
        ps = torch.empty((B, chunks, DEPTH, BINS), device=dev)
        pi = torch.empty_like(ps, dtype=torch.int32)
        det = torch.empty((B, chunks, BINS), device=dev)
        for name, fn in libs.items():
            def call():
                rc = fn(qh.data_ptr(), ql.data_ptr(), xh.data_ptr(),
                        xlh.data_ptr(), c1, N, B, f, BINS, DEPTH, chunks,
                        tpc, ps.data_ptr(), pi.data_ptr(), det.data_ptr(),
                        stream)
                if rc != 0:
                    raise SystemExit(f"k1 {name}: launch failed ({rc})")
            line = f"{tag} k1 F={f} {name}: {time_ms(call):.3f} ms"
            if name == "kernel":
                rs, _, rdet = bt.binned_topk_pool_plain(
                    qh, ql, xh, xlh, c1, N, depth=DEPTH, bins=BINS,
                    chunks=chunks)
                err = max(float((ps - rs).abs().max()),
                          float((det - rdet).abs().max()))
                line += f" (max_abs_err vs plain {err:.3e})"
                if err > 1e-5:
                    print(line, flush=True)
                    raise SystemExit("K1 disagrees with its plain version")
            print(line, flush=True)
        del qh, ql, xh, xlh, ps, pi, det
        torch.cuda.empty_cache()


def run_k1bf16(libs, dev, tag: str = "now") -> None:
    """K1's bf16 mode at F = 128, 768 and 1536 (the bf16 sessions'
    widths), B = 2048, 128 bins, depth 3, at the wrapper's chunking, on
    the bf16 operands the sessions make; the bound (2·B·N·F bf16
    operations at 989.4 TFLOP/s) and the corpus bytes every query block
    reads from L2, (B / QB)·N·F·2, with the rate they imply."""
    stream = torch.cuda.current_stream().cuda_stream
    for f in (128, 768, 1536):
        x, gen = clustered(dev, N, f, seed=f)
        xl = torch.rand(N, device=dev, generator=gen) * 0.2
        xh, xlh = bt.prepare_binned_corpus(x, xl, use_bf16=True)
        qh, c1 = operand_query(x[:B] * 1.02, 0.9, torch.float32, xh)
        ql = xl[:B].contiguous()
        del x
        chunks, tpc = chunking(bt.grid_ctas(B, BINS, f, True), dev)
        ps = torch.empty((B, chunks, DEPTH, BINS), device=dev)
        pi = torch.empty_like(ps, dtype=torch.int32)
        det = torch.empty((B, chunks, BINS), device=dev)
        qb = bt.query_block(f, B, True)
        l2 = -(-B // qb) * N * f * 2
        if tag == "now":
            print(f"k1bf16 F={f}: query block {qb}, {bt.bf16_stages(f, qb)} "
                  f"stages, {bt._bintopk_smem(f, qb, True)} shared bytes; "
                  f"bound {2.0 * B * N * f / 989.4e12 * 1e3:.3f} ms "
                  f"(operations); corpus read from L2 {l2 / 1e9:.3f} GB a "
                  "batch", flush=True)
        for name, fn in libs.items():
            def call():
                rc = fn(qh.data_ptr(), ql.data_ptr(), xh.data_ptr(),
                        xlh.data_ptr(), c1, N, B, f, BINS, DEPTH, chunks,
                        tpc, ps.data_ptr(), pi.data_ptr(), det.data_ptr(),
                        stream)
                if rc != 0:
                    raise SystemExit(f"{tag} k1bf16 {name}: launch failed "
                                     f"({rc})")
            ms = time_ms(call)
            line = f"{tag} k1bf16 F={f} {name}: {ms:.3f} ms"
            if name == "kernel":
                rs, _, rdet = bt.binned_topk_pool_plain(
                    qh, ql, xh, xlh, c1, N, depth=DEPTH, bins=BINS,
                    chunks=chunks)
                err = max(float((ps - rs).abs().max()),
                          float((det - rdet).abs().max()))
                line += (f" (max_abs_err vs plain {err:.3e}; L2 corpus "
                         f"reads {l2 / ms / 1e9:.3f} TB/s)")
                if err > 1e-5:
                    print(line, flush=True)
                    raise SystemExit("K1 bf16 disagrees with its plain "
                                     "version")
            print(line, flush=True)
        del qh, ql, xh, xlh, ps, pi, det
        torch.cuda.empty_cache()


# K1's float32 routes at the serving shapes: the glove cell's corpus
# (1,183,514 x 100) and 1M x 128
K1TF32_SHAPES = ((1_183_514, 100), (1_000_000, 128))


def k1tf32_planes(xh):
    """The prepared float32 corpus split as the kernel splits it (hi =
    rna(v), lo = rna(v - hi) to tf32: add 0x1000 to the bits, clear the
    low 13), as one (rows, 2·FP) plane, FP = ceil32(F): hi in columns
    [0, F), lo in [FP, FP + F), zeros elsewhere."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000)
                & -0x2000).view(torch.float32)
    f = xh.shape[1]
    fp = -(-f // 32) * 32
    hi = rna(xh)
    out = torch.zeros(xh.shape[0], 2 * fp, device=xh.device)
    out[:, :f] = hi
    out[:, fp:fp + f] = rna(xh - hi)
    return out


def run_k1tf32(runs, dev) -> None:
    """K1's float32 wgmma route at K1TF32_SHAPES, B = 2048, 128 bins,
    depth 3, on the clustered rows, at the wrapper's chunking; each of
    ``runs`` ((tag, libs, entry): this checkout's variants, the
    mma.sync kernel of this checkout and, with --before, DIR's float32
    K1 as shipped, timed before and after the variants); the wgmma kernel
    held to the plain version and bitwise to the mma.sync kernel, its
    bound (3·2·B·N·F TF32 operations at 494.7 TFLOP/s) and the corpus
    bytes every query block reads from L2, (B / 64)·N·F·4.  The "planes"
    variants read k1tf32_planes of the same corpus, and their pools are
    held bitwise to the kernel's."""
    stream = torch.cuda.current_stream().cuda_stream
    for n, f in K1TF32_SHAPES:
        x, gen = clustered(dev, n, f, seed=f)
        xl = torch.rand(n, device=dev, generator=gen) * 0.2
        xh, xlh = bt.prepare_binned_corpus(x, xl)
        xp = k1tf32_planes(xh)
        qh, c1 = prepare_query(x[:B] * 1.02, 0.9, dtype=torch.float32)
        qh, ql = qh.contiguous(), xl[:B].contiguous()
        del x
        n_tiles = -(-n // BINS)
        tpc = -(-n_tiles // bt._default_chunks(bt.grid_ctas(B, BINS, f),
                                               n_tiles, dev))
        chunks = -(-n_tiles // tpc)
        shape = (B, chunks, DEPTH, BINS)
        outs = {}
        bound = 6.0 * B * n * f / 494.7e12 * 1e3
        l2 = -(-B // 64) * n * f * 4
        boxes = -(-(-(-f // 8) * 8) // 32)
        planes_stages = min(16, (232_448 - 1024 - 2 * boxes * 8192)
                            // (4 * 8192 + 16))
        print(f"k1tf32 N={n} F={f}: {bt.tf32_stages(f)} stages, "
              f"{bt._tf32_smem(f, bt.tf32_stages(f))} shared bytes, "
              f"chunks={chunks}; bound {bound:.3f} ms (operations); corpus "
              f"read from L2 {l2 / 1e9:.3f} GB a batch ({2 * l2 / 1e9:.3f} "
              f"GB in the planes variants, {planes_stages} stages)",
              flush=True)
        order = [r for r in runs if r[0] != "now"] + \
            [r for r in runs if r[0] == "now"] + \
            [r for r in runs if r[0] != "now"]
        for tag, libs, entry in order:
            for name, fn in libs.items():
                ps = torch.empty(shape, device=dev)
                pi = torch.empty(shape, device=dev, dtype=torch.int32)
                det = torch.empty((B, chunks, BINS), device=dev)

                rows = xp if name.startswith("planes") else xh

                def call():
                    rc = fn(qh.data_ptr(), ql.data_ptr(), rows.data_ptr(),
                            xlh.data_ptr(), c1, n, B, f, BINS, DEPTH, chunks,
                            tpc, ps.data_ptr(), pi.data_ptr(), det.data_ptr(),
                            stream)
                    if rc != 0:
                        raise SystemExit(f"{tag} {entry} {name}: launch "
                                         f"failed ({rc})")
                ms = time_ms(call)
                line = f"{tag} {entry} N={n} F={f} {name}: {ms:.3f} ms"
                if name == "planes":
                    outs.setdefault("planes", (ps, pi, det))
                if name == "kernel":
                    outs.setdefault(tag, (ps, pi, det))
                    line += f" ({ms / bound:.2f}x the bound"
                    if entry == ENTRY["k1tf32"]:
                        line += f"; L2 corpus reads {l2 / ms / 1e9:.3f} TB/s"
                    line += ")"
                print(line, flush=True)
        ps, pi, det = outs["now"]
        rs, _, rdet = bt.binned_topk_pool_plain(qh, ql, xh, xlh, c1, n,
                                                depth=DEPTH, bins=BINS,
                                                chunks=chunks)
        err = max(float((ps - rs).abs().max()),
                  float((det - rdet).abs().max()))
        mma = outs["mma.sync"]
        same = all(torch.equal(a, b) for a, b in zip((ps, pi, det), mma))
        planes = all(torch.equal(a, b)
                     for a, b in zip((ps, pi, det), outs["planes"]))
        print(f"k1tf32 N={n} F={f}: max_abs_err vs plain {err:.3e}; pools "
              f"bitwise equal to the mma.sync kernel's: {same}, to the "
              f"planes variant's: {planes}", flush=True)
        if err > 1e-5 or not same or not planes:
            raise SystemExit("K1's wgmma route disagrees with its plain "
                             "version, the mma.sync kernel or its planes "
                             "variant")
        del qh, ql, xh, xlh, xp, outs, mma, ps, pi, det, rs, rdet
        torch.cuda.empty_cache()


def mma_sync_bf16_rows_per_chunk(bsz: int, n: int, sms: int,
                                  k: int) -> int:
    """The chunking of K3's bf16 mode before it had a kernel of its own
    (the float32 kernel's rule on 72-bf16 slices): 64 queries × 64 rows
    a CTA (32 × 128 below 33 queries), two CTAs an SM where their shared
    memory fits."""
    qb = 64 if -(-bsz // 32) * 32 >= 64 else 32
    tr = 4096 // qb
    smem = 2 * (qb + tr) * 144 + 4 * (2 * qb * k + 2 * qb * tr + 3 * qb)
    per_sm = 2 if 2 * (smem + 1024) <= 228 * 1024 else 1
    n_tiles = max(1, -(-n // tr))
    chunks = bt.wave_chunks(-(-bsz // qb), n_tiles, sms * per_sm)
    return -(-n_tiles // chunks) * tr


def time_median_ms(call, reps: int = 25) -> float:
    """Median milliseconds of ``reps`` single launches (CUDA events around
    each), after one warm-up."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def run_k3bf16(runs, dev) -> None:
    """K3's bf16 mode at K3BF16_SHAPES on the bf16 operands the sessions
    make, each of ``runs`` ((tag, libs): this checkout's variants and, with
    --before, the other checkout's kernel, timed before and after them),
    at its own chunking; the kernel held to the plain version, its bound
    (2·B·N·F bf16 operations at 989.4 TFLOP/s) and the L2 bytes of each
    CTA's slices with their rate."""
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    made = None
    for f, bsz, k in K3BF16_SHAPES:
        if made is None or made[0] != f:
            made = None
            torch.cuda.empty_cache()
            x, gen = clustered(dev, N, f, seed=f)
            xl = torch.rand(N, device=dev, generator=gen) * 0.2
            xh, xlh = bt.prepare_binned_corpus(x, xl, use_bf16=True)
            q = x[:B] * 1.02
            del x
            made = (f, xh, xlh, q, xl[:B].contiguous())
        _, xh, xlh, q, ql_all = made
        qh, c1 = operand_query(q[:bsz], 0.9, torch.float32, xh)
        ql = ql_all[:bsz].contiguous()
        resident, stages = tk.merge_bf16_plan(f, k)
        tr = tk.TILE_ROWS
        bound = 2.0 * bsz * N * f / 989.4e12 * 1e3
        shape = f"F={f} B={bsz} k={k}"
        print(f"k3bf16 {shape}: {tr} rows a tile, {stages} stages, "
              f"query block {'resident' if resident else 'streamed'}, "
              f"{tk.merge_smem_bytes(f, k, True)} shared bytes; bound "
              f"{bound:.3f} ms (operations)", flush=True)
        order = [r for r in runs if r[0] == "before"][:1] + \
            [r for r in runs if r[0] == "now"] + \
            [r for r in runs if r[0] == "before"][:1]
        for tag, libs in order:
            if tag == "now":
                rpc = tk.merge_rows_per_chunk(bsz, N, sms)
                qbytes = 0 if resident else bsz * N * f * 2 / tr
                l2 = -(-bsz // 64) * N * f * 2 + qbytes
            else:
                rpc = mma_sync_bf16_rows_per_chunk(bsz, N, sms, k)
                qb = 64 if -(-bsz // 32) * 32 >= 64 else 32
                l2 = -(-bsz // qb) * N * f * 2 + bsz * N * f * 2 / (4096 // qb)
            chunks = -(-N // rpc)
            out_s = torch.empty((bsz, chunks, k), device=dev)
            out_i = torch.empty((bsz, chunks, k), device=dev,
                                dtype=torch.int32)
            for name, fn in libs.items():
                def call():
                    rc = fn(qh.data_ptr(), ql.data_ptr(), xh.data_ptr(),
                            xlh.data_ptr(), c1, N, bsz, f, k, chunks, rpc,
                            out_s.data_ptr(), out_i.data_ptr(), stream)
                    if rc != 0:
                        raise SystemExit(f"{tag} k3bf16 {name}: launch "
                                         f"failed ({rc})")
                ms = time_median_ms(call) if bsz == 1 else time_ms(call)
                line = (f"{tag} k3bf16 {shape} chunks={chunks} {name}: "
                        f"{ms:.3f} ms")
                if name == "kernel":
                    rs, _ = tk.merge_topk_partial_plain(
                        qh, ql, xh, xlh, c1, N, k=k, rows_per_chunk=rpc)
                    err = float((out_s - rs).abs().max())
                    line += (f" (max_abs_err vs plain {err:.3e}; L2 reads "
                             f"{l2 / 1e9:.3f} GB, {l2 / ms / 1e9:.3f} TB/s; "
                             f"{ms / bound:.1f}x the bound)")
                    if err > 1e-5:
                        print(line, flush=True)
                        raise SystemExit("K3 bf16 disagrees with its plain "
                                         "version")
                print(line, flush=True)
            del out_s, out_i
        del qh, ql
    del made
    torch.cuda.empty_cache()


def run_k3tf32(runs, dev) -> None:
    """Float32 K3 at K3TF32_SHAPES (1M clustered rows, B = 2048), each of
    ``runs`` ((tag, libs): this checkout's variants and, with --before,
    the mma.sync kernel of the earlier commits, timed before and after
    them), each kernel at its own chunking (merge_rows_per_chunk,
    mma_sync_rows_per_chunk); the kernel held to the plain version (and
    bitwise to the mma.sync kernel at its chunking), with its ring
    stages, shared bytes, bound (3·2·B·N·F TF32 operations at 494.7
    TFLOP/s) and the L2 bytes of its stages, (B / 64)·(tiles·128 +
    tiles·2·64)·ceil32(F)·4, with the rate they imply."""
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    made = None
    for f, k in K3TF32_SHAPES:
        if made is None or made[0] != f:
            made = None
            torch.cuda.empty_cache()
            made = (f, *k1_inputs(dev, f))
        _, qh, ql, xh, xlh, c1 = made
        stages = tk.merge_tf32_stages(k)
        rpc_w = tk.merge_rows_per_chunk(B, N, sms)
        rpc_m = mma_sync_rows_per_chunk(B, N, sms, k)
        tiles = sum(-(-min(rpc_w, N - r0) // 128) for r0 in range(0, N, rpc_w))
        l2 = -(-B // 64) * tiles * (128 + 2 * 64) * (-(-f // 32) * 32) * 4
        bound = 6.0 * B * N * f / 494.7e12 * 1e3
        shape = f"F={f} B={B} k={k}"
        print(f"k3tf32 {shape}: {stages} stages, "
              f"{tk._tf32_smem(k, stages)} shared bytes, chunks "
              f"{-(-N // rpc_w)} (mma.sync {-(-N // rpc_m)}); bound "
              f"{bound:.3f} ms (operations); L2 reads {l2 / 1e9:.3f} GB a "
              f"batch", flush=True)
        order = [r for r in runs if r[0] != "now"] + \
            [r for r in runs if r[0] == "now"] + \
            [r for r in runs if r[0] != "now"]
        outs = {}
        for tag, libs in order:
            wgmma = tag == "now"
            rpc = rpc_w if wgmma else rpc_m
            chunks = -(-N // rpc)
            out_s = torch.empty((B, chunks, k), device=dev)
            out_i = torch.empty((B, chunks, k), device=dev,
                                dtype=torch.int32)
            extra = ()
            if wgmma:
                planes = torch.empty((2, B, f), device=dev)
                extra = (planes.data_ptr(),)
            for name, fn in libs.items():
                def call():
                    rc = fn(qh.data_ptr(), ql.data_ptr(), xh.data_ptr(),
                            xlh.data_ptr(), c1, N, B, f, k, chunks, rpc,
                            out_s.data_ptr(), out_i.data_ptr(), *extra,
                            stream)
                    if rc != 0:
                        raise SystemExit(f"{tag} k3tf32 {name}: launch "
                                         f"failed ({rc})")
                ms = time_ms(call)
                line = (f"{tag} k3tf32 {shape} chunks={chunks} {name}: "
                        f"{ms:.3f} ms ({ms / bound:.2f}x the bound")
                if wgmma and name == "kernel":
                    outs["now"] = (out_s.clone(), out_i.clone())
                    line += f"; L2 reads {l2 / ms / 1e9:.3f} TB/s"
                print(line + ")", flush=True)
        rs, _ = tk.merge_topk_partial_plain(qh, ql, xh, xlh, c1, N, k=k,
                                            rows_per_chunk=rpc_w)
        err = float((outs["now"][0] - rs).abs().max())
        same = None
        if "mma.sync" in dict(runs):
            ms_s = torch.empty_like(outs["now"][0])
            ms_i = torch.empty_like(outs["now"][1])
            if dict(runs)["mma.sync"]["kernel"](
                    qh.data_ptr(), ql.data_ptr(), xh.data_ptr(),
                    xlh.data_ptr(), c1, N, B, f, k, ms_s.shape[1], rpc_w,
                    ms_s.data_ptr(), ms_i.data_ptr(), stream) != 0:
                raise SystemExit("k3tf32: the mma.sync kernel failed")
            same = (torch.equal(outs["now"][0], ms_s)
                    and torch.equal(outs["now"][1], ms_i))
            del ms_s, ms_i
        print(f"k3tf32 {shape}: max_abs_err vs plain {err:.3e}; scores and "
              f"ids bitwise equal to the mma.sync kernel's: {same}",
              flush=True)
        if err > 1e-5 or same is False:
            raise SystemExit("float32 K3 disagrees with its plain version "
                             "or the mma.sync kernel")
        del outs, rs
    del made
    torch.cuda.empty_cache()


K3GRID_SHAPES = (tuple((bsz, f, 10) for bsz in (1, 16, 32, 63)
                       for f in (128, 768, 1536))
                 + ((1, 768, 100),)
                 + tuple((2048, f, 10) for f in (64, 100, 1537, 4096)))


def mma_sync_rows_per_chunk(bsz: int, n: int, sms: int, k: int) -> int:
    """The chunking of float32 K3's mma.sync kernel (OLD_K3 of the
    commits that had it): 64 queries × 64 rows a CTA (32 × 128 where the
    batch, rounded up to 32, is 32), two CTAs an SM where their shared
    memory fits, at most 64 chunks."""
    qb = 64 if -(-bsz // 32) * 32 >= 64 else 32
    tr = 4096 // qb
    smem = 2 * (qb + tr) * 272 + 4 * (2 * qb * k + 2 * qb * tr + 3 * qb)
    per_sm = 2 if 2 * (smem + 1024) <= 228 * 1024 else 1
    n_tiles = max(1, -(-n // tr))
    chunks = bt.wave_chunks(-(-bsz // qb), n_tiles, sms * per_sm)
    return -(-n_tiles // chunks) * tr


def grid_corpus(dev, f: int, width: int):
    """N clustered unit rows (clustered()'s kind) made on the card in
    blocks, zero-padded to ``width`` features, with their λ and B raw
    queries (rows × 1.02)."""
    gen = torch.Generator(device=dev).manual_seed(f)
    cen = torch.rand(64, f, device=dev, generator=gen) * 0.6 + 0.2
    xh = torch.zeros((N, width), device=dev)
    for r0 in range(0, N, 1 << 16):
        r1 = min(N, r0 + (1 << 16))
        pick = torch.randint(0, 64, (r1 - r0,), device=dev, generator=gen)
        rows = cen[pick] + 0.05 * torch.randn(r1 - r0, f, device=dev,
                                              generator=gen)
        xh[r0:r1, :f] = safe_unit(rows)
    xl = torch.rand(N, device=dev, generator=gen) * 0.2
    return xh, xl, xh[:B, :f] * 1.02


def run_k3grid(now, before, dev) -> None:
    """Float32 K3 (``now``, csrc/merge_topk_tf32.cu) against the mma.sync
    kernel of earlier commits (``before``, their OLD_K3) at K3GRID_SHAPES,
    each at its own chunking: mean ms of 10 launches
    (CUDA events), in turns old, new, new, old; the merged top-k of the
    two held bitwise equal, and their partials at the wgmma chunking.
    The wgmma kernel reads the corpus and queries zero-padded to whole
    16-byte rows, the mma.sync kernel unpadded."""
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    made = None
    for bsz, f, k in sorted(K3GRID_SHAPES, key=lambda s: s[1]):
        width = -(-f // 4) * 4
        if made is None or made[0] != f:
            made = None
            torch.cuda.empty_cache()
            xh, xl, q = grid_corpus(dev, f, width)
            xh_old = xh if width == f else xh[:, :f].contiguous()
            made = (f, xh, xh_old, xl, q)
        _, xh, xh_old, xl, q = made
        qh_old, c1 = prepare_query(q[:bsz], 0.9, dtype=torch.float32)
        qh = torch.nn.functional.pad(qh_old, (0, width - f)).contiguous()
        ql = xl[:bsz].contiguous()
        planes = torch.empty((2, bsz, width), device=dev)
        plans = {"mma.sync": mma_sync_rows_per_chunk(bsz, N, sms, k),
                 "wgmma": tk.merge_rows_per_chunk(bsz, N, sms)}

        def launch(name, rpc):
            chunks = -(-N // rpc)
            s = torch.empty((bsz, chunks, k), device=dev)
            i = torch.empty((bsz, chunks, k), device=dev, dtype=torch.int32)
            if name == "wgmma":
                args = (qh.data_ptr(), ql.data_ptr(), xh.data_ptr(),
                        xl.data_ptr(), c1, N, bsz, width, k, chunks, rpc,
                        s.data_ptr(), i.data_ptr(), planes.data_ptr(),
                        stream)
                fn = now
            else:
                args = (qh_old.data_ptr(), ql.data_ptr(), xh_old.data_ptr(),
                        xl.data_ptr(), c1, N, bsz, f, k, chunks, rpc,
                        s.data_ptr(), i.data_ptr(), stream)
                fn = before

            def call():
                rc = fn(*args)
                if rc != 0:
                    raise SystemExit(f"k3grid {name} B={bsz} F={f} k={k}: "
                                     f"launch failed ({rc})")
            return call, s, i

        ms, outs = {"mma.sync": [], "wgmma": []}, {}
        for name in ("mma.sync", "wgmma", "wgmma", "mma.sync"):
            call, s, i = launch(name, plans[name])
            ms[name].append(time_ms(call, reps=10))
            outs[name] = (s, i)
        merged = {name: two_key_topk(s.reshape(bsz, -1),
                                     i.reshape(bsz, -1).long(), k)
                  for name, (s, i) in outs.items()}
        same_merged = all(torch.equal(a, b) for a, b in
                          zip(merged["mma.sync"], merged["wgmma"]))
        call, s_m, i_m = launch("mma.sync", plans["wgmma"])
        call()
        s_w, i_w = outs["wgmma"]
        same_parts = torch.equal(s_m, s_w) and torch.equal(i_m, i_w)
        rs, _ = tk.merge_topk_partial_plain(qh_old, ql, xh_old, xl, c1, N,
                                            k=k,
                                            rows_per_chunk=plans["wgmma"])
        err = float((s_w - rs).abs().max())
        old, new = (sum(ms[n]) / 2 for n in ("mma.sync", "wgmma"))
        print(f"k3grid B={bsz} F={f} k={k}: mma.sync "
              f"{ms['mma.sync'][0]:.3f} / {ms['mma.sync'][1]:.3f} ms "
              f"({-(-N // plans['mma.sync'])} chunks), wgmma "
              f"{ms['wgmma'][0]:.3f} / {ms['wgmma'][1]:.3f} ms "
              f"({-(-N // plans['wgmma'])} chunks, F read {width}); "
              f"wgmma / mma.sync {new / old:.3f}; merged bitwise equal "
              f"{same_merged}, partials at the wgmma chunking bitwise "
              f"equal {same_parts}; max_abs_err vs plain {err:.3e}",
              flush=True)
        if not (same_merged and same_parts) or err > 1e-5:
            raise SystemExit("k3grid: the two kernels disagree")
        del outs, merged, s_m, i_m, rs, planes
    del made
    torch.cuda.empty_cache()


# --kernels engines: the widths around K1's wgmma limit (operand width
# 352) up to its float32 gate (1264), k of the cells, batches from one
# query to the cells' 2048
ENGINE_WIDTHS = (100, 352, 356, 512, 768, 1024, 1264)
ENGINE_KS = (10, 100)
ENGINE_BATCHES = (1, 16, 64, 2048)


class ClockLog:
    """The card's SM clock (MHz) and power draw (W), sampled by
    nvidia-smi in a thread while the engines run."""

    def __init__(self):
        self.samples, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        cmd = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
               "--format=csv,noheader,nounits"]
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                out = subprocess.run(cmd, capture_output=True,
                                     text=True).stdout
                mhz, watts = (float(v) for v in
                              out.splitlines()[0].split(","))
            except (OSError, IndexError, ValueError):
                return
            self.samples.append(((t0 + time.monotonic()) / 2, mhz, watts))
            self._stop.wait(0.1)

    def over(self, spans) -> str:
        """'MHz / W' averaged over the samples inside ``spans`` ((t0, t1)
        pairs), else the sample nearest their middle."""
        got = [(m, w) for t, m, w in list(self.samples)
               if any(a <= t <= b for a, b in spans)]
        if not got and self.samples:
            mid = sum(a + b for a, b in spans) / (2 * len(spans))
            got = [min(self.samples, key=lambda s: abs(s[0] - mid))[1:]]
        if not got:
            return "clock not read"
        return (f"{sum(m for m, _ in got) / len(got):.0f} MHz "
                f"{sum(w for _, w in got) / len(got):.0f} W")

    def stop(self):
        self._stop.set()
        self._thread.join()


def engine_corpus(dev, f: int):
    """1M clustered rows (clustered()'s kind, made on the card in
    blocks) prepared as a session holds them (prepare_binned_corpus), with
    their λ and ENGINE_BATCHES' largest batch of raw queries (rows ×
    1.02) and query λ."""
    gen = torch.Generator(device=dev).manual_seed(f)
    cen = torch.rand(64, f, device=dev, generator=gen) * 0.6 + 0.2
    raw = torch.empty((N, f), device=dev)
    for r0 in range(0, N, 1 << 16):
        r1 = min(N, r0 + (1 << 16))
        pick = torch.randint(0, 64, (r1 - r0,), device=dev, generator=gen)
        raw[r0:r1] = cen[pick] + 0.05 * torch.randn(r1 - r0, f, device=dev,
                                                    generator=gen)
    xl = torch.rand(N, device=dev, generator=gen) * 0.2
    bmax = max(ENGINE_BATCHES)
    q, ql = raw[:bmax] * 1.02, xl[:bmax].clone()
    xhat, xlam = bt.prepare_binned_corpus(raw, xl)
    return xhat, xlam, q, ql


def engines_agree(got, ref, flags) -> tuple:
    """(rows K1 flagged, whether every unflagged row is bitwise equal,
    the largest score gap on the flagged rows): on a flagged row the ids
    must be equal outside near-ties (within twice that gap, at most
    1e-5)."""
    (gs, gi), (rs, ri) = ((s.float().cpu(), i.long().cpu())
                          for s, i in (got, ref))
    fl = flags.cpu().bool()
    same = torch.equal(gs[~fl], rs[~fl]) and torch.equal(gi[~fl], ri[~fl])
    gap = float((gs[fl] - rs[fl]).abs().max()) if fl.any() else 0.0
    for r in torch.nonzero(fl).flatten().tolist():
        for j in torch.nonzero(gi[r] != ri[r]).flatten().tolist():
            pos = torch.nonzero(ri[r] == gi[r, j]).flatten()
            other = rs[r, pos[0]] if pos.numel() else rs[r, -1]
            if abs(float(other - rs[r, j])) > 2.0 * gap:
                same = False
    return int(fl.sum()), same, gap


def run_engines(dev) -> None:
    """The binned engine (K1 on its route, the flush, the exact repair)
    against the merge engine (K3, the split, the merge) at every
    (ENGINE_WIDTHS, ENGINE_KS, ENGINE_BATCHES) shape on 1M clustered rows,
    each at its own chunking: mean ms of 10 calls (CUDA events) in turns
    binned, merge, merge, binned, the SM clock over each engine's turns,
    and their top-k compared (engines_agree)."""
    clock = ClockLog()
    alpha = 0.9
    try:
        for f in ENGINE_WIDTHS:
            torch.cuda.empty_cache()
            xhat, xlam, q_all, ql_all = engine_corpus(dev, f)
            width = xhat.shape[1]
            for k in ENGINE_KS:
                for bsz in ENGINE_BATCHES:
                    q, ql = q_all[:bsz].contiguous(), ql_all[:bsz].contiguous()
                    eng = br.BinnedTopK(xhat, xlam, alpha, k, prepared=True,
                                        n=N)
                    calls = {
                        "binned": lambda: eng.step(q, ql),
                        "merge": lambda: tk.fused_lambda_topk(
                            q, ql, xhat, xlam, alpha, k=k, prepared=True,
                            n_items=N)}
                    ms = {"binned": [], "merge": []}
                    spans = {"binned": [], "merge": []}
                    for name in ("binned", "merge", "merge", "binned"):
                        t0 = time.monotonic()
                        ms[name].append(time_ms(calls[name], reps=10))
                        spans[name].append((t0, time.monotonic()))
                    s1, i1, flags, det = eng.step(q, ql)
                    fl = flags.cpu().numpy()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rs, ri = eng.repair(q, ql, det, s1.cpu().numpy(),
                                        i1.cpu().numpy(), fl)
                    torch.cuda.synchronize()
                    rep_ms = (time.perf_counter() - t0) * 1e3 \
                        if fl.any() else 0.0
                    got = (torch.as_tensor(rs), torch.as_tensor(ri))
                    ref = calls["merge"]()
                    flagged, same, gap = engines_agree(got, ref, flags)
                    b_ms, m_ms = (sum(ms[n]) / 2 for n in ("binned",
                                                             "merge"))
                    route = ("wgmma" if bt.tf32_route(width, bsz)
                             else "mma.sync")
                    print(f"engines F={f} k={k} B={bsz}: binned (K1 "
                          f"{route}) {ms['binned'][0]:.3f} / "
                          f"{ms['binned'][1]:.3f} ms "
                          f"[{clock.over(spans['binned'])}], repair "
                          f"{rep_ms:.3f} ms host clock ({flagged} rows "
                          f"flagged); merge (K3) {ms['merge'][0]:.3f} / "
                          f"{ms['merge'][1]:.3f} ms "
                          f"[{clock.over(spans['merge'])}]; merge / "
                          f"binned {m_ms / b_ms:.3f}; unflagged rows "
                          f"bitwise equal, flagged rows within near-ties: "
                          f"{same}; flagged rows' score gap {gap:.3e}",
                          flush=True)
                    if not same or gap > 1e-5:
                        raise SystemExit("engines: the binned and merge "
                                         "engines disagree")
                    del eng, calls, s1, i1, flags, det, got, ref
            del xhat, xlam, q_all, ql_all
    finally:
        clock.stop()
    torch.cuda.empty_cache()


def energy_plane(dev, centred: bool):
    """(zq, qn, qlam, zx, xn, xlam) of the smoke's z-plane."""
    x, gen = clustered(dev, N, 128, seed=11)
    proj = torch.randn(128, 64, generator=torch.Generator().manual_seed(11),
                       dtype=torch.float64).to(dev, torch.float32) / 8.0
    z = x @ proj
    zq = (x[:B] * 1.02) @ proj
    lam = torch.rand(N, device=dev, generator=gen) * 0.05
    qlam = lam[:B] + 0.001
    if centred:
        mu = z.mean(dim=0)
        z, zq = z - mu, zq - mu
    zx, xlam, xn = eb.prepare_binned_energy_corpus(z, lam)
    zq = zq.contiguous()
    return zq, (zq * zq).sum(dim=1), qlam.contiguous(), zx, xn, xlam


def energy_errors(kernel, zq, qlam, zx, xlam, out, rows: int = 512) -> str:
    """The kernel's error against float64 over the live pool entries of
    the first ``rows`` queries: K6's scores; K7's d² and u from it."""
    pi = out[1][:rows].reshape(rows, -1)
    live = pi != INT_MAX
    ids = torch.where(live, pi, torch.zeros_like(pi)).long()
    d = zq[:rows].double()[:, None, :] - zx[ids].double()
    d2 = (d * d).sum(-1)
    u = WD / (1.0 + d2.sqrt())
    if kernel == "k6":
        ref = u - WL * (qlam[:rows].double()[:, None]
                        - xlam[ids].double()).abs()
        err = (out[0][:rows].reshape(rows, -1).double() - ref)[live]
        return f"score err vs f64 {float(err.abs().max()):.3e}"
    pd = out[2][:rows].reshape(rows, -1).double()
    d2_err = float((pd - d2)[live].abs().max())
    u_err = float((WD / (1.0 + pd.clamp_min(0).sqrt()) - u)[live].abs().max())
    return f"d2 err vs f64 {d2_err:.3e}, u err {u_err:.3e}"


def run_energy(kernel, libs, dev, tag, centred: bool) -> None:
    zq, qn, qlam, zx, xn, xlam = energy_plane(dev, centred)
    pairs = eb.K6_PAIRS if kernel == "k6" else ea.K7_PAIRS
    chunks, tpc = chunking(eb.energy_grid_ctas(B, BINS, 64, pairs), dev)
    shape = (B, chunks, DEPTH, BINS)
    ps = torch.empty(shape, device=dev)
    pi = torch.empty(shape, device=dev, dtype=torch.int32)
    pd = torch.empty(shape, device=dev)
    det = torch.empty((B, chunks, BINS), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "k7":
        z_s, xn_s = ea.prepare_energy_chord_sample(zx, xn, N)
        ca, cb = ea._fit_chords(zq, qn, z_s, xn_s, WD)
    plane = "centred" if centred else "uncentred"
    for name, fn in libs.items():
        if not centred and name not in ("kernel",) \
                and not name.startswith("partial"):
            continue

        def call():
            if kernel == "k6":
                rc = fn(zq.data_ptr(), qn.data_ptr(), qlam.data_ptr(),
                        zx.data_ptr(), xn.data_ptr(), xlam.data_ptr(), WL,
                        WD, N, B, 64, BINS, DEPTH, chunks, tpc,
                        ps.data_ptr(), pi.data_ptr(), det.data_ptr(), stream)
            else:
                rc = fn(zq.data_ptr(), qn.data_ptr(), qlam.data_ptr(),
                        ca.data_ptr(), cb.data_ptr(), zx.data_ptr(),
                        xn.data_ptr(), xlam.data_ptr(), WL, N, B, 64, BINS,
                        DEPTH, chunks, tpc, ps.data_ptr(), pi.data_ptr(),
                        pd.data_ptr(), det.data_ptr(), stream)
            if rc != 0:
                raise SystemExit(f"{tag} {kernel} {name}: launch failed "
                                 f"({rc})")
        line = (f"{tag} {kernel} {plane} chunks={chunks} {name}: "
                f"{time_ms(call):.3f} ms")
        if name == "kernel" or name.startswith("partial"):
            out = (ps, pi) if kernel == "k6" else (ps, pi, pd)
            line += "; " + energy_errors(kernel, zq, qlam, zx, xlam, out)
        if name == "kernel":
            kw = dict(depth=DEPTH, bins=BINS, chunks=chunks)
            if kernel == "k6":
                rs, _, rdet = eb.binned_energy_pool_plain(
                    zq, qn, qlam, zx, xn, xlam, WL, WD, N, **kw)
            else:
                rs, _, _, rdet = ea.binned_energy_approx_pool_plain(
                    zq, qn, qlam, ca, cb, zx, xn, xlam, WL, N, **kw)
            err = max(float((ps - rs).abs().max()),
                      float((det - rdet).abs().max()))
            line += f"; max_abs_err vs plain {err:.3e}"
            if err > 5e-5 and centred:
                print(line, flush=True)
                raise SystemExit(f"{tag} {kernel} disagrees with its plain "
                                 "version")
        print(line, flush=True)
    del zq, qn, qlam, zx, xn, xlam, ps, pi, pd, det
    torch.cuda.empty_cache()


def build_graph(dev, rows, n: int):
    """The λ-graph of a build over centroid-like rows: 317 of the
    clustered rows (the wide build found 317 clusters), projected to n
    dimensions by the seeded JL projection where n < F, then the
    builder's λ-graph at ε = 1.0 (k = 6, topk = 4, p = 2) over the
    feature rows."""
    cent = rows[torch.randperm(rows.shape[0], device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(317))[:317]]
    if n < rows.shape[1]:
        cent = ImplicitProjection(rows.shape[1], n, seed=11).project_device(
            cent)
    return GraphFactory.build_laplacian_matrix_from_k_cluster(
        cent.double().cpu().numpy(), 1.0, 6, 4, 2.0, None, False, False,
        rows.shape[0], device=dev, dtype=torch.float32).matrix


def dense_graph(dev, n: int):
    gen = torch.Generator(device=dev).manual_seed(n)
    a = torch.rand(n, n, device=dev, generator=gen)
    a = torch.maximum(a, a.T).fill_diagonal_(0.0)
    return torch.diag(a.sum(1)) - a


def lambda_call(kernel, fn, x, lap, tau, lam, tau_out, stream):
    """One launch of K2 (median τ) or K5 on (x, lap[, tau])."""
    ops = [t.contiguous() for t in lb.graph_operands(lap, torch.float32)]
    n_rows, f = x.shape
    n = lap.shape[0]

    def call():
        if kernel == "k5":
            rc = fn(x.data_ptr(), *[t.data_ptr() for t in ops],
                    tau.data_ptr(), n_rows, f, n, lam.data_ptr(), stream)
        else:
            rc = fn(x.data_ptr(), *[t.data_ptr() for t in ops], n_rows, f,
                    n, 0, 0.5, 0.0, lam.data_ptr(), tau_out.data_ptr(),
                    stream)
        if rc != 0:
            raise SystemExit(f"{kernel}: launch failed ({rc})")
    return call


def lambda_errors(kernel, fn, x, lap, tau, stream) -> tuple:
    """(error vs the plain version, vs float64) of one launch: the largest
    |λ - ref| / max(|ref|, 1), as chip_smoke.py measures it."""
    lam = torch.empty(x.shape[0], device=x.device)
    tau_out = torch.empty_like(lam)
    lambda_call(kernel, fn, x, lap, tau, lam, tau_out, stream)()
    ref = lb.lambda_batch_plain(x, lap, tau)
    ref64 = lb.lambda_batch_plain(x.double(), lap.double(), tau.double())
    if kernel == "k2" and not torch.equal(tau_out, tau):
        raise SystemExit("K2's τ differs from the sort's")

    def err(r):
        return float(((lam.double() - r.double()).abs()
                      / r.double().abs().clamp_min(1.0)).max())
    return err(ref), err(ref64)


def run_lambda(kernel, libs, dev, tag: str = "now") -> None:
    """K5 at 688128 x 768, n = 185, or K2 at 262144 and 1M x 128, n = 128,
    on the clustered rows and a build's graph; then each "kernel" on
    65536 cancellation-prone rows (0.5 ± each of CANCEL_SPREADS) over a
    dense graph."""
    stream = torch.cuda.current_stream().cuda_stream
    f, n = (768, 185) if kernel == "k5" else (128, 128)
    rows, _ = clustered(dev, 688128 if kernel == "k5" else N, f, seed=f)
    lap = build_graph(dev, rows, n)
    mode = TauMode.median()
    shapes = [688128] if kernel == "k5" else [262144, N]
    for n_rows in shapes:
        x = rows[:n_rows]
        tau = select_tau_sorted(x, mode).contiguous()
        lam = torch.empty(n_rows, device=dev)
        tau_out = torch.empty_like(lam)
        for name, fn in libs.items():
            call = lambda_call(kernel, fn, x, lap, tau, lam, tau_out, stream)
            line = (f"{tag} {kernel} {n_rows}x{f} n={n} {name}: "
                    f"{time_ms(call):.3f} ms")
            if name in ("kernel", "four_tf32"):
                e, e64 = lambda_errors(kernel, fn, x, lap, tau, stream)
                line += f" (λ err vs plain {e:.3e}, vs float64 {e64:.3e})"
                if e > 1e-5 and name == "kernel":
                    print(line, flush=True)
                    raise SystemExit(f"{kernel} disagrees with its plain "
                                     "version")
            print(line, flush=True)
    del rows
    lap = dense_graph(dev, n)
    for spread in CANCEL_SPREADS:
        gen = torch.Generator(device=dev).manual_seed(5)
        x = 0.5 + spread * (2.0 * torch.rand(65536, f, device=dev,
                                             generator=gen) - 1.0)
        tau = select_tau_sorted(x, mode).contiguous()
        ref = lb.lambda_batch_plain(x, lap, tau).double()
        p64 = float((ref - lb.lambda_batch_plain(
            x.double(), lap.double(), tau.double())).abs().max())
        for name in ("kernel", "four_tf32"):
            if name not in libs:
                continue
            e, e64 = lambda_errors(kernel, libs[name], x, lap, tau, stream)
            print(f"{tag} {kernel} {name} rows 0.5 ± {spread}, dense graph, "
                  f"65536x{f} n={n}: λ err vs plain {e:.3e}, vs float64 "
                  f"{e64:.3e} (plain float32 vs float64 {p64:.3e})",
                  flush=True)
    torch.cuda.empty_cache()


def one_digit_rows(dev, n: int, f: int):
    """Rows whose values are 1.0 plus 0-199 ulps, with one value near
    -3e38 whose sortable int ends in a zero byte: the values share every
    digit of the radix select but the last, so each pass's histogram
    adds collide in one counter."""
    gen = torch.Generator(device=dev).manual_seed(f)
    bits = 0x3F800000 + torch.randint(0, 200, (n, f), device=dev,
                                      generator=gen, dtype=torch.int32)
    bits[:, 0] = (-3.0e38 * torch.ones(1)).view(torch.int32).item() | 0xFF
    return bits.view(torch.float32)


def run_k4(libs, dev, tag: str = "now") -> None:
    """The median τ of the clustered rows at K4_SHAPES, then of the
    one-digit rows at 1M x 128: each variant's mean ms over 20 launches,
    beside the bound (the rows read once, τ written once, at 3.35 TB/s)
    and torch.nanquantile; every variant but range_only must equal the
    sort bitwise."""
    stream = torch.cuda.current_stream().cuda_stream
    mode = TauMode.median()
    planes = [(f"{n}x{f}", lambda n=n, f=f: clustered(dev, n, f, seed=f)[0])
              for n, f in K4_SHAPES]
    planes.append(("one-digit 1000000x128",
                   lambda: one_digit_rows(dev, 1_000_000, 128)))
    for label, make in planes:
        x = make()
        n_rows, f = x.shape
        ref = select_tau_sorted(x, mode)
        out = torch.empty(n_rows, device=dev)
        if tag == "now":
            b_ms = (x.numel() + n_rows) * 4 / 3.35e12 * 1e3
            lib_ms = time_ms(lambda: torch.nanquantile(x, 0.5, dim=1), 3)
            print(f"k4 {label}: bound {b_ms:.3f} ms (bytes), "
                  f"torch.nanquantile {lib_ms:.3f} ms", flush=True)
        for name, fn in libs.items():
            def call():
                return fn(x.data_ptr(), n_rows, f, 0, 0.5, out.data_ptr(),
                          stream)
            if call() != 0:
                if tag != "before":
                    raise SystemExit(f"k4 {name}: launch failed at {label}")
                ms = time_ms(lambda: select_tau_sorted(x, mode), 3)
                print(f"{tag} k4 {label} {name}: refuses F = {f}; the sort "
                      f"its builds take there: {ms:.3f} ms", flush=True)
                continue
            line = f"{tag} k4 {label} {name}: {time_ms(call, 20):.3f} ms"
            if name != "range_only":
                call()
                eq = bool(torch.equal(out, ref))
                line += f" (τ bitwise equal to the sort: {eq})"
                if not eq:
                    print(line, flush=True)
                    raise SystemExit(f"{tag} k4 {name} disagrees with the "
                                     "sort")
            print(line, flush=True)
        del x, ref, out
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="k1,k3tf32,k6,k7,k2,k5")
    ap.add_argument("--before", type=pathlib.Path, default=None,
                    help="csrc directory of another checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    kernels = args.kernels.split(",")
    if "k1" in kernels:
        libs = build("k1", CSRC, K1_VARIANTS, "now")
        if args.before is not None:
            old = build("k1", args.before.resolve(), {"kernel": []},
                        "before")
            compare_sass("k1")
            run_k1(old, dev, "before")
        run_k1(libs, dev)
    if "k1bf16" in kernels:
        libs = build("k1bf16", CSRC, K1BF16_VARIANTS, "now")
        if args.before is not None:
            before = args.before.resolve()
            src = ("bintopk_bf16.cu" if (before / "bintopk_bf16.cu").exists()
                   else "bintopk.cu")
            old = build("k1bf16", before, {"kernel": []}, "before", src)
            if src == "bintopk_bf16.cu":
                compare_sass("k1bf16")
            run_k1bf16(old, dev, "before")
        run_k1bf16(libs, dev)
    if "k1tf32" in kernels:
        runs = [("now", build("k1tf32", CSRC, K1TF32_VARIANTS, "now"),
                 ENTRY["k1tf32"]),
                ("mma.sync", build("k1", CSRC, {"kernel": []}, "mma"),
                 ENTRY["k1"])]
        if args.before is not None:
            before = args.before.resolve()
            runs.append(("before", build("k1", before, {"kernel": []},
                                         "before"), ENTRY["k1"]))
            compare_sass("k1", "mma")
        run_k1tf32(runs, dev)
    if "k3bf16" in kernels:
        runs = [("now", build("k3bf16", CSRC, K3BF16_VARIANTS, "now"))]
        if args.before is not None:
            before = args.before.resolve()
            src = ("merge_topk_bf16.cu"
                   if (before / "merge_topk_bf16.cu").exists()
                   else "merge_topk.cu")
            runs.append(("before", build("k3bf16", before, {"kernel": []},
                                         "before", src)))
        run_k3bf16(runs, dev)
    if "k3grid" in kernels:
        if args.before is None:
            raise SystemExit("k3grid: --before DIR, a csrc with the "
                             f"mma.sync kernel ({OLD_K3}), is required")
        run_k3grid(build("k3tf32", CSRC, {"kernel": []}, "now")["kernel"],
                   build("k3mma", args.before.resolve(), {"kernel": []},
                         "mma", OLD_K3)["kernel"], dev)
    if "engines" in kernels:
        run_engines(dev)
    if "k3tf32" in kernels:
        runs = [("now", build("k3tf32", CSRC, K3TF32_VARIANTS, "now"))]
        if args.before is not None:
            runs.append(("mma.sync", build("k3mma", args.before.resolve(),
                                           {"kernel": []}, "mma", OLD_K3)))
        run_k3tf32(runs, dev)
    for kernel in ("k6", "k7"):
        if kernel not in kernels:
            continue
        runs = [("now", CSRC, TILE_VARIANTS)]
        if args.before is not None:
            runs.append(("before", args.before.resolve(), FOLD_VARIANTS))
        for tag, csrc, table in runs:
            libs = build(kernel, csrc, table, tag)
            for centred in (True, False):
                run_energy(kernel, libs, dev, tag, centred)
    for kernel in ("k2", "k5"):
        if kernel not in kernels:
            continue
        libs = build(kernel, CSRC, LAMBDA_VARIANTS, "now")
        if args.before is not None:
            run_lambda(kernel, build(kernel, args.before.resolve(),
                                     {"kernel": []}, "before"), dev,
                       "before")
        run_lambda(kernel, libs, dev)
    if "k4" in kernels:   # the τ selection: K4, then K2's τ phase
        runs = {"k4": run_k4,
                "k2": lambda libs, dev, tag="now": run_lambda("k2", libs,
                                                              dev, tag)}
        for kernel, run in runs.items():
            libs = build(kernel, CSRC, SELECT_VARIANTS, "now")
            if args.before is not None:
                run(build(kernel, args.before.resolve(), {"kernel": []},
                          "before"), dev, "before")
            run(libs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
