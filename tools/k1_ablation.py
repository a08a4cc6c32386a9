#!/usr/bin/env python3
"""Ablation of K1 (arrowspace_torch/csrc/bintopk.cu) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/k1_ablation.py

Where no kernel profiler can be used, this is the way to see what bounds
K1: it compiles copies of the kernel's source with one part taken out
(by text substitution; every substitution must match, or the script
fails) and times each copy on the same inputs at the serving shapes:
1,000,000 clustered unit rows at F = 128 and F = 768, B = 2048 α-scaled
queries, 128 bins, depth 3, the wrapper's chunk count.  A variant with a
part removed computes garbage; only the shipped kernel ("kernel") is
checked, against the plain version.  Output: the card's name and power
limit, each variant's registers (ptxas), then one line per (F, variant)
with its mean milliseconds over 5 launches (CUDA events, after one
warm-up).  Build outputs go to arrowspace_torch/_build/ablation/.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from arrowspace_torch.ops import bintopk as bt  # noqa: E402
from arrowspace_torch.ops._build import (CSRC, SIGNATURES,  # noqa: E402
                                         _nvcc)
from arrowspace_torch.ops.search import prepare_query  # noqa: E402

OUT = ROOT / "arrowspace_torch" / "_build" / "ablation"
PRODUCT = ("mma_kstep(part, qa + kk, QS, xb + kk);", "(void)0;")
FOLD = ("if (gr < a.n) {", "if (gr < a.n && a.c1 > 1e30f) {")
STAGING = ("    if (step + 1 < steps) {\n      const bool wrap",
           "    if (false) {\n      const bool wrap")
VARIANTS = {
    "kernel": [],
    "no_fold": [FOLD],
    "no_staging": [STAGING],
    "no_product": [PRODUCT],
    "product_only": [STAGING, FOLD],
    "staging_only": [PRODUCT, FOLD],
    "one_tf32": [("    mma_tf32(acc[j], alo, bhi0, bhi1);\n"
                  "    mma_tf32(acc[j], ahi, blo0, blo1);\n", "")],
    # lo passed unrounded: the tensor core then reads its top 19 bits
    "lo_truncated": [("  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));",
                      "  lo = __float_as_uint(__fsub_rn(v, "
                      "__uint_as_float(hi)));")],
}


def build() -> dict:
    src = (CSRC / "bintopk.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) < 1:
                raise SystemExit(f"{name}: substitution {old!r} not found")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas", "-v", "-I", str(CSRC), "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"bintopk_kernelILi3ELi(\d+)EE\S*' for "
                          r"'sm_90a'\n(?:.*\n){2}.*?Used (\d+) registers",
                          log)
        print(f"{name}: registers (depth 3) by query block: "
              + ", ".join(f"{qb}: {r}" for qb, r in sorted(regs)),
              flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.asp_bintopk.argtypes = list(SIGNATURES["asp_bintopk"])
        lib.asp_bintopk.restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(dev, n: int, f: int, b: int, seed: int):
    """chip_smoke.py's corpus kind, made on the card: 64 centres in
    [0.2, 0.8], noise 0.05; queries are corpus rows ×1.02, α = 0.9."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cen = torch.rand(64, f, device=dev, generator=gen) * 0.6 + 0.2
    pick = torch.randint(0, 64, (n,), device=dev, generator=gen)
    x = cen[pick] + 0.05 * torch.randn(n, f, device=dev, generator=gen)
    xl = torch.rand(n, device=dev, generator=gen) * 0.2
    xh, xlh = bt.prepare_binned_corpus(x, xl)
    qh, c1 = prepare_query(x[:b] * 1.02, 0.9, dtype=torch.float32)
    return qh.contiguous(), xl[:b].contiguous(), xh, xlh, c1


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    libs = build()
    dev = torch.device("cuda", 0)
    n, b, bins, depth = 1_000_000, 2048, 128, 3
    for f in (128, 768):
        qh, ql, xh, xlh, c1 = inputs(dev, n, f, b, seed=f)
        n_tiles = -(-n // bins)
        chunks = bt._default_chunks(bt.grid_ctas(b, bins, f), n_tiles, dev)
        tpc = -(-n_tiles // chunks)
        chunks = -(-n_tiles // tpc)
        shape = (b, chunks, depth, bins)
        ps = torch.empty(shape, device=dev)
        pi = torch.empty(shape, device=dev, dtype=torch.int32)
        det = torch.empty((b, chunks, bins), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            def call():
                rc = lib.asp_bintopk(
                    qh.data_ptr(), ql.data_ptr(), xh.data_ptr(),
                    xlh.data_ptr(), c1, n, b, f, bins, depth, chunks, tpc,
                    ps.data_ptr(), pi.data_ptr(), det.data_ptr(), stream)
                if rc != 0:
                    raise SystemExit(f"{name}: launch failed ({rc})")
            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                call()
            end.record()
            end.synchronize()
            line = f"F={f} {name}: {start.elapsed_time(end) / 5:.3f} ms"
            if name == "kernel":
                rs, _, rdet = bt.binned_topk_pool_plain(
                    qh, ql, xh, xlh, c1, n, depth=depth, bins=bins,
                    chunks=chunks)
                err = max(float((ps - rs).abs().max()),
                          float((det - rdet).abs().max()))
                line += f" (max_abs_err vs plain {err:.3e})"
                if err > 1e-5:
                    print(line, flush=True)
                    raise SystemExit("the kernel disagrees with its plain "
                                     "version")
            print(line, flush=True)
        del qh, ql, xh, xlh, ps, pi, det
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
