"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use, into
``arrowspace_torch/_build/`` (git-ignored): one ``nvcc -c`` per source,
all started together, then one link.  The library name carries a
hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  Python binds it with ``ctypes``: every pointer
and the stream are ``c_void_p``, and every entry point returns
``cudaGetLastError()`` after its launch, which ``check`` turns into an
exception.

Nothing here runs at import: the CPU tests import every module and this
machine need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["build", "lib", "check", "stream_of"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("bintopk.cu", "bintopk_bf16.cu", "bintopk_tf32.cu",
           "merge_topk_bf16.cu", "merge_topk_tf32.cu", "taulambda.cu",
           "select_tau.cu", "lambda_batch.cu", "energy_bintopk.cu",
           "energy_chord.cu")
HEADERS = ("common.cuh", "binned_fold.cuh", "hopper.cuh", "merge_select.cuh",
           "energy_tile.cuh", "lambda_tile.cuh")
# -Xptxas -v reports each kernel's registers, shared memory and spills
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
SIGNATURES = {
    # qhat, qlam, xhat, xlam, c1, n, B, F, bins, depth, n_chunks,
    # tiles_per_chunk, pool_s, pool_i, det, stream
    "asp_bintopk": (_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P),
    # the same with bf16 qhat and xhat
    "asp_bintopk_bf16": (_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P),
    # F, B, depth, out[6]: the bf16 kernel's query block, stages, shared
    # bytes, registers, spilled bytes and largest block at that launch
    "asp_bintopk_bf16_config": (_I, _I, _I, _P),
    # the same with float32 qhat and xhat, K1's wgmma route
    "asp_bintopk_tf32": (_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P),
    # F, depth, out[6]: the same account of the wgmma route's launch
    "asp_bintopk_tf32_config": (_I, _I, _P),
    # qhat, qlam, xhat, xlam, c1, n, B, F, k, n_chunks, rows_per_chunk,
    # out_s, out_i, stream: K3 on bf16 qhat and xhat
    "asp_merge_topk_bf16": (_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P),
    # F, k, out[8]: the bf16 kernel's query block, tile rows, stages,
    # shared bytes, registers, spilled bytes, query residency and CTAs an
    # SM at that launch
    "asp_merge_topk_bf16_config": (_I, _I, _P),
    # the arguments of asp_merge_topk_bf16 on float32 qhat and xhat, then
    # planes (a float32 workspace of 2·B·F values, the split queries),
    # stream: float32 K3
    "asp_merge_topk_tf32": (_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P),
    # F, k, out[7]: the float32 kernel's query block, tile rows,
    # stages, shared bytes, registers, spilled bytes and CTAs an SM
    "asp_merge_topk_tf32_config": (_I, _I, _P),
    # x, L, W, W2, d_r, d_c, d2_r, d2_c, N, F, n, kind, pct, fixed,
    # lam_out, tau_out, stream
    "asp_taulambda": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _F, _F, _P, _P, _P),
    # cols, row_scalars -> shared bytes of a K2 or K5 CTA
    "asp_lambda_tile_bytes": (_I, _I),
    # x, N, F, kind, pct, tau_out, stream
    "asp_select_tau": (_P, _L, _I, _I, _F, _P, _P),
    # x, L, W, W2, d_r, d_c, d2_r, d2_c, tau, N, F, n, lam_out, stream
    "asp_lambda_batch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _P, _P),
    # zq, qn, qlam, zx, xn, xlam, wl, wd, n, B, G, bins, depth, n_chunks,
    # tiles_per_chunk, pool_s, pool_i, det, stream
    "asp_energy_bintopk": (_P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I,
                           _I, _I, _I, _P, _P, _P, _P),
    # x, out, n, stream
    "asp_rsqrt_probe": (_P, _P, _L, _P),
    # zq, qn, qlam, ca, cb, zx, xn, xlam, wl, n, B, G, bins, depth,
    # n_chunks, tiles_per_chunk, pool_s, pool_i, pool_d, det, stream
    "asp_energy_chord": (_P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                         _I, _I, _I, _I, _P, _P, _P, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libarrowspace_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile the kernels unless an up-to-date library exists: one
    ``nvcc -c`` per source, all running at once, then one link.
    Returns (library path, compiler output; empty when reused)."""
    out = _library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *FLAGS, "-I", str(CSRC), "-c", "-o", obj,
             str(CSRC / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs, failed = [], []
        for src, proc in zip(SOURCES, procs):
            text, _ = proc.communicate()
            logs.append(text)
            if proc.returncode != 0:
                failed.append(f"{src} ({proc.returncode}):\n{text}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)
    return out, "".join(logs) + link.stdout + link.stderr


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    handle = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return handle


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_of(t: torch.Tensor) -> int:
    """The current stream of t's device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream
