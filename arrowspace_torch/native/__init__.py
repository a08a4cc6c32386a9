"""The seeded clustering scan as a native C++ library (clustering.cpp).

PyTorch-package counterpart of ``arrowspace_tpu.native`` (its
``clustering_native.py``): the ordered incremental scan of
clustering.rs:547-910 in C++, bound with ctypes.  Sampling decisions stay
in Python (the samplers carry seeded RNG state and counters): the simple
sampler's keep decisions and the density-adaptive sampler's uniforms are
drawn here, one per row in row order, exactly as the numpy scan
(``clustering._incremental_clustering_numpy``, the plain version) draws
them.

At ``CERTIFIED_MIN_ROWS`` rows and above the scan runs in blocks: a host
float32 BLAS product of each block against a snapshot of the centroids
only guides the C++ scan, which recomputes one exact float64 distance
per row and certifies it against the snapshot's second-best distance, so
the result is bit-identical to the one-shot scan whatever the product's
rounding.

The library is compiled at first use with the host C++ compiler (``$CXX``,
else ``g++``) into ``arrowspace_torch/_build/`` (git-ignored), under a name
that carries a hash of the source and the flags; concurrent builders
write to a temporary file and ``os.replace`` it.  A library that cannot be
built or loaded raises with the compiler's output: nothing falls back to
the numpy scan.
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

import numpy as np

__all__ = ["CERTIFIED_MIN_ROWS", "build", "lib",
           "native_incremental_clustering"]

SOURCE = pathlib.Path(__file__).resolve().parent / "clustering.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
# The JAX package's Makefile flags, with contraction off (clustering.cpp)
FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-ffp-contract=off",
         "-shared")

# Above this many rows the scan runs the certified-snapshot blocked
# variant (incremental_clustering_certified_block in clustering.cpp).
CERTIFIED_MIN_ROWS = 32768
_CERT_BLOCK = 8192

_D = ctypes.POINTER(ctypes.c_double)
_LL = ctypes.POINTER(ctypes.c_longlong)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_N = ctypes.c_longlong
SIGNATURES = {
    # rows, n, f, max_clusters, radius, keep mask or NULL, out centroids,
    # out counts, out assignments (-1 = dropped)
    "incremental_clustering": (_D, _N, _N, _N, ctypes.c_double, _U8, _D,
                               _LL, _LL),
    # rows, n, f, max_clusters, radius, uniforms, base_rate, out
    # centroids, out counts, out assignments, out kept
    "incremental_clustering_density": (_D, _N, _N, _N, ctypes.c_double, _D,
                                       ctypes.c_double, _D, _LL, _LL, _LL),
    # rows_block, bn, f, s2_safe, bidx, n_snap, max_clusters, radius,
    # keep mask or NULL, uniforms or NULL, base_rate, centroids, counts,
    # assign_block, m_scratch, inout n_c, out kept, out fallbacks
    "incremental_clustering_certified_block": (
        _D, _N, _N, _D, _LL, _N, _N, ctypes.c_double, _U8, _D,
        ctypes.c_double, _D, _LL, _LL, _D, _LL, _LL, _LL),
}


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libarrowspace_native_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile clustering.cpp unless an up-to-date library exists."""
    out = _library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native clustering scan needs a C++ compiler "
                           "(set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, out.name)
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native clustering scan failed "
                f"({cxx}, exit {proc.returncode}):\n{proc.stdout}"
                f"{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_longlong
    return handle


def _certified_scan(x, nfeatures, max_clusters, radius, keep_mask,
                    uniforms, base_rate):
    """The blocked certified-snapshot scan.  Returns (n_c, centroids,
    counts, assignments, kept rows, fallbacks)."""
    n = x.shape[0]
    cent = np.zeros((max_clusters, nfeatures), dtype=np.float64)
    counts = np.zeros(max_clusters, dtype=np.int64)
    assign = np.full(n, -1, dtype=np.int64)
    assign_block = np.empty(_CERT_BLOCK, dtype=np.int64)
    m_scratch = np.empty(max_clusters, dtype=np.float64)
    n_c, kept, fallbacks = (ctypes.c_longlong(0) for _ in range(3))
    kept_total = 0

    pos = 0
    while pos < n:
        end = min(pos + _CERT_BLOCK, n)
        if keep_mask is not None:
            # dropped rows never touch state: compact the block to its
            # kept rows, as the one-shot scan skips their distances
            kept_idx = np.nonzero(keep_mask[pos:end])[0]
            if kept_idx.size == 0:
                pos = end
                continue
            block = np.ascontiguousarray(x[pos:end][kept_idx])
        else:
            kept_idx = None
            block = np.ascontiguousarray(x[pos:end])
        bn = block.shape[0]
        n_snap = n_c.value
        if n_snap > 0:
            # The snapshot product only guides the scan (candidate and
            # certificate margin); every accepted distance is recomputed
            # in float64, so float32 suffices: its rounding is absorbed by
            # the safety margin eps (a wider margin means at worst more
            # exact-scan fallbacks, never another result).
            block32 = block.astype(np.float32)
            snap32 = cent[:n_snap].astype(np.float32)
            rowsq = np.einsum("ij,ij->i", block32, block32)
            centsq = np.einsum("ij,ij->i", snap32, snap32)
            d2 = rowsq[:, None] - 2.0 * block32 @ snap32.T + centsq[None, :]
            np.maximum(d2, 0.0, out=d2)
            bidx = np.ascontiguousarray(np.argmin(d2, axis=1),
                                        dtype=np.int64)
            if n_snap >= 2:
                s2sq = np.partition(d2, 1, axis=1)[:, 1].astype(np.float64)
            else:
                s2sq = np.full(bn, np.inf)
            # float32 summation error of the expanded form is about
            # f·2⁻²⁴·(|r|² + |c|²); 1e-4 of that scale is far above it
            eps = 1e-4 * (rowsq.astype(np.float64) + float(centsq.max())
                          + 1.0)
            s2_safe = np.ascontiguousarray(
                np.sqrt(np.maximum(s2sq - eps, 0.0)))
        else:
            bidx = np.zeros(bn, dtype=np.int64)
            s2_safe = np.zeros(bn, dtype=np.float64)
        m_scratch[:] = 0.0
        u = None if uniforms is None else \
            np.ascontiguousarray(uniforms[pos:end])
        consumed = int(lib().incremental_clustering_certified_block(
            block.ctypes.data_as(_D), bn, nfeatures,
            s2_safe.ctypes.data_as(_D), bidx.ctypes.data_as(_LL), n_snap,
            max_clusters, radius, _U8(),  # masked rows are compacted away
            _D() if u is None else u.ctypes.data_as(_D), base_rate,
            cent.ctypes.data_as(_D), counts.ctypes.data_as(_LL),
            assign_block.ctypes.data_as(_LL), m_scratch.ctypes.data_as(_D),
            ctypes.byref(n_c), ctypes.byref(kept), ctypes.byref(fallbacks)))
        if consumed <= 0:
            raise RuntimeError("native clustering: a block consumed no row")
        kept_total += int(kept.value)
        if kept_idx is None:
            assign[pos:pos + consumed] = assign_block[:consumed]
            pos += consumed
        else:
            assign[pos + kept_idx[:consumed]] = assign_block[:consumed]
            # resume at the first kept row the block did not consume
            pos = end if consumed == bn else pos + int(kept_idx[consumed])
    return (n_c.value, cent, counts, assign, kept_total,
            int(fallbacks.value))


def native_incremental_clustering(builder, rows, nfeatures, max_clusters,
                                  radius, sampler):
    """The ordered incremental scan.  Returns (centroids X×F, assignments
    as an int64 array with -1 for dropped rows, sizes), and draws from
    ``sampler`` what the numpy scan would.  Raises RuntimeError when no
    cluster was created, as the numpy scan does."""
    x = np.ascontiguousarray(np.asarray(rows, dtype=np.float64))
    n = x.shape[0]
    density = builder.sampling is not None and \
        builder.sampling.kind == "density_adaptive"
    keep = uniforms = None
    if density:
        uniforms = np.ascontiguousarray(sampler._rng.random(n))
    elif builder.sampling is not None:
        keep = np.ascontiguousarray(
            (sampler._rng.random(n) < sampler.keep_rate).astype(np.uint8))
        sampler.sampled_count += int(keep.sum())
        sampler.discarded_count += int(n - keep.sum())

    if n >= CERTIFIED_MIN_ROWS:
        n_c, cent, counts, assign, kept, _ = _certified_scan(
            x, nfeatures, max_clusters, radius, keep, uniforms,
            sampler.base_rate if density else 0.0)
    else:
        cent = np.zeros((max_clusters, nfeatures), dtype=np.float64)
        counts = np.zeros(max_clusters, dtype=np.int64)
        assign = np.full(n, -1, dtype=np.int64)
        outs = (cent.ctypes.data_as(_D), counts.ctypes.data_as(_LL),
                assign.ctypes.data_as(_LL))
        if density:
            kept_c = ctypes.c_longlong(0)
            n_c = lib().incremental_clustering_density(
                x.ctypes.data_as(_D), n, nfeatures, max_clusters, radius,
                uniforms.ctypes.data_as(_D), sampler.base_rate, *outs,
                ctypes.byref(kept_c))
            kept = int(kept_c.value)
        else:
            n_c = lib().incremental_clustering(
                x.ctypes.data_as(_D), n, nfeatures, max_clusters, radius,
                _U8() if keep is None else keep.ctypes.data_as(_U8), *outs)
    if density:
        sampler.sampled_count += kept
        sampler.discarded_count += n - kept
        sampler.current_idx += n
    if n_c <= 0:
        desc = str(builder.sampling) if builder.sampling else "None"
        raise RuntimeError(f"No clusters created from data, sampling: {desc}")
    return cent[:n_c].copy(), assign, counts[:n_c].tolist()
