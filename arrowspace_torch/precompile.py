"""Warm a machine for a deployment: build the kernels once and launch
each serving engine once, by shape alone.

Counterpart of ``arrowspace_tpu.precompile``.  The JAX package compiles
one XLA/Mosaic program per shape ahead of time and persists it in a
compile cache.  Here nothing is compiled per shape: the hand-written CUDA
kernels are one library that nvcc builds at first use
(``ops/_build``, into ``arrowspace_torch/_build/``, reused by every later
process of the checkout while the sources are unchanged), and the native
clustering scan likewise (``native``).  What a fresh process still pays
is that build where no library exists, then CUDA's context and each
kernel's first launch (kernels load lazily).  ``warm`` pays them ahead:
it builds both libraries and launches, once, each engine that
``index.session_kernel_kind`` picks for the shape (and, on the binned
engine, the strided repair and K3, its fallback), on zero tensors of
that shape.  Given a τ policy or a graph size, it also launches the λ
engine a build of the shape takes (K2, or K4 then K5, by the build's
gates).  The XLA program list and ``config.setup_cache`` have no
counterpart.

Usage:
    python -m arrowspace_torch.precompile --n 1000000 --f 128
or:
    from arrowspace_torch.precompile import warm
    warm(1_000_000, 128, batch_sizes=(256, 2048), k=10)
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .config import TAUMODE_WINDOW_BYTES, resolve
from .index import check_precision, energy_session_config, \
    session_kernel_kind
from .utils.log import get_logger

logger = get_logger("arrowspace.precompile")

__all__ = ["warm", "warm_energy"]


def _timed(timings: Dict[str, float], name: str, dev, fn) -> None:
    """Run fn once, synchronised, recording its seconds (negative on
    failure, which is logged; the rest keep warming)."""
    t0 = time.perf_counter()
    try:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings[name] = time.perf_counter() - t0
        logger.info("warmed %s in %.2fs", name, timings[name])
    except Exception as e:  # noqa: BLE001 - keep warming the rest
        timings[name] = -1.0
        logger.warning("warming %s failed: %r", name, e)


def _libraries(timings: Dict[str, float], dev) -> None:
    """Build (or find) the CUDA kernel library on a CUDA device, and the
    native clustering scan on any."""
    from . import native
    if dev.type == "cuda":
        from .ops import _build
        _timed(timings, "cuda_library", dev, _build.lib)
    _timed(timings, "native_scan", dev, native.lib)


def _window_rows(n: int, f: int, element_size: int) -> int:
    """Rows of the first window compute_taumode_lambdas runs a corpus
    of n x f in (all n when it fits in one)."""
    if n * f * element_size <= TAUMODE_WINDOW_BYTES:
        return n
    win = TAUMODE_WINDOW_BYTES // (f * element_size)
    return min(n, max(1 << 14, (win >> 14) << 14))


def warm(n_items: int, n_features: int, *,
         batch_sizes: Iterable[int] = (256,), k: int = 10,
         alpha: float = 0.9, precisions: Iterable[str] = ("f32",),
         taumode=None, graph_nodes: Optional[int] = None,
         device=None, dtype=None) -> Dict[str, float]:
    """Build the libraries and launch, once, every engine a serving
    session of an (n_items, n_features) corpus takes at these batch sizes
    and precisions, on zero tensors.  Returns {what: seconds}, named
    ``<engine>_b<batch>_<precision>`` after session_kernel_kind's engine
    ("binned", "merge" or "plain"), plus the binned engine's
    ``repair_<precision>`` (the strided repair and K3 on one row).

    With ``taumode`` (a TauMode; median when only graph_nodes is given)
    or ``graph_nodes`` (the feature graph's nodes, n_features when only
    taumode is given), ``lambda_build`` also times one window of the
    build's λ pass (compute_taumode_lambdas on zero rows against a zero
    graph): K2 where taulambda_fits admits the shape, else τ (K4 by its
    gate) then K5 where its gate admits the graph, as the build takes
    them.  The JAX package's warm compiles its fused τ+λ program by
    default; here it is asked for."""
    from .ops.bin_repair import BinnedTopK
    from .ops.bintopk import bins_target, prepare_binned_corpus
    from .ops.search import batched_lambda_aware_topk
    from .ops.topk import fused_lambda_topk

    dev, dt = resolve(device, dtype)
    n, f = int(n_items), int(n_features)
    k_eff = min(int(k), n)
    timings: Dict[str, float] = {}
    _libraries(timings, dev)
    data = torch.zeros((n, f), device=dev, dtype=dt)
    lam = torch.zeros(n, device=dev, dtype=dt)
    if taumode is not None or graph_nodes is not None:
        from .taumode import TauMode, compute_taumode_lambdas
        mode = taumode if taumode is not None else TauMode.median()
        nodes = int(graph_nodes) if graph_nodes is not None else f
        lap = torch.zeros((nodes, nodes), device=dev, dtype=dt)
        rows = _window_rows(n, f, data.element_size())
        _timed(timings, "lambda_build", dev,
               lambda: compute_taumode_lambdas(data[:rows], lap, mode))
    for prec in precisions:
        want_bf16 = check_precision(prec)
        kind = session_kernel_kind(n, k_eff, f, want_bf16)
        if want_bf16 and kind == "plain":
            continue        # the plain engine serves f32 only
        xh = xl = engine = None
        if kind != "plain":
            xh, xl = prepare_binned_corpus(data, lam, use_bf16=want_bf16)
        if kind == "binned":
            engine = BinnedTopK(xh, xl, alpha, k_eff, prepared=True, n=n)
        for bsz in batch_sizes:
            q = torch.zeros((int(bsz), f), device=dev, dtype=dt)
            ql = torch.zeros(int(bsz), device=dev, dtype=dt)
            if kind == "binned":
                fn = lambda: engine.step(q, ql)  # noqa: E731
            elif kind == "merge":
                fn = lambda: fused_lambda_topk(  # noqa: E731
                    q, ql, xh, xl, alpha, k=k_eff, prepared=True,
                    n_items=n)
            else:
                fn = lambda: batched_lambda_aware_topk(  # noqa: E731
                    q, ql, data, lam, alpha, k=k_eff)
            _timed(timings, f"{kind}_b{bsz}_{prec}", dev, fn)
        if engine is not None:
            q1 = np.zeros((1, f))
            ql1 = torch.zeros(1, device=dev, dtype=dt)

            def repair():
                # one flagged row with one fired bin (the strided repair),
                # then K3 on that row, the repair's overflow fallback
                det = torch.full((1, bins_target(k_eff)), -1.0, device=dev,
                                 dtype=dt)
                det[0, 0] = 1.0
                engine.repair(q1, ql1, det, np.zeros((1, k_eff)),
                              np.arange(k_eff)[None, :],
                              np.ones(1, dtype=bool))
                fused_lambda_topk(torch.as_tensor(q1).to(dev), ql1, xh, xl,
                                  alpha, k=k_eff, prepared=True, n_items=n)
            _timed(timings, f"repair_{prec}", dev, repair)
    return timings


def warm_energy(n_items: int, z_width: int, *,
                batch_sizes: Iterable[int] = (256,), k: int = 10,
                device=None, dtype=None) -> Dict[str, float]:
    """The energy counterpart of warm for a corpus whose z-plane is
    (n_items, z_width): the binned energy engine (K6 and its flush)
    where energy_session_config admits it, and the exact chunked scan
    (below the gate, and the repair's overflow fallback), at the serving
    default weights w_lambda=1.0, w_dirichlet=0.5 (the weights change
    neither the shapes nor the kernels launched).  Returns
    {what: seconds}."""
    from .ops.bin_repair import BinnedEnergyTopK
    from .ops.energy_bintopk import energy_topk_chunked

    dev, dt = resolve(device, dtype)
    n, g = int(n_items), int(z_width)
    k_eff = min(int(k), n)
    timings: Dict[str, float] = {}
    _libraries(timings, dev)
    z = torch.zeros((n, g), device=dev, dtype=dt)
    lam = torch.zeros(n, device=dev, dtype=dt)
    engine = None
    if energy_session_config(n, k_eff, g) == "binned":
        engine = BinnedEnergyTopK(z, lam, 1.0, 0.5, k_eff)
    for bsz in batch_sizes:
        zq = torch.zeros((int(bsz), g), device=dev, dtype=dt)
        ql = torch.zeros(int(bsz), device=dev, dtype=dt)
        if engine is not None:
            _timed(timings, f"energy_binned_b{bsz}", dev,
                   lambda: engine.step(zq, ql))
        _timed(timings, f"energy_chunked_b{bsz}", dev,
               lambda: energy_topk_chunked(zq, ql, z, lam, 1.0, 0.5,
                                           k=k_eff))
    return timings


def main(argv=None) -> int:
    """The CLI; returns 1 when any build or launch failed, else 0."""
    import argparse

    p = argparse.ArgumentParser(
        description="Build the arrowspace-torch kernels and launch each "
                    "serving engine once for a corpus shape")
    p.add_argument("--n", type=int, required=True, help="corpus rows")
    p.add_argument("--f", type=int, required=True, help="feature dim")
    p.add_argument("--batch", type=int, nargs="*", default=[256],
                   help="serving batch sizes")
    p.add_argument("--k", type=int, default=10, help="serving top-k")
    p.add_argument("--precision", nargs="*", default=["f32"],
                   choices=["f32", "bf16"],
                   help="serving session precisions to warm")
    p.add_argument("--energy-g", type=int, default=None,
                   help="also warm the energy-serving engines for this "
                        "z-space width (signals rows G, or F' when no "
                        "signals graph)")
    p.add_argument("--device", default=None,
                   help="device to warm (default: cuda)")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    timings = warm(args.n, args.f, batch_sizes=args.batch, k=args.k,
                   precisions=tuple(args.precision), device=args.device)
    if args.energy_g is not None:
        timings.update(warm_energy(args.n, args.energy_g,
                                   batch_sizes=tuple(args.batch), k=args.k,
                                   device=args.device))
    total = time.perf_counter() - t0
    for name, secs in timings.items():
        print(f"{name}: {'FAILED' if secs < 0 else f'{secs:.2f}s'}")
    print(f"total: {total:.2f}s")
    return 1 if any(secs < 0 for secs in timings.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
