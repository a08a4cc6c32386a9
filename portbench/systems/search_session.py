"""The λτ search deployment of arrowspace_torch: ``ArrowIndex.build`` over
the rows, then a ``SearchSession`` that serves batches through
``search_stream``.

The configuration's ``build`` gives the build's options (``graph``,
``sampling``, ``dims_reduction``, ``rp_eps``) and ``search`` the session's
``k`` and ``alpha``; the traffic mix gives the batch size and depth.
"""

from __future__ import annotations

import importlib
import pkgutil

import numpy as np
import torch


class System:
    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.index = None

    def build(self, rows: np.ndarray, seed: int) -> None:
        from arrowspace_torch import ArrowIndex
        from arrowspace_torch.sampling import SamplerType
        b, g = self.cfg["build"], self.cfg["build"]["graph"]
        self.index = ArrowIndex.build(
            rows, eps=float(g["eps"]), k=int(g["k"]), topk=int(g["topk"]),
            p=float(g["p"]), sigma=g.get("sigma"),
            sampling=SamplerType.simple(float(b["sampling"]["rate"])),
            dims_reduction=bool(b.get("dims_reduction", False)),
            rp_eps=b.get("rp_eps"), seed=int(seed), device=self.device,
            dtype=getattr(torch, self.cfg["dtype"]))

    def session(self, batch_size: int, depth: int, precision: str = "f32"):
        s = self.cfg["search"]
        return self.index.make_search_session(
            batch_size, k=int(s["k"]), alpha=float(s["alpha"]), depth=depth,
            precision=precision)

    def stage_seconds(self) -> dict:
        b = self.index.builder
        out = {f"stage.{k}": v for k, v in b.stage_seconds.items()}
        out.update({f"clustering.{k}": v
                    for k, v in b.clustering_seconds.items()})
        return out

    def resident_rows(self) -> torch.Tensor:
        return self.index.aspace.data

    def state(self) -> dict:
        """Host copies of what the build derived, for the reference."""
        a, gl, b = self.index.aspace, self.index.gl, self.index.builder
        return {"laplacian": gl.matrix.detach().cpu(),
                "item_lambdas": a.lambdas.detach().cpu(),
                "centroids": gl.init_data.T.double().cpu().numpy(),
                "assignments": np.asarray(a.cluster_assignments,
                                          dtype=np.int64),
                "sizes": np.asarray(a.cluster_sizes, dtype=np.int64),
                "cap": int(b.cluster_max_clusters),
                "radius": float(b.cluster_radius)}

    def close(self) -> None:
        self.index = None


def counters() -> dict:
    """The program's launch and call counters (``launches``,
    ``launches_bf16`` and ``calls`` on the functions of
    ``arrowspace_torch.ops``), by ``module.function.counter``."""
    import arrowspace_torch.ops as ops
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, fn in vars(mod).items():
            if not callable(fn) or getattr(fn, "__module__", None) != \
                    mod.__name__:
                continue
            for c in ("launches", "launches_bf16", "calls"):
                v = getattr(fn, c, None)
                if isinstance(v, int):
                    out[f"{info.name}.{name}.{c}"] = v
    return out
