"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything a cell needs is found by name: its configuration file (the
``file`` of its entry in BENCHMARK.json), its traffic mix
(``portbench/traffic/<traffic>.json``) and the loop of its kind
(``portbench/loops/<kind>.py``), the configuration's data generator,
system adapter and plain reference (``portbench/generators/<kind>.py``,
``portbench/systems/<system>.py``, ``portbench/references/<reference>.py``)
and one reader per metric (``portbench/metrics/<name>.py``, else the file
named by the part of the name before its first dot, so that one quantity
split by cell needs no file of its own: a function ``read(record)`` that
returns a number, or None where it finds nothing to read).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "arrowspace_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec: dict, root: Path, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic_of(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def reader(metric: str):
    """The ``read`` function of portbench/metrics/<metric>.py, or of the
    file named by the part of ``metric`` before its first dot."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, cell: str, traced: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``traced`` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that this process must not hold,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_ready(chips: int) -> bool:
    import torch
    return torch.cuda.is_available() and torch.cuda.device_count() >= chips


def point_caches(root: Path) -> None:
    """Keep every cache a run may write inside the checkout, at fixed
    paths (the kernels themselves build into arrowspace_torch/_build)."""
    base = root / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def pool_size(cfg: dict, mix: dict) -> int:
    """Queries in the pool: as many whole batches of float32 rows as the
    mix's pool_bytes holds."""
    n = int(mix["pool_bytes"]) // (4 * int(cfg["features"]))
    return n - n % int(mix["batch"])


def run_cell(spec: dict, root: Path, workload: str, seed: int,
             seconds: float, traced: bool, t_start: float, device="cuda",
             cfg_override=None, traffic_override=None, control=False,
             breaker=None) -> dict:
    """Set up, serve for ``seconds``, check; returns the result object
    (``checks`` last).  ``cfg_override`` and ``traffic_override`` update
    the files' values (tests run tiny cells on the CPU with them);
    ``control`` adds each control's numbers and verdict under
    ``control``;
    ``breaker(session)`` may wrap the session the window drives (the
    tests' planted faults)."""
    import numpy as np
    import torch

    from . import trace

    cell = cell_of(spec, workload)
    cfg = config_of(spec, root, cell["config"])
    cfg.update(cfg_override or {})
    mix = traffic_of(cell["traffic"])
    mix.update(traffic_override or {})
    generator = importlib.import_module(
        f"portbench.generators.{cfg['generator']['kind']}")
    loop = importlib.import_module(f"portbench.loops.{mix['kind']}")
    system_mod = importlib.import_module(f"portbench.systems.{cfg['system']}")
    reference = importlib.import_module(
        f"portbench.references.{cfg['reference']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # set-up: data, build, session, warm-up
    batch = int(mix["batch"])
    n_pool = pool_size(cfg, mix)
    with trace.span("data"):
        rows_d, queries_d = generator.make(cfg, seed, dev, n_pool)
        rows = rows_d.cpu().numpy().astype(np.float64)
        pool = queries_d.cpu().numpy()
        del rows_d, queries_d
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    system = system_mod.System(cfg, dev)
    with trace.span("build"):
        t = time.perf_counter()
        system.build(rows, seed)
        sync()
        build_s = time.perf_counter() - t
    with trace.span("session"):
        session = system.session(batch, int(mix.get("depth", 2)))
    with trace.span("warmup"):
        session.warmup()
        sync()
    tracer = trace.Tracer(traced, cuda)
    tracer.warm(sync)
    # the set-up's objects (modules, the pool, the build's host arrays)
    # are no garbage of the served path: keep the collector from
    # scanning them in the window, as a long-running server would
    gc.collect()
    gc.freeze()
    before = system_mod.counters()
    setup_s = time.perf_counter() - t_start

    # the measured window
    driven = breaker(session) if breaker is not None else session
    window = loop.run(driven, pool, mix, seconds, seed, tracer, sync, log)
    sync()
    gc.unfreeze()
    tracer.finish()
    after = system_mod.counters()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    stage = system.stage_seconds()

    # the check, once the program's state is freed
    with trace.span("check"):
        state = system.state()
        log(f"build: {len(state['sizes'])} clusters; seconds {stage}")
        state["data_mismatch"] = reference.data_mismatch(
            system.resident_rows(), rows)
        control_bf16 = None
        if control:
            ctl = system.session(batch, int(mix.get("depth", 2)), "bf16")
            served = window["served"]
            q = pool[served["query_rows"]]
            s_b, i_b = [], []
            for b0 in range(0, q.shape[0], batch):
                (sb, ib), = ctl.search_stream([q[b0:b0 + batch]])
                s_b.append(sb)
                i_b.append(ib)
            control_bf16 = {"query_rows": served["query_rows"],
                            "scores": np.concatenate(s_b),
                            "ids": np.concatenate(i_b)}
            del ctl
        del session, driven
        system.close()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        numbers = reference.check(cfg, seed, rows, pool, state,
                                  window["served"], dev)
        extra = {}
        if control:
            extra["tf32"] = reference.check(cfg, seed, rows, pool, state,
                                            window["served"], dev,
                                            control=True)
            extra["bf16"] = reference.check(cfg, seed, rows, pool, state,
                                            control_bf16, dev)
    if window.get("latency_s"):
        lat = np.array(window["latency_s"]) * 1e3
        log(f"latency ms: p50 {np.percentile(lat, 50):.4f} p95 "
            f"{np.percentile(lat, 95):.4f} p99 {np.percentile(lat, 99):.4f}"
            f" max {lat.max():.4f} over {lat.size} requests")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules that must not load were loaded: {found}")

    checks, correct = verdict(numbers, cfg["limits"], reference.NUMBERS,
                              window["failed"])
    record = {"cell": cell, "config": cfg, "traffic": mix,
              "setup_s": setup_s, "build_s": build_s, "stages": stage,
              "window": window, "trace": tracer.result,
              "counters": {k: after[k] - before.get(k, 0) for k in after},
              "device_kind": torch.cuda.get_device_name(dev) if cuda
              else "cpu", "seed": seed}
    metrics = {}
    for m in metrics_of(spec, workload, traced):
        v = reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": record["device_kind"],
                   "count": int(cell["chips"]) if cuda else 0,
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(window["requests"]),
           "failed": int(window["failed"]), "metrics": metrics,
           "device": device_info}
    if cuda and tracer.result is not None:
        device_info["busy_s"] = tracer.result["busy_s"]
        device_info["window_s"] = tracer.result["window_s"]
        out["breakdown"] = {"device_ops": tracer.result["device_ops"],
                            "idle_gaps": tracer.result["idle_gaps"]}
    if control:
        out["control"] = {}
        for name, v in extra.items():
            c_checks, c_correct = verdict(v, cfg["limits"], reference.NUMBERS,
                                          window["failed"])
            out["control"][name] = {"correct": c_correct, "checks": c_checks}
    out["counters"] = record["counters"]
    out["checks"] = checks
    return out


def verdict(numbers: dict, limits: dict, names, failed: int) -> tuple:
    """(each compared number beside its limit, whether the run is
    correct: every number within its limit and no request failed)."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in names}
    return checks, bool(failed == 0 and all(
        v["value"] <= v["limit"] for v in checks.values()))


def report(out: dict) -> None:
    """Print the compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard
    output."""
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        log(f"check {name} = {c['value']!r} limit {c['limit']!r} {ok}")
    print(json.dumps(out), flush=True)

