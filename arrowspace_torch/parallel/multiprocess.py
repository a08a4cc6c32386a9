"""Multi-process runtime on ``torch.distributed``: the dcn layer.

PyTorch counterpart of ``arrowspace_tpu.parallel.multiprocess``.  The
reference is strictly single-process; the JAX package adds a process
layer so the (dcn, ici) mesh can span hosts.  Here:

* ``init_distributed`` joins this process to the default process group
  (``nccl`` for a mesh of CUDA devices, ``gloo`` on the CPU) over a TCP
  rendezvous; a failed init raises.  After it, every mesh made in this
  process spans the group's processes.
* ``local_row_range`` / ``make_sharded_corpus``: the per-process corpus
  ingestion contract.  Each process loads only its contiguous row slice
  and holds it as its local shards; no process materialises the full
  corpus.
* the collectives the distributed functions use: ``gather_columns``
  (candidates and det planes, ``all_gather_into_tensor`` across
  processes), ``all_gather_rows``, ``all_reduce_max`` (flags, the JAX
  package's ``pmax``) and ``all_reduce_sum`` (the clustering's grouped
  sums, ``psum``).  In one process each is a concatenation or reduction
  in shard order on the mesh's first device.
* ``put_global`` / ``ensure_global`` place a value every process holds
  identically: rows split into the mesh's shards (``shard_rows``), or
  one replicated copy on the mesh's first device.  JAX needed them to
  build global arrays from process-local pieces; here a ShardedTensor
  holds only local shards and replicated operands are plain tensors, so
  they are thin conveniences.

Execution model, as in the JAX package: every process runs the same
host driver code.  Results the host bookkeeping reads are gathered to
every process, so all processes apply the same deterministic host rules
to identical inputs and stay in lockstep; multi-process builds therefore
need a seeded builder when inline sampling is on (enforced in
``distributed_build_step``).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from .mesh import (ItemsSharding, Mesh, ReplicatedSharding, ShardedTensor,
                   shard_rows, world)

__all__ = ["init_distributed", "is_multiprocess", "put_global",
           "ensure_global", "local_row_range", "make_sharded_corpus",
           "run_cpu_multiprocess_dryrun", "run_multiprocess_dryrun",
           "gather_columns", "all_gather_rows", "all_reduce_max",
           "all_reduce_sum"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> None:
    """Join the default process group: ``coordinator_address``
    ("host:port", e.g. "localhost:29500") with ``num_processes`` and this
    process's ``process_id``, or, with no arguments, the standard
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK variables.  The
    backend is ``nccl`` when ``device`` (the mesh's devices) is CUDA,
    else ``gloo``.  A no-op when already initialised; a failed init
    raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def is_multiprocess() -> bool:
    return world()[1] > 1


def put_global(x, sharding):
    """A value every process holds identically, placed under
    ``sharding``: rows split into the mesh's shards (items_sharding,
    this process keeping its own), or one copy on the mesh's first
    device (replicated_sharding).  A ShardedTensor passes through."""
    if isinstance(x, ShardedTensor):
        return x
    if isinstance(sharding, ItemsSharding):
        return shard_rows(x, sharding.mesh)
    assert isinstance(sharding, ReplicatedSharding), sharding
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(sharding.mesh.first_device)


def ensure_global(x, sharding):
    """put_global for corpus-sized operands: a multi-process caller
    passes a ShardedTensor (make_sharded_corpus); a full host value is
    split here, which makes sense in one process or in tests."""
    return put_global(x, sharding)


def local_row_range(sharding, n_global: int) -> Tuple[int, int]:
    """The contiguous [lo, hi) row range of an (n_global, ...) array that
    this process must load under ``sharding`` (an items_sharding or a
    Mesh): its shards are consecutive, so their rows are too."""
    mesh = sharding if isinstance(sharding, Mesh) else sharding.mesh
    assert n_global % mesh.size == 0, (
        f"N={n_global} must be padded to a multiple of the mesh size "
        f"{mesh.size}")
    shard_n = n_global // mesh.size
    lo = mesh.local_shards.start * shard_n
    return int(lo), int(lo + mesh.n_local * shard_n)


def make_sharded_corpus(local_rows, mesh: Mesh,
                        n_global: int) -> ShardedTensor:
    """The global (n_global, F) corpus from THIS process's row slice
    (local_row_range): the slice is cut into this process's shards, each
    placed on its device.  No process ever holds the full corpus."""
    lo, hi = local_row_range(mesh, n_global)
    rows = local_rows if torch.is_tensor(local_rows) else \
        torch.as_tensor(np.ascontiguousarray(local_rows))
    assert rows.shape[0] == hi - lo, (
        f"this process holds rows [{lo}, {hi}), got {rows.shape[0]}")
    shard_n = n_global // mesh.size
    shards = [rows[j * shard_n:(j + 1) * shard_n].to(d)
              for j, d in enumerate(mesh.devices)]
    return ShardedTensor(shards, mesh, n_global)


# ---------------------------------------------------------------------------
# Collectives: in one process a concatenation or reduction in shard order
# on the mesh's first device; across processes one torch.distributed call.
# ---------------------------------------------------------------------------

def _all_gather_dim0(t: torch.Tensor) -> torch.Tensor:
    """(P·rows, ...) of every process's t, in rank order."""
    import torch.distributed as dist
    _rank, procs = world()
    t = t.contiguous()
    out = t.new_empty((procs * t.shape[0],) + tuple(t.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t)
    return out


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's rows t (same shape on each), concatenated along
    dim 0 in rank order."""
    t = t.to(mesh.first_device)
    return _all_gather_dim0(t) if mesh.grouped else t


def gather_columns(parts: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """(B, S·w): the local shards' (B, w) blocks and every other
    process's, side by side in global shard order, on the mesh's first
    device (the JAX package's tiled all_gather along axis 1)."""
    dev = mesh.first_device
    local = torch.cat([p.to(dev) for p in parts], dim=1)
    if not mesh.grouped:
        return local
    b = local.shape[0]
    g = _all_gather_dim0(local)                        # (P·B, L·w)
    return g.view(mesh.procs, b, -1).permute(1, 0, 2).reshape(b, -1)


def _reduce(parts: List[torch.Tensor], mesh: Mesh, op: str) -> torch.Tensor:
    import torch.distributed as dist
    dev = mesh.first_device
    stack = torch.stack([p.to(dev) for p in parts])
    out = stack.amax(dim=0) if op == "max" else stack.sum(dim=0)
    if mesh.grouped:
        out = out.contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
    return out


def all_reduce_max(parts: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Element-wise max of the local shards' tensors and every other
    process's (JAX's pmax)."""
    return _reduce(parts, mesh, "max")


def all_reduce_sum(parts: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Element-wise sum of the local shards' tensors and every other
    process's (JAX's psum)."""
    return _reduce(parts, mesh, "sum")


# ---------------------------------------------------------------------------
# The localhost dry run
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multiprocess_dryrun(num_processes: int = 2, local_devices: int = 4,
                            n_rows: int = 131072, f: int = 64,
                            timeout: float = 1500.0,
                            device: str = "cuda") -> dict:
    """Launch ``num_processes`` localhost worker processes
    (parallel/mp_worker.py), each holding ``local_devices`` shards on
    ``device`` ("cuda", the default: nccl; "cpu": gloo), which run the per-process
    ingested sharded build -> λ -> query -> serving path, and return
    process 0's parsed result.  Raises RuntimeError with every worker's
    tail on a failure or when ``timeout`` seconds pass (the workers are
    killed)."""
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    procs, logs = [], []
    try:
        for pid in range(num_processes):
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "arrowspace_torch.parallel.mp_worker",
                 "--pid", str(pid), "--nproc", str(num_processes),
                 "--port", str(port), "--n", str(n_rows), "--f", str(f),
                 "--local-devices", str(local_devices), "--device", device],
                cwd=repo_root, stdout=log, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + timeout
        failed = timed_out = False
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                failed = True
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if timed_out:
        raise RuntimeError(
            "multi-process dryrun timed out; partial output:\n"
            + "\n".join(o[-2000:] for o in outs))
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed or bad:
        raise RuntimeError(
            f"multi-process dryrun failed in process(es) {bad}:\n"
            + "\n---\n".join(f"[p{i}] ...{o[-3000:]}"
                             for i, o in enumerate(outs)))
    for line in outs[0].splitlines():
        if line.startswith("MP_DRYRUN_RESULT "):
            return json.loads(line[len("MP_DRYRUN_RESULT "):])
    raise RuntimeError(
        "worker 0 produced no MP_DRYRUN_RESULT line:\n" + outs[0][-3000:])


def run_cpu_multiprocess_dryrun(num_processes: int = 2,
                                local_devices: int = 4,
                                n_rows: int = 131072, f: int = 64,
                                timeout: float = 1500.0) -> dict:
    """run_multiprocess_dryrun with every shard on the CPU (gloo)."""
    return run_multiprocess_dryrun(num_processes, local_devices, n_rows, f,
                                   timeout, device="cpu")
