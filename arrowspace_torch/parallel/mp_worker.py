"""Multi-process dry-run worker: one process per "host".

Launched by multiprocess.run_multiprocess_dryrun: each process holds
``--local-devices`` shards on ``--device`` (a CUDA device with nccl, the
default "cuda", or "cpu" with gloo), joins the default process group over a localhost
rendezvous, ingests ONLY its own corpus row slice, and runs the sharded
build -> λτ -> query -> serving path end to end: the sharded unseeded
clustering, the sharded λ, the 1-D and the hierarchical (dcn, ici)
top-k, and the mesh sessions (plain, binned and energy).  Every check
is an assertion inside the worker, so a failed one fails the run.

Prints one ``MP_DRYRUN_RESULT {json}`` line from process 0.  ``dryrun``
is the whole path on a given mesh, so the same run can be made in one
process (tests compare the two).

    python -m arrowspace_torch.parallel.mp_worker --pid 0 --nproc 2 \\
        --port 29500 --n 4096 --f 16 --local-devices 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

BLOCK = 4096
B = 16
K = 10


def rows_block(lo: int, hi: int, f: int) -> np.ndarray:
    """Rows [lo, hi) of the dry run's corpus: 64 uniform centres in
    [0.2, 0.8], noise 0.05, float32.  The generator is keyed per
    4096-row block, so any process can make any range without owning
    it (the queries are rows of process 0)."""
    centers = np.random.default_rng(1).uniform(0.2, 0.8, (64, f))
    first = (lo // BLOCK) * BLOCK
    parts = []
    for b0 in range(first, hi, BLOCK):
        rng = np.random.default_rng(10_000 + b0)
        a = rng.integers(0, 64, BLOCK)
        parts.append((centers[a] + rng.normal(0, 0.05, (BLOCK, f)))
                     .astype(np.float32))
    return np.concatenate(parts)[lo - first:hi - first]


def dryrun(mesh, n: int, f: int) -> dict:
    """The sharded build -> λ -> query -> serving path over ``mesh``,
    every process ingesting only its own rows.  Returns the result dict
    (the same on every process)."""
    import torch.distributed as dist

    from arrowspace_torch import clustering
    from arrowspace_torch.builder import ArrowSpaceBuilder
    from arrowspace_torch.graph import GraphParams
    from arrowspace_torch.laplacian import build_laplacian_matrix
    from arrowspace_torch.parallel import (
        DistributedEnergySearchSession, DistributedSearchSession,
        distributed_build_step, distributed_lambda_aware_topk,
        distributed_lambda_aware_topk_2d, items_sharding, local_row_range,
        make_mesh_2d, make_sharded_corpus)
    from arrowspace_torch.sampling import SamplerType
    from arrowspace_torch.taumode import (TauMode, compute_taumode_lambdas,
                                          select_tau_batch,
                                          synthetic_lambda_batch)

    from arrowspace_torch.ops import bin_repair
    repairs0 = (bin_repair.strided_lambda_repair.calls,
                bin_repair.strided_energy_repair.calls)
    dev = mesh.first_device
    lo, hi = local_row_range(items_sharding(mesh), n)
    local = rows_block(lo, hi, f)           # per-process ingestion
    items = make_sharded_corpus(local, mesh, n)
    queries = rows_block(0, B, f) * np.float32(1.01)

    # optimal K from a pilot on process 0, broadcast, so every process
    # applies the build's host rules with the same (K, radius)
    if mesh.rank == 0:
        pilot = rows_block(0, min(16384, n), f)
        k_opt, radius, _ = clustering.compute_optimal_k(
            pilot, pilot.shape[0], f, 99)
        pack = torch.tensor([float(k_opt), float(radius)],
                            dtype=torch.float64, device=dev)
    else:
        pack = torch.zeros(2, dtype=torch.float64, device=dev)
    if mesh.grouped:
        dist.broadcast(pack, 0)
    k_opt, radius = int(pack[0].item()), float(pack[1].item())

    params = GraphParams(eps=1.0, k=5, topk=3, p=2.0, sigma=None,
                         normalise=False, sparsity_check=False)
    if mesh.multiprocess:
        # unseeded sampling is refused across processes: the host
        # decisions would diverge on per-process entropy
        bad = ArrowSpaceBuilder(device=dev)
        bad.sampling = SamplerType.simple(0.6)
        try:
            distributed_build_step(items, bad, queries, TauMode.median(),
                                   params, K, mesh, max_clusters=k_opt,
                                   radius=radius)
            raise AssertionError("unseeded multi-process build not refused")
        except ValueError as e:
            assert "seeded" in str(e), e

    builder = ArrowSpaceBuilder(device=dev)
    builder.sampling = None
    info = {}
    t0 = time.perf_counter()
    centroids, lambdas, scores, idx = distributed_build_step(
        items, builder, queries, TauMode.median(), params, K, mesh,
        max_clusters=k_opt, radius=radius, clustering=info)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    idx_h = idx.cpu().numpy()
    hits = sum(int(idx_h[qi][0]) == qi for qi in range(B))
    assert hits >= B - 2, f"self-match {hits}/{B}"
    assign = info["assignments"].array
    assert sum(info["sizes"]) == int((assign >= 0).sum()), \
        (sum(info["sizes"]), int((assign >= 0).sum()))

    # this process's shards of the sharded λ against a recompute over
    # its own rows on one device
    gl = build_laplacian_matrix(centroids.T, params, n_items=n, device=dev,
                                dtype=torch.float32)
    lam_ref = compute_taumode_lambdas(torch.as_tensor(local).to(dev),
                                      gl.matrix, TauMode.median())
    assert torch.allclose(lambdas.local(), lam_ref, rtol=1e-5, atol=1e-6), \
        "local λτ shard parity failed"

    # the hierarchical (dcn = processes, ici = local shards) merge
    # equals the 1-D merge on the same corpus
    q = torch.as_tensor(queries).to(dev)
    qlam = synthetic_lambda_batch(q, gl.matrix,
                                  select_tau_batch(q, TauMode.median()))
    _s1, i1 = distributed_lambda_aware_topk(q, qlam, items, lambdas, 0.9,
                                            K, mesh)
    mesh2d = make_mesh_2d(mesh.procs, mesh.n_local, devices=mesh.devices)
    _s2, i2 = distributed_lambda_aware_topk_2d(q, qlam, items, lambdas, 0.9,
                                               K, mesh2d)
    assert torch.equal(i1, i2), "hierarchical top-k differs from 1-D"

    # the serving sessions over the sharded corpus
    lap = gl.matrix
    sess = DistributedSearchSession(items, lambdas, lap, mesh,
                                    batch_size=B, k=K, alpha=0.9,
                                    kernel="xla")
    sess.warmup()
    outs = list(sess.search_stream(
        [queries, rows_block(B, 2 * B, f) * np.float32(1.01)]))
    s_hits = sum(int(outs[0][1][qi][0]) == qi for qi in range(B))
    assert s_hits >= B - 2, f"session self-match {s_hits}/{B}"

    sess_b = DistributedSearchSession(items, lambdas, lap, mesh,
                                      batch_size=B, k=K, alpha=0.9,
                                      kernel="binned")
    sess_b.warmup()
    (sb, ib), = list(sess_b.search_stream([queries]))
    b_hits = sum(int(ib[qi][0]) == qi for qi in range(B))
    assert b_hits >= B - 2, f"binned session self-match {b_hits}/{B}"
    assert np.array_equal(ib, outs[0][1]), "binned session differs"

    e_ids = []
    for kind in ("chunked", "binned"):
        es = DistributedEnergySearchSession(items, lambdas, lap, mesh,
                                            batch_size=B, k=K, kernel=kind)
        es.warmup()
        (_es, ei), = list(es.search_stream([queries]))
        e_ids.append(ei)
    assert np.array_equal(e_ids[0], e_ids[1]), \
        "binned energy session differs from the chunked one"

    from arrowspace_torch.ops import bintopk, energy_bintopk, taulambda, topk
    return {
        "ok": True,
        "process_count": mesh.procs,
        "global_devices": mesh.size,
        "local_devices": mesh.n_local,
        "device": str(dev),
        "n": n, "f": f,
        "local_rows": [lo, hi],
        "centroids": int(centroids.shape[0]),
        "build_s": round(build_s, 3),
        "clustering_s": round(info["seconds"], 3),
        "self_match": f"{hits}/{B}",
        "session_self_match": f"{s_hits}/{B}",
        "binned_self_match": f"{b_hits}/{B}",
        "hierarchical_topk_equal": True,
        "build_ids": idx_h.tolist(),
        "session_ids": outs[0][1].tolist(),
        "energy_ids": e_ids[0].tolist(),
        "lambda_checksum": float(lambdas.full().double().sum().item()),
        # strided mesh repairs of this run (the binned sessions' warm-ups
        # repair one row each); across processes flagged rows take the
        # exact pass instead, so these stay 0 there
        "strided_repairs": {
            "lambda": bin_repair.strided_lambda_repair.calls - repairs0[0],
            "energy": bin_repair.strided_energy_repair.calls - repairs0[1]},
        # kernel launches of this process (a CPU shard runs the plain
        # versions, which count none)
        "launches": {"bintopk": bintopk.binned_topk_pool.launches,
                     "bintopk_wgmma":
                         bintopk.binned_topk_pool.launches_wgmma,
                     "taulambda": taulambda.fused_taulambda.launches,
                     "merge_topk": topk.merge_topk_partial.launches,
                     "energy_bintopk":
                         energy_bintopk.binned_energy_pool.launches},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--f", type=int, default=64)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from arrowspace_torch.parallel import init_distributed, make_mesh
    init_distributed(f"localhost:{args.port}", num_processes=args.nproc,
                     process_id=args.pid, device=args.device)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        # the card init_distributed gave this rank
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        assert dist.get_world_size() == args.nproc, dist.get_world_size()
        mesh = make_mesh(devices=[dev] * args.local_devices)
        result = dryrun(mesh, args.n, args.f)
        if mesh.rank == 0:
            print("MP_DRYRUN_RESULT " + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
    sys.exit(0)
