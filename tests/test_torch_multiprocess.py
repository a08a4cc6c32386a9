"""The multi-process runtime of arrowspace_torch.parallel on
torch.distributed (gloo over localhost), on the CPU.

The dry runs launch real worker processes (parallel/mp_worker.py), each
holding its own row slice as CPU shards: 2 processes x 4 shards and 4
processes x 2 shards of the same 8-shard world, at 4096 x 16.  Every
check of the sharded build, λ, the 1-D and hierarchical merges and the
sessions is an assertion inside the workers, so a failed one fails the
test, never skips it; a test skips only where gloo cannot open a
localhost socket.  Each run's results (the build step's ids, the
session's and the energy session's ids, the centroid count and the λ
checksum) must equal the same dry run made in this process on an
8-shard CPU mesh.  Each launcher has its own time limit of 120 s and
kills its workers when it passes.

Tolerances: ids and centroid counts exact; the λ checksum (a float64
sum of float32 λ) equal."""

import numpy as np
import pytest
import torch

from arrowspace_torch.parallel import (items_sharding, local_row_range,
                                       make_mesh, mp_worker, put_global,
                                       replicated_sharding,
                                       run_cpu_multiprocess_dryrun)
from arrowspace_torch.parallel.mesh import ShardedTensor

N_ROWS, F = 4096, 16


@pytest.fixture(scope="module")
def one_process():
    """The dry run in this process on an 8-shard CPU mesh."""
    return mp_worker.dryrun(make_mesh(devices=["cpu"] * 8), N_ROWS, F)


def test_local_row_range_contract():
    """One process owns every row; the range follows the mesh's shards
    and refuses a row count the shards do not divide."""
    mesh = make_mesh(devices=["cpu"] * 8)
    assert local_row_range(items_sharding(mesh), 4096) == (0, 4096)
    assert local_row_range(mesh, 8) == (0, 8)
    with pytest.raises(AssertionError, match="padded"):
        local_row_range(mesh, 4100)
    assert not mesh.multiprocess and mesh.procs == 1


def test_put_global_single_process():
    mesh = make_mesh(devices=["cpu"] * 4)
    x = np.arange(24.0, dtype=np.float32).reshape(8, 3)
    g = put_global(x, items_sharding(mesh))
    assert isinstance(g, ShardedTensor) and len(g.shards) == 4
    np.testing.assert_array_equal(g.numpy(), x)
    assert put_global(g, items_sharding(mesh)) is g
    r = put_global(x, replicated_sharding(mesh))
    assert torch.is_tensor(r) and r.device == mesh.first_device
    np.testing.assert_array_equal(r.numpy(), x)


def test_one_process_dryrun(one_process):
    r = one_process
    assert r["ok"] is True and r["process_count"] == 1
    assert r["global_devices"] == 8 and r["local_rows"] == [0, N_ROWS]
    assert r["self_match"] == "16/16"
    assert r["session_self_match"] == "16/16"
    assert r["binned_self_match"] == "16/16"
    # one process holds every shard, so the binned sessions repair their
    # flagged rows through the strided mesh repair
    assert r["strided_repairs"]["lambda"] > 0
    assert r["strided_repairs"]["energy"] > 0


def _run(num_processes, local_devices):
    try:
        return run_cpu_multiprocess_dryrun(num_processes=num_processes,
                                           local_devices=local_devices,
                                           n_rows=N_ROWS, f=F, timeout=120)
    except RuntimeError as e:
        msg = str(e).lower()
        if "gloo" in msg and ("socket" in msg or "connect" in msg
                              or "address already in use" in msg):
            pytest.skip(f"gloo cannot open a localhost socket: {msg[:200]}")
        raise


@pytest.mark.parametrize("procs,local", [(2, 4), (4, 2)])
def test_multiprocess_dryrun_matches_one_process(one_process, procs, local):
    """procs localhost processes x local CPU shards each (gloo): per-process
    ingestion, the sharded clustering, λ shard parity, the hierarchical
    (dcn = processes, ici = local shards) merge and the sessions, all
    asserted inside the workers; results equal to the one-process run."""
    r = _run(procs, local)
    assert r["ok"] is True
    assert r["process_count"] == procs and r["global_devices"] == 8
    assert r["local_devices"] == local
    assert r["local_rows"] == [0, N_ROWS // procs]
    assert r["self_match"] == "16/16"
    assert r["session_self_match"] == "16/16"
    assert r["binned_self_match"] == "16/16"
    assert r["hierarchical_topk_equal"] is True
    # across processes every flagged row takes the exact pass
    assert r["strided_repairs"] == {"lambda": 0, "energy": 0}
    for key in ("centroids", "build_ids", "session_ids", "energy_ids",
                "lambda_checksum"):
        assert r[key] == one_process[key], key
