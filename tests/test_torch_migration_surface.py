"""MIGRATION.md contract on the port: every API the migration guide
documents exists in ``arrowspace_torch`` with the documented name and
keyword options, as tests/test_migration_surface.py holds it for
``arrowspace_tpu``, so a user following the guide on the port meets no
AttributeError or TypeError.  The guide's XLA-only entries
(``config.setup_cache``, ``precompile.centroid_cap_buckets``) are held
missing, with their reasons in tests/test_torch_surface.py."""

import inspect

import pytest

import arrowspace_torch as at
from arrowspace_torch import eigenmaps as em
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import ArrowSpace
from arrowspace_torch.storage import parquet as pq


def _accepts(fn, *names):
    params = inspect.signature(fn).parameters
    return [n for n in names if n not in params]


def test_top_level_surface():
    for name in ("ArrowSpaceBuilder", "TauMode", "SamplerType",
                 "ArrowIndex", "init", "eigenmaps"):
        assert hasattr(at, name), name


def test_builder_surface():
    b = ArrowSpaceBuilder(device="cpu")
    for name in ("with_lambda_graph", "with_synthesis",
                 "with_normalisation", "with_spectral",
                 "with_sparsity_check", "with_inline_sampling",
                 "with_dims_reduction", "with_seed", "with_persistence",
                 "define_result_k", "builder_config_typed"):
        assert hasattr(b, name), name
    assert "eps=" in str(b)


def test_staged_eigenmaps_surface():
    for name in ("start_clustering", "eigenmaps", "compute_taumode",
                 "search", "ClusteredOutput"):
        assert hasattr(em, name), name
    for name in ("start_clustering", "eigenmaps", "compute_taumode",
                 "search"):
        assert hasattr(ArrowSpace, name), name
    fields = em.ClusteredOutput.__dataclass_fields__
    assert {"aspace", "centroids", "reduced_dim", "n_items",
            "n_features"} <= set(fields)


def test_query_surface():
    for name in ("prepare_query_item", "search_lambda_aware",
                 "search_lambda_aware_hybrid", "range_search",
                 "add_items", "mul_items", "scale_item", "update_lambdas",
                 "prepare_query_items_batch", "search_lambda_aware_batch",
                 "range_search_sorted", "project_query", "from_items",
                 "from_items_default"):
        assert hasattr(ArrowSpace, name), name
    assert not _accepts(ArrowSpace.search_lambda_aware_batch, "use_pallas")


def test_storage_surface():
    for name in ("save_dense_matrix", "load_dense_matrix",
                 "save_sparse_matrix", "load_sparse_matrix",
                 "save_lambda", "load_lambda",
                 "save_arrowspace_checkpoint_with_builder",
                 "load_arrowspace_index"):
        assert hasattr(pq, name), name


def test_energy_surface():
    from arrowspace_torch.energymaps import (EnergyParams, build_energy,
                                             search_energy,
                                             search_energy_batch)
    assert EnergyParams().allow_tall_graphs is False
    assert callable(search_energy_batch)
    # the reference's trait impls, attached as the JAX package does
    from arrowspace_torch import energymaps as en
    assert ArrowSpaceBuilder.build_energy is build_energy
    assert ArrowSpaceBuilder.build_energy_laplacian is \
        en.build_energy_laplacian
    assert ArrowSpace.search_energy is search_energy
    for name in ("optical_compress_centroids",
                 "bootstrap_centroid_laplacian",
                 "diffuse_and_split_subcentroids"):
        assert getattr(ArrowSpace, name) is getattr(en, name)


def test_serving_and_parallel_surface():
    from arrowspace_torch.index import (ArrowIndex, EnergySearchSession,
                                        SearchSession, session_kernel_kind)
    for name in ("build", "build_energy", "save", "load", "search",
                 "search_one", "search_hybrid", "range", "search_energy",
                 "make_search_session", "make_energy_session",
                 "make_live_session", "warmup", "stats"):
        assert hasattr(ArrowIndex, name), name
    assert hasattr(SearchSession, "search_stream")
    assert hasattr(EnergySearchSession, "search_stream")
    assert callable(session_kernel_kind)
    # the guide's keyword options: spectral builds, use_pallas (every
    # precision), the sessions' prepare_corpus, f64_rescore's pool
    assert not _accepts(ArrowIndex.build, "spectral", "dims_reduction",
                        "rp_eps", "seed")
    assert not _accepts(ArrowIndex.search, "use_pallas", "precision",
                        "rescore_pool")
    assert not _accepts(ArrowIndex.make_search_session, "batch_size", "k",
                        "alpha", "depth", "precision")
    assert not _accepts(SearchSession, "prepare_corpus", "precision")
    assert not _accepts(EnergySearchSession, "prepare_corpus", "approx")
    assert not _accepts(ArrowIndex.make_energy_session, "batch_size", "k",
                        "w_lambda", "w_dirichlet", "depth")
    assert not _accepts(ArrowIndex.make_live_session, "batch_size", "k",
                        "alpha", "depth", "precision", "capacity")
    from arrowspace_torch.precompile import warm, warm_energy
    assert not _accepts(warm, "taumode", "graph_nodes")
    assert callable(warm_energy)
    from arrowspace_torch.parallel import (
        DistributedSearchSession, distributed_build_step,
        distributed_index_step, make_mesh, make_mesh_2d,
        sharded_incremental_clustering)
    for fn in (DistributedSearchSession, distributed_build_step,
               distributed_index_step, make_mesh, make_mesh_2d,
               sharded_incremental_clustering):
        assert callable(fn)
    from arrowspace_torch.ops.streaming import (streamed_lambda_topk,
                                                streamed_taumode_lambdas)
    assert callable(streamed_lambda_topk)
    assert callable(streamed_taumode_lambdas)


@pytest.mark.parametrize("module,name", [("config", "setup_cache"),
                                         ("config", "bucket_rows"),
                                         ("precompile",
                                          "centroid_cap_buckets")])
def test_the_xla_only_entries_are_absent(module, name):
    import importlib
    mod = importlib.import_module(f"arrowspace_torch.{module}")
    assert not hasattr(mod, name)
