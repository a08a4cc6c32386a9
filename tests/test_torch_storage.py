"""arrowspace_torch.storage (Parquet persistence) against the JAX
package's: every test of tests/test_storage.py on the port's module, the
same goldens and foreign-writer artifacts, the metadata JSON of both
packages, and indexes saved by one package and loaded by the other.

A projected index is the one place the packages part: the JAX package
stores a seed and regenerates its threefry matrix on load, the port
stores the matrix itself (``{name}-projection``) with no seed, and each
loader refuses the other's projected artifact.

Tolerances: artifacts read back bitwise; λ and graphs of builds of the
two packages within rtol 1e-12 (float64; products summed in another
order); search ids exact and scores within 1e-12."""

import json
import pathlib

import numpy as np
import pyarrow.parquet as pq_reader
import pytest
import torch

from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.storage import StorageError as JStorageError
from arrowspace_tpu.storage import parquet as jpq
from arrowspace_tpu.taumode import TauMode as JTauMode
from arrowspace_torch import ArrowIndex
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import ArrowItem
from arrowspace_torch.storage import StorageError
from arrowspace_torch.storage import parquet as pq
from arrowspace_torch.taumode import TauMode
from data import make_gaussian_hd, make_moons_hd

CPU64 = dict(device="cpu", dtype=torch.float64)


def _tb():
    return ArrowSpaceBuilder(**CPU64)


def test_dense_roundtrip(tmp_path):
    m = np.random.default_rng(0).normal(size=(13, 7))
    pq.save_dense_matrix(m, tmp_path, "dense_test")
    back = pq.load_dense_matrix(tmp_path / "dense_test.parquet")
    np.testing.assert_array_equal(m, back)


def test_dense_schema_matches_reference(tmp_path):
    m = np.arange(12, dtype=float).reshape(4, 3)
    pq.save_dense_matrix(m, tmp_path, "schema_test")
    table = pq_reader.read_table(tmp_path / "schema_test.parquet")
    names = table.schema.names
    assert names[:3] == ["name_id", "n_rows", "n_cols"]
    assert names[3:] == ["col_0", "col_1", "col_2"]
    assert str(table.schema.field("n_rows").type) == "uint64"
    assert str(table.schema.field("col_0").type) == "double"
    assert table.column("name_id")[0].as_py() == "schema_test"


def test_sparse_roundtrip(tmp_path):
    m = np.zeros((9, 9))
    m[0, 3] = -0.5
    m[3, 0] = -0.5
    m[0, 0] = 0.5
    m[3, 3] = 0.5
    pq.save_sparse_matrix(m, tmp_path, "sparse_test")
    back = pq.load_sparse_matrix(tmp_path / "sparse_test.parquet")
    np.testing.assert_array_equal(m, back)
    table = pq_reader.read_table(tmp_path / "sparse_test.parquet")
    assert table.schema.names == ["name_id", "n_rows", "n_cols", "nnz",
                                  "row", "col", "value"]


def test_lambda_roundtrip(tmp_path):
    lam = np.array([0.1, 0.5, 0.25, 0.75])
    pq.save_lambda(lam, tmp_path, "lambda_test")
    back = pq.load_lambda(tmp_path / "lambda_test.parquet")
    np.testing.assert_array_equal(lam, back)
    table = pq_reader.read_table(tmp_path / "lambda_test.parquet")
    assert table.schema.names == ["name_id", "n_values", "row_index",
                                  "lambda"]


def test_empty_lambda_rejected(tmp_path):
    with pytest.raises(StorageError):
        pq.save_lambda(np.array([]), tmp_path, "empty")


def test_metadata_with_builder(tmp_path):
    b = (_tb().with_lambda_graph(0.5, 8, 4, 3.0, 0.1)
         .with_synthesis(TauMode.percentile(0.9)))
    pq.save_dense_matrix_with_builder(np.ones((5, 4)), tmp_path, "withmeta",
                                      b)
    md = pq.load_metadata(tmp_path, "withmeta")
    assert md.lambda_eps() == 0.5
    assert md.lambda_k() == 8
    assert md.synthesis() == TauMode.percentile(0.9)
    assert md.files["matrix"]["file_type"] == "dense"
    raw = json.loads((tmp_path / "withmeta_metadata.json").read_text())
    assert "builder_config" in raw and "lambda_eps" in raw["builder_config"]


def test_checkpoint_multi_artifact(tmp_path):
    raw = np.random.default_rng(1).normal(size=(10, 6))
    adjacency = np.abs(np.random.default_rng(2).normal(size=(6, 6)))
    pq.save_arrowspace_checkpoint_with_builder(
        tmp_path / "ckpt", "test", raw, adjacency, raw[:4], np.eye(6),
        np.zeros((6, 6)), _tb())
    md = pq.load_metadata(tmp_path / "ckpt", "test")
    assert set(md.files) == {"raw_data", "adjacency", "centroids",
                             "laplacian", "signals"}
    back = pq.load_dense_matrix(tmp_path / "ckpt" / "test_raw_data.parquet")
    np.testing.assert_array_equal(raw, back)


def test_sparse_matrix_empty(tmp_path):
    m = np.zeros((5, 5))
    pq.save_sparse_matrix(m, tmp_path, "sparse_empty")
    back = pq.load_sparse_matrix(tmp_path / "sparse_empty.parquet")
    np.testing.assert_array_equal(back, m)


def test_dense_matrix_large_dimensions(tmp_path):
    m = np.random.default_rng(8).normal(size=(6, 300))
    pq.save_dense_matrix(m, tmp_path, "dense_wide")
    table = pq_reader.read_table(tmp_path / "dense_wide.parquet")
    assert table.schema.names[3:] == [f"col_{j}" for j in range(300)]
    np.testing.assert_array_equal(
        m, pq.load_dense_matrix(tmp_path / "dense_wide.parquet"))


def test_load_metadata_nonexistent(tmp_path):
    with pytest.raises((StorageError, FileNotFoundError)):
        pq.load_metadata(tmp_path, "never_saved")


def test_multiple_checkpoints_same_directory(tmp_path):
    raw_a = np.random.default_rng(3).normal(size=(8, 4))
    raw_b = np.random.default_rng(4).normal(size=(9, 4))
    adj = np.abs(np.random.default_rng(5).normal(size=(4, 4)))
    lap, sig = np.eye(4), np.zeros((4, 4))
    pq.save_arrowspace_checkpoint_with_builder(
        tmp_path, "alpha", raw_a, adj, raw_a[:3], lap, sig, _tb())
    pq.save_arrowspace_checkpoint_with_builder(
        tmp_path, "beta", raw_b, adj, raw_b[:3], lap, sig, _tb())
    np.testing.assert_array_equal(
        raw_a, pq.load_dense_matrix(tmp_path / "alpha_raw_data.parquet"))
    np.testing.assert_array_equal(
        raw_b, pq.load_dense_matrix(tmp_path / "beta_raw_data.parquet"))
    assert pq.load_metadata(tmp_path, "alpha").name_id == "alpha"
    assert pq.load_metadata(tmp_path, "beta").name_id == "beta"


def test_metadata_file_registry_and_json_format(tmp_path):
    b = _tb().with_lambda_graph(0.5, 7, 4, 2.0, None)
    md = (pq.ArrowSpaceMetadata.from_builder("regtest", b)
          .with_dimensions(100, 16)
          .add_file("raw_data", pq.FileInfo("regtest_raw.parquet",
                                            "dense", 100, 16,
                                            size_bytes=12345)))
    pq.save_metadata(md, tmp_path, "regtest")
    raw = json.loads((tmp_path / "regtest_metadata.json").read_text())
    assert raw["name_id"] == "regtest"
    assert raw["n_rows"] == 100 and raw["n_cols"] == 16
    assert raw["files"]["raw_data"]["size_bytes"] == 12345
    back = pq.load_metadata(tmp_path, "regtest")
    assert back.files["raw_data"]["size_bytes"] == 12345
    assert back.get_config("lambda_k") == b.builder_config_typed()["lambda_k"]


def test_unwritable_dir_fails(tmp_path):
    with pytest.raises(StorageError):
        pq.save_dense_matrix(np.ones((3, 3)),
                             tmp_path / "does" / "not" / "exist", "nope")


def test_builder_persistence_hooks(tmp_path):
    """builder.rs:271-432: the artifacts saved during a build, equal to the
    build's own tensors and to the JAX package's artifacts."""
    rows = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=10, seed=10)
    b = _tb().with_seed(13).with_persistence(tmp_path / "t", "bench")
    aspace, gl = b.build(rows)
    assert b.stage_seconds["persistence"] > 0.0
    JBuilder().with_seed(13).with_persistence(tmp_path / "j", "bench") \
        .build(rows.tolist())
    lam_back = pq.load_lambda(tmp_path / "t" / "bench-lambdas.parquet")
    np.testing.assert_array_equal(lam_back, aspace.lambdas.numpy())
    gl_back = pq.load_sparse_matrix(tmp_path / "t" / "bench-gl-matrix.parquet")
    np.testing.assert_array_equal(gl_back, gl.matrix.numpy())
    loaders = {"raw_input": (pq.load_dense_matrix, jpq.load_dense_matrix),
               "clustered-dm": (pq.load_dense_matrix, jpq.load_dense_matrix),
               "laplacian-input": (pq.load_dense_matrix,
                                   jpq.load_dense_matrix),
               "gl-matrix": (pq.load_sparse_matrix, jpq.load_sparse_matrix),
               "lambdas": (pq.load_lambda, jpq.load_lambda)}
    for suffix, (load_t, load_j) in loaders.items():
        f = f"bench-{suffix}.parquet"
        assert (tmp_path / "t" / f).exists(), suffix
        np.testing.assert_allclose(load_t(tmp_path / "t" / f),
                                   load_j(tmp_path / "j" / f), rtol=1e-12,
                                   atol=1e-14)


def test_load_arrowspace_index_roundtrip(tmp_path):
    """A persisted build reloads into a serving-ready index: identical λ,
    Laplacian, parameters and search results."""
    rows = make_moons_hd(70, noise=0.1, hd_noise=0.05, dims=10, seed=20)
    aspace, gl = (_tb().with_lambda_graph(1.0, 5, 3, 2.0, None)
                  .with_seed(21).with_persistence(tmp_path, "serve")
                  .build(rows))
    aspace2, gl2 = pq.load_arrowspace_index(tmp_path, "serve", **CPU64)
    assert torch.equal(aspace2.lambdas, aspace.lambdas)
    assert torch.equal(gl2.matrix, gl.matrix)
    assert gl2.nnodes == gl.nnodes
    assert gl2.graph_params == gl.graph_params
    np.testing.assert_array_equal(aspace2.host_rows, rows)
    q = rows[9] * 1.02
    lam1, lam2 = aspace.prepare_query_item(q, gl), \
        aspace2.prepare_query_item(q, gl2)
    assert lam1 == lam2
    r1 = aspace.search_lambda_aware(ArrowItem(q, lam1), 5, 0.8)
    r2 = aspace2.search_lambda_aware(ArrowItem(q, lam2), 5, 0.8)
    assert r1 == r2


def _projected_build(tmp_path, name, seed, build_seed=None, sampling=True):
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=seed)
    b = _tb().with_lambda_graph(1.0, 5, 3, 2.0, None) \
        .with_dims_reduction(True, 0.5).with_persistence(tmp_path, name)
    if build_seed is not None:
        b = b.with_seed(build_seed)
    if not sampling:
        b = b.with_inline_sampling(None)
    aspace, gl = b.build(rows)
    return rows, aspace, gl


def _assert_same_projection(aspace, aspace2):
    p2 = aspace2.projection_matrix
    assert p2 is not None and p2.generator == "torch"
    assert torch.equal(p2.matrix(), aspace.projection_matrix.matrix())
    assert torch.equal(p2.matrix(dtype=torch.float32),
                       aspace.projection_matrix.matrix(dtype=torch.float32))
    assert p2.reduced_dim == aspace.projection_matrix.reduced_dim
    assert aspace2.reduced_dim == aspace.reduced_dim


def test_projected_index_reload_query_parity(tmp_path):
    """A dims-reduced index reloads with its projection matrix bitwise as
    it was (read from its {name}-projection artifact), so queries are
    prepared and served exactly as before."""
    rows, aspace, gl = _projected_build(tmp_path, "proj", 31, 33)
    assert aspace.projection_matrix is not None
    md = json.loads((tmp_path / "proj-lambdas_metadata.json").read_text())
    assert md["projection"] == {
        "original_dim": 96, "reduced_dim": aspace.reduced_dim,
        "generator": "torch", "file": "proj-projection.parquet"}
    aspace2, gl2 = pq.load_arrowspace_index(tmp_path, "proj", **CPU64)
    _assert_same_projection(aspace, aspace2)
    q = rows[7] * 1.02
    assert aspace.prepare_query_item(q, gl) == \
        aspace2.prepare_query_item(q, gl2)
    i1 = ArrowIndex(aspace, gl).search(rows[:5] * 1.01, k=6, alpha=0.8)
    i2 = ArrowIndex(aspace2, gl2).search(rows[:5] * 1.01, k=6, alpha=0.8)
    np.testing.assert_array_equal(i1[1], i2[1])
    np.testing.assert_array_equal(i1[0], i2[0])


def test_projected_index_reload_unseeded(tmp_path):
    """An unseeded dims-reduced build (a random projection seed) reloads
    faithfully too: the matrix, not the seed, is stored."""
    rows, aspace, gl = _projected_build(tmp_path, "proju", 35,
                                        sampling=False)
    assert aspace.projection_matrix is not None
    aspace2, gl2 = pq.load_arrowspace_index(tmp_path, "proju", **CPU64)
    _assert_same_projection(aspace, aspace2)
    q = rows[11] * 1.01
    assert aspace.prepare_query_item(q, gl) == \
        aspace2.prepare_query_item(q, gl2)


def test_legacy_projected_artifact_without_metadata(tmp_path):
    """An artifact with no projection entry from a dims-reduced build
    (tests/test_storage.py:274): the JAX package would regenerate its
    matrix from the clustering seed with threefry, which the port cannot,
    so it raises a typed error, seeded or not."""
    _rows, aspace, _gl = _projected_build(tmp_path, "legacy", 37, 39)
    md_path = tmp_path / "legacy-lambdas_metadata.json"
    md = json.loads(md_path.read_text())
    assert "projection" in md
    del md["projection"]
    md_path.write_text(json.dumps(md))
    with pytest.raises(StorageError, match="projection"):
        pq.load_arrowspace_index(tmp_path, "legacy", **CPU64)
    for name in ("legacy-lambdas", "legacy-raw_input"):
        p = tmp_path / f"{name}_metadata.json"
        m = json.loads(p.read_text())
        m["builder_config"]["clustering_seed"] = {"OptionU64": None}
        p.write_text(json.dumps(m))
    with pytest.raises(StorageError, match="projection"):
        pq.load_arrowspace_index(tmp_path, "legacy", **CPU64)


# ---------------------------------------------------------------------------
# Golden Parquet artifacts (tests/test_storage.py:318-375)
# ---------------------------------------------------------------------------

GOLDEN_DIR = pathlib.Path(__file__).parent / "fixtures" / "parquet_golden"


def _golden_generators():
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).parent / "fixtures"))
    import make_parquet_goldens as g
    return g


def test_golden_dense_reads_back_exact():
    g = _golden_generators()
    np.testing.assert_array_equal(
        pq.load_dense_matrix(GOLDEN_DIR / "golden_dense.parquet"),
        g.dense_data())


def test_golden_sparse_reads_back_exact():
    g = _golden_generators()
    np.testing.assert_array_equal(
        pq.load_sparse_matrix(GOLDEN_DIR / "golden_sparse.parquet"),
        g.sparse_data())


def test_golden_lambda_reads_back_exact():
    g = _golden_generators()
    np.testing.assert_array_equal(
        pq.load_lambda(GOLDEN_DIR / "golden_lambda.parquet"), g.lambda_data())


def test_writer_schema_matches_golden(tmp_path):
    """The port's writer gives the frozen artifacts' schemas and
    content."""
    g = _golden_generators()
    pq.save_dense_matrix(g.dense_data(), tmp_path, "golden_dense")
    pq.save_sparse_matrix(g.sparse_data(), tmp_path, "golden_sparse")
    pq.save_lambda(g.lambda_data(), tmp_path, "golden_lambda")
    for name in ("golden_dense", "golden_sparse", "golden_lambda"):
        frozen = pq_reader.read_table(GOLDEN_DIR / f"{name}.parquet")
        fresh = pq_reader.read_table(tmp_path / f"{name}.parquet")
        assert fresh.schema.equals(frozen.schema), name
        assert fresh.equals(frozen), name


def test_golden_sparse_schema_fields():
    import pyarrow as pa
    t = pq_reader.read_table(GOLDEN_DIR / "golden_sparse.parquet")
    want = [("name_id", pa.utf8()), ("n_rows", pa.uint64()),
            ("n_cols", pa.uint64()), ("nnz", pa.uint64()),
            ("row", pa.uint64()), ("col", pa.uint64()),
            ("value", pa.float64())]
    assert [(f.name, f.type) for f in t.schema] == want
    assert all(not f.nullable for f in t.schema)
    rows, cols = t.column("row").to_numpy(), t.column("col").to_numpy()
    assert {(int(r), int(c)) for r, c in zip(rows, cols) if r == c} == \
        {(i, i) for i in range(6)}


# ---------------------------------------------------------------------------
# Foreign-written artifacts (tests/test_storage.py:393-437)
# ---------------------------------------------------------------------------

def test_foreign_dense_artifact_loads(tmp_path):
    from fixtures import foreign_parquet_writer as fw
    m = np.random.default_rng(3).normal(size=(11, 5))
    m[0, 0] = -0.0
    m[1, 2] = 1e-308
    fw.write_dense(tmp_path, "rustlike_dense", m)
    np.testing.assert_array_equal(
        pq.load_dense_matrix(tmp_path / "rustlike_dense.parquet"), m)


def test_foreign_sparse_artifact_loads(tmp_path):
    from fixtures import foreign_parquet_writer as fw
    a = np.zeros((6, 6))
    a[0, 3] = a[3, 0] = 2.5
    a[5, 1] = -1.25
    lap = np.diag(a.sum(1)) - a
    fw.write_sparse(tmp_path, "rustlike_sparse", lap)
    np.testing.assert_array_equal(
        pq.load_sparse_matrix(tmp_path / "rustlike_sparse.parquet"), lap)


def test_foreign_lambda_artifact_loads(tmp_path):
    from fixtures import foreign_parquet_writer as fw
    lam = np.random.default_rng(7).uniform(0, 1, 23)
    fw.write_lambda(tmp_path, "rustlike_lambdas", lam)
    np.testing.assert_array_equal(
        pq.load_lambda(tmp_path / "rustlike_lambdas.parquet"), lam)


def test_foreign_writer_bytes_differ_from_ours(tmp_path):
    from fixtures import foreign_parquet_writer as fw
    m = np.arange(12, dtype=float).reshape(4, 3)
    fw.write_dense(tmp_path, "foreign", m)
    pq.save_dense_matrix(m, tmp_path, "ours")
    assert (tmp_path / "foreign.parquet").read_bytes() != \
        (tmp_path / "ours.parquet").read_bytes()
    np.testing.assert_array_equal(
        pq.load_dense_matrix(tmp_path / "foreign.parquet"),
        pq.load_dense_matrix(tmp_path / "ours.parquet"))


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------

def _json_without_timestamp(path):
    d = json.loads(pathlib.Path(path).read_text())
    d.pop("timestamp")
    return d


def _save_both(tmp_path, kind):
    """One artifact of ``kind`` written by each package from the same
    numpy data and equal builders; returns the two metadata paths."""
    rng = np.random.default_rng(9)
    jb = JBuilder().with_lambda_graph(0.4, 7, 3, 2.0, 0.5) \
        .with_synthesis(JTauMode.percentile(0.3)).with_seed(4)
    tb = _tb().with_lambda_graph(0.4, 7, 3, 2.0, 0.5) \
        .with_synthesis(TauMode.percentile(0.3)).with_seed(4)
    m = rng.normal(size=(12, 12))
    for mod, b, sub in ((jpq, jb, "j"), (pq, tb, "t")):
        d = tmp_path / sub
        d.mkdir()
        if kind == "dense":
            mod.save_dense_matrix_with_builder(m, d, "a", b)
        elif kind == "sparse":
            mod.save_sparse_matrix_with_builder(np.where(m > 0.5, m, 0.0), d,
                                                "a", b)
        elif kind == "lambda":
            mod.save_lambda_with_builder(np.abs(m[0]), d, "a", b)
        else:
            mod.save_arrowspace_checkpoint_with_builder(
                d, "a", m, np.abs(m), m[:4], np.eye(12), np.eye(12) * 2, b)
    return tmp_path / "j" / "a_metadata.json", tmp_path / "t" / "a_metadata.json"


@pytest.mark.parametrize("kind", ["dense", "sparse", "lambda", "checkpoint"])
def test_metadata_json_equals_jax_except_timestamp(tmp_path, kind):
    jpath, tpath = _save_both(tmp_path, kind)
    assert _json_without_timestamp(tpath) == _json_without_timestamp(jpath)
    for f in json.loads(tpath.read_text())["files"].values():
        assert (tmp_path / "t" / f["filename"]).read_bytes() == \
            (tmp_path / "j" / f["filename"]).read_bytes()


def test_builder_metadata_equals_jax_except_timestamp(tmp_path):
    """A persisted build of each package: every artifact's metadata has
    the same keys, typed configuration, dimensions and file registry."""
    rows = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=10, seed=12)
    JBuilder().with_lambda_graph(1.0, 5, 3, 2.0, None).with_seed(3) \
        .with_persistence(tmp_path / "j", "m").build(rows.tolist())
    _tb().with_lambda_graph(1.0, 5, 3, 2.0, None).with_seed(3) \
        .with_persistence(tmp_path / "t", "m").build(rows)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    for name in names:
        if not name.endswith("_metadata.json"):
            continue
        j = _json_without_timestamp(tmp_path / "j" / name)
        t = _json_without_timestamp(tmp_path / "t" / name)
        for d in (j, t):          # compressed sizes follow the last bits
            for f in d["files"].values():
                f.pop("size_bytes")
        assert t == j, name


def _unprojected_pair(tmp_path):
    rows = make_moons_hd(80, noise=0.08, hd_noise=0.04, dims=12, seed=1)
    j = JIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=42)
    t = ArrowIndex.build(rows, eps=1.0, k=5, topk=3, seed=42, **CPU64)
    return rows, j, t


def _assert_search_equal(rows, a, b):
    q = rows[[2, 17, 40, 63]] * 1.02
    sa, ia = a.search(q, k=6, alpha=0.85)
    sb, ib = b.search(q, k=6, alpha=0.85)
    np.testing.assert_array_equal(np.asarray(ib), np.asarray(ia))
    np.testing.assert_allclose(np.asarray(sb), np.asarray(sa), rtol=0,
                               atol=1e-12)


def test_jax_artifact_loads_in_the_port(tmp_path):
    rows, j, _t = _unprojected_pair(tmp_path)
    j.save(tmp_path, "jx")
    t = ArrowIndex.load(tmp_path, "jx", **CPU64)
    np.testing.assert_array_equal(t.lambdas, np.asarray(j.lambdas))
    np.testing.assert_array_equal(t.gl.matrix.numpy(), np.asarray(j.gl.matrix))
    jp, tp = j.gl.graph_params, t.gl.graph_params
    assert (tp.eps, tp.k, tp.topk, tp.p, tp.sigma, tp.normalise) == \
        (jp.eps, jp.k, jp.topk, jp.p, jp.sigma, jp.normalise)
    _assert_search_equal(rows, j, t)


def test_port_artifact_loads_in_jax(tmp_path):
    rows, _j, t = _unprojected_pair(tmp_path)
    t.save(tmp_path, "tx")
    j = JIndex.load(tmp_path, "tx")
    np.testing.assert_array_equal(np.asarray(j.lambdas), t.lambdas)
    np.testing.assert_array_equal(np.asarray(j.gl.matrix), t.gl.matrix.numpy())
    _assert_search_equal(rows, t, j)
    # and back into the port through a save of the JAX package
    j.save(tmp_path, "tx2")
    t2 = ArrowIndex.load(tmp_path, "tx2", **CPU64)
    assert torch.equal(t2.aspace.lambdas, t.aspace.lambdas)
    _assert_search_equal(rows, t, t2)


def test_spectral_index_roundtrip_both_loaders(tmp_path):
    """The signals graph is saved beside the index and restored by both
    loaders; the port's load → save → load keeps it."""
    rows = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=12, seed=5)
    aspace, gl = _tb().with_lambda_graph(1.0, 5, 3, 2.0, None) \
        .with_spectral(True).with_seed(9) \
        .with_persistence(tmp_path, "sp").build(rows)
    assert (tmp_path / "sp-aspace-signals.parquet").exists()
    t = ArrowIndex.load(tmp_path, "sp", **CPU64)
    assert torch.equal(t.aspace.signals, aspace.signals)
    assert t.aspace._signals_nnz == aspace._signals_nnz
    assert t._synthesize_builder().prebuilt_spectral
    t.save(tmp_path, "sp2")
    t2 = ArrowIndex.load(tmp_path, "sp2", **CPU64)
    assert torch.equal(t2.aspace.signals, aspace.signals)
    jaspace, _jgl = jpq.load_arrowspace_index(tmp_path, "sp")
    np.testing.assert_array_equal(np.asarray(jaspace.signals),
                                  aspace.signals.numpy())


def test_synthesized_builder_matches_jax(tmp_path):
    """An index with no builder (a loaded one) saves the configuration
    reconstructed from its state, as the JAX package does."""
    rows, j, t = _unprojected_pair(tmp_path)
    j.save(tmp_path, "s")
    jl = JIndex.load(tmp_path, "s")
    tl = ArrowIndex.load(tmp_path, "s", **CPU64)
    assert tl.builder is None and jl.builder is None
    jcfg = jl._synthesize_builder().builder_config_typed()
    tcfg = tl._synthesize_builder().builder_config_typed()
    assert {k: v.to_json() for k, v in tcfg.items()} == \
        {k: v.to_json() for k, v in jcfg.items()}
    assert str(tl._synthesize_builder()) == str(jl._synthesize_builder())


def test_projected_port_artifact_refused_by_jax(tmp_path):
    """The JAX loader cannot read the port's projection entry (no seed to
    regenerate from), so a port-projected index never loads there with
    another matrix."""
    _projected_build(tmp_path, "pp", 31, 33)
    with pytest.raises((KeyError, JStorageError)):
        jpq.load_arrowspace_index(tmp_path, "pp")


def test_projected_jax_artifact_refused_by_port(tmp_path):
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=31)
    JBuilder().with_lambda_graph(1.0, 5, 3, 2.0, None) \
        .with_dims_reduction(True, 0.5).with_seed(33) \
        .with_persistence(tmp_path, "jp").build(rows.tolist())
    md = json.loads((tmp_path / "jp-lambdas_metadata.json").read_text())
    assert "seed" in md["projection"] and "generator" not in md["projection"]
    with pytest.raises(StorageError, match="threefry"):
        pq.load_arrowspace_index(tmp_path, "jp", **CPU64)
    with pytest.raises(StorageError, match="threefry"):
        ArrowIndex.load(tmp_path, "jp", **CPU64)


def test_load_places_tensors_on_the_requested_device_and_dtype(tmp_path):
    rows, _j, t = _unprojected_pair(tmp_path)
    t.save(tmp_path, "d")
    f32 = ArrowIndex.load(tmp_path, "d", device="cpu", dtype=torch.float32)
    for ten in (f32.aspace.data, f32.aspace.lambdas, f32.gl.matrix):
        assert ten.dtype == torch.float32 and ten.device.type == "cpu"
    assert f32.aspace.host_rows.dtype == np.float64
    # float32 -> float64 artifact -> float32 is exact
    f32.save(tmp_path, "d32")
    again = ArrowIndex.load(tmp_path, "d32", device="cpu", dtype=torch.float32)
    assert torch.equal(again.aspace.data, f32.aspace.data)
    assert torch.equal(again.aspace.lambdas, f32.aspace.lambdas)
    assert torch.equal(again.gl.matrix, f32.gl.matrix)
