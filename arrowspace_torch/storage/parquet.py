"""Parquet persistence with schemas byte-compatible with the reference.

Reference schemas (storage/parquet.rs):
- dense   (:192-277): name_id Utf8, n_rows UInt64, n_cols UInt64, then one
  Float64 column per feature named col_{i}; Snappy compression;
- sparse  (:354-449): name_id, n_rows, n_cols, nnz UInt64, row UInt64,
  col UInt64, value Float64 — COO triplets;
- lambda  (:665-745): name_id, n_values UInt64, row_index UInt64,
  lambda Float64;
- metadata (:29-159): `{name}_metadata.json` with the typed builder config
  and a file registry;
- checkpoint (:528-619): raw/adjacency/centroids/laplacian/signals + one
  metadata JSON.

A copy of ``arrowspace_tpu.storage.parquet`` (it writes the same files),
except that ``load_arrowspace_index`` builds torch tensors on the index
device, and that a projected index stores its F×r matrix as the dense
artifact ``{name}-projection``: the λ metadata's ``projection`` entry is
{"original_dim", "reduced_dim", "generator", "file"}, with no ``seed``.
The JAX package regenerates its matrix from a seed with its own
generator (threefry), which this package cannot reproduce, so each
package refuses the other's projected artifact instead of projecting
queries through a different matrix: this loader raises StorageError on
a seed it cannot regenerate, and the JAX loader cannot read an entry
without a seed.
"""

from __future__ import annotations

import datetime
import json
import os
import pathlib
from typing import Dict, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from .errors import StorageError
from ..utils.log import get_logger

logger = get_logger("arrowspace.storage")

__all__ = [
    "ArrowSpaceMetadata", "FileInfo", "save_metadata", "load_metadata",
    "save_dense_matrix", "save_dense_matrix_with_builder", "load_dense_matrix",
    "save_sparse_matrix", "save_sparse_matrix_with_builder",
    "load_sparse_matrix", "save_lambda", "save_lambda_with_builder",
    "load_lambda", "save_projection", "load_arrowspace_index",
    "save_arrowspace_checkpoint_with_builder",
]


class FileInfo(dict):
    """File registry entry (reference: storage/parquet.rs:46-54)."""

    def __init__(self, filename, file_type, rows, cols, nnz=None,
                 size_bytes=None):
        super().__init__(filename=filename, file_type=file_type, rows=rows,
                         cols=cols, nnz=nnz, size_bytes=size_bytes)


class ArrowSpaceMetadata:
    """Metadata container (reference: storage/parquet.rs:29-126)."""

    def __init__(self, name_id: str):
        self.name_id = name_id
        self.timestamp = datetime.datetime.now(
            datetime.timezone.utc).isoformat()
        self.n_rows = 0
        self.n_cols = 0
        self.builder_config: Dict[str, object] = {}
        self.files: Dict[str, FileInfo] = {}
        # Projection state (an extension beyond the reference's schema):
        # {"original_dim", "reduced_dim", "generator", "file"} when the
        # index was built with an active JL projection, else None.  The
        # JAX package writes {"original_dim", "reduced_dim", "seed"}.
        self.projection: Optional[Dict[str, object]] = None

    @staticmethod
    def from_builder(name_id: str, builder) -> "ArrowSpaceMetadata":
        md = ArrowSpaceMetadata(name_id)
        md.builder_config = builder.builder_config_typed()
        return md

    def with_builder_config(self, config) -> "ArrowSpaceMetadata":
        self.builder_config = config
        return self

    def with_dimensions(self, rows: int, cols: int) -> "ArrowSpaceMetadata":
        self.n_rows = rows
        self.n_cols = cols
        return self

    def add_file(self, key: str, info: FileInfo) -> "ArrowSpaceMetadata":
        self.files[key] = info
        return self

    def with_projection(self, projection,
                        file: Optional[str] = None) -> "ArrowSpaceMetadata":
        """Record the index's ImplicitProjection: its dims, the generator
        that made its matrix and the artifact ``file`` holding it, so that
        queries are projected through the same matrix after a reload."""
        if projection is not None:
            self.projection = {
                "original_dim": int(projection.original_dim),
                "reduced_dim": int(projection.reduced_dim),
                "generator": str(projection.generator),
                "file": file,
            }
        return self

    def get_config(self, key: str):
        return self.builder_config.get(key)

    def lambda_eps(self) -> Optional[float]:
        v = self.get_config("lambda_eps")
        return v.as_f64() if v is not None else None

    def lambda_k(self) -> Optional[int]:
        v = self.get_config("lambda_k")
        return v.as_usize() if v is not None else None

    def synthesis(self):
        v = self.get_config("synthesis")
        return v.as_tau_mode() if v is not None else None

    def config_summary(self) -> str:
        return "\n".join(f"  {k} = {v}"
                         for k, v in self.builder_config.items())

    # --- JSON round-trip --------------------------------------------------
    def to_json(self) -> dict:
        out = {
            "name_id": self.name_id,
            "timestamp": self.timestamp,
            "n_rows": self.n_rows,
            "n_cols": self.n_cols,
            "builder_config": {k: v.to_json()
                               for k, v in self.builder_config.items()},
            "files": dict(self.files),
        }
        if self.projection is not None:
            out["projection"] = self.projection
        return out

    @staticmethod
    def from_json(obj: dict) -> "ArrowSpaceMetadata":
        from ..builder import ConfigValue
        md = ArrowSpaceMetadata(obj["name_id"])
        md.timestamp = obj["timestamp"]
        md.n_rows = obj["n_rows"]
        md.n_cols = obj["n_cols"]
        md.builder_config = {k: ConfigValue.from_json(v)
                             for k, v in obj["builder_config"].items()}
        md.files = {k: FileInfo(**v) for k, v in obj["files"].items()}
        md.projection = obj.get("projection")
        return md


def save_metadata(metadata: ArrowSpaceMetadata, path, name_id: str) -> None:
    p = pathlib.Path(path) / f"{name_id}_metadata.json"
    try:
        p.write_text(json.dumps(metadata.to_json(), indent=2))
    except OSError as e:
        raise StorageError.io(f"Failed to write metadata: {e}")


def load_metadata(path, name_id: str) -> ArrowSpaceMetadata:
    p = pathlib.Path(path) / f"{name_id}_metadata.json"
    try:
        raw = p.read_text()
    except OSError as e:
        raise StorageError.io(f"Failed to read metadata: {e}")
    try:
        return ArrowSpaceMetadata.from_json(json.loads(raw))
    except (json.JSONDecodeError, KeyError) as e:
        raise StorageError.invalid(f"Failed to parse metadata: {e}")


# ---------------------------------------------------------------------------
# Dense matrix
# ---------------------------------------------------------------------------

def save_dense_matrix(matrix, path, name_id: str,
                      builder_config=None) -> None:
    m = np.asarray(matrix, dtype=np.float64)
    n_rows, n_cols = m.shape

    fields = [pa.field("name_id", pa.utf8(), nullable=False),
              pa.field("n_rows", pa.uint64(), nullable=False),
              pa.field("n_cols", pa.uint64(), nullable=False)]
    arrays = [pa.array([name_id] * n_rows, type=pa.utf8()),
              pa.array([n_rows] * n_rows, type=pa.uint64()),
              pa.array([n_cols] * n_rows, type=pa.uint64())]
    for i in range(n_cols):
        fields.append(pa.field(f"col_{i}", pa.float64(), nullable=False))
        arrays.append(pa.array(m[:, i], type=pa.float64()))

    table = pa.Table.from_arrays(arrays, schema=pa.schema(fields))
    file_path = pathlib.Path(path) / f"{name_id}.parquet"
    try:
        pq.write_table(table, file_path, compression="snappy")
    except OSError as e:
        raise StorageError.io(str(e))

    if builder_config is not None:
        size = os.path.getsize(file_path)
        md = (ArrowSpaceMetadata(name_id)
              .with_builder_config(builder_config)
              .with_dimensions(n_rows, n_cols)
              .add_file("matrix", FileInfo(
                  filename=f"{name_id}.parquet", file_type="dense",
                  rows=n_rows, cols=n_cols, size_bytes=size)))
        save_metadata(md, path, name_id)


def save_dense_matrix_with_builder(matrix, path, name_id: str,
                                   builder=None) -> None:
    cfg = builder.builder_config_typed() if builder is not None else None
    save_dense_matrix(matrix, path, name_id, cfg)


def load_dense_matrix(path) -> np.ndarray:
    try:
        table = pq.read_table(path)
    except FileNotFoundError as e:
        raise StorageError.io(str(e))
    except pa.ArrowInvalid as e:
        raise StorageError.parquet(str(e))
    if table.num_rows == 0:
        raise StorageError.invalid("No data in parquet file")
    n_rows = int(table.column("n_rows")[0].as_py())
    n_cols = int(table.column("n_cols")[0].as_py())
    out = np.empty((n_rows, n_cols), dtype=np.float64)
    for i in range(n_cols):
        out[:, i] = table.column(f"col_{i}").to_numpy()
    return out


# ---------------------------------------------------------------------------
# Sparse matrix (COO triplets of the dense device Laplacian)
# ---------------------------------------------------------------------------

def save_sparse_matrix(matrix, path, name_id: str, builder_config=None,
                       structural_nnz: Optional[int] = None) -> None:
    m = np.asarray(matrix, dtype=np.float64)
    n_rows, n_cols = m.shape
    # stored entries: all non-zeros plus the always-stored diagonal,
    # matching the reference's CSR structure
    mask = m != 0.0
    np.fill_diagonal(mask, True)
    rows, cols = np.nonzero(mask)
    vals = m[rows, cols]
    nnz = rows.size

    schema = pa.schema([
        pa.field("name_id", pa.utf8(), nullable=False),
        pa.field("n_rows", pa.uint64(), nullable=False),
        pa.field("n_cols", pa.uint64(), nullable=False),
        pa.field("nnz", pa.uint64(), nullable=False),
        pa.field("row", pa.uint64(), nullable=False),
        pa.field("col", pa.uint64(), nullable=False),
        pa.field("value", pa.float64(), nullable=False),
    ])
    table = pa.Table.from_arrays([
        pa.array([name_id] * nnz, type=pa.utf8()),
        pa.array([n_rows] * nnz, type=pa.uint64()),
        pa.array([n_cols] * nnz, type=pa.uint64()),
        pa.array([nnz] * nnz, type=pa.uint64()),
        pa.array(rows.astype(np.uint64), type=pa.uint64()),
        pa.array(cols.astype(np.uint64), type=pa.uint64()),
        pa.array(vals, type=pa.float64()),
    ], schema=schema)

    file_path = pathlib.Path(path) / f"{name_id}.parquet"
    try:
        pq.write_table(table, file_path, compression="snappy")
    except OSError as e:
        raise StorageError.io(str(e))

    if builder_config is not None:
        size = os.path.getsize(file_path)
        md = (ArrowSpaceMetadata(name_id)
              .with_builder_config(builder_config)
              .with_dimensions(n_rows, n_cols)
              .add_file("matrix", FileInfo(
                  filename=f"{name_id}.parquet", file_type="sparse",
                  rows=n_rows, cols=n_cols, nnz=int(nnz), size_bytes=size)))
        save_metadata(md, path, name_id)


def save_sparse_matrix_with_builder(matrix, path, name_id: str, builder=None,
                                    structural_nnz=None) -> None:
    cfg = builder.builder_config_typed() if builder is not None else None
    save_sparse_matrix(matrix, path, name_id, cfg,
                       structural_nnz=structural_nnz)


def load_sparse_matrix(path) -> np.ndarray:
    """Loads COO triplets back into a dense ndarray (our device format)."""
    try:
        table = pq.read_table(path)
    except FileNotFoundError as e:
        raise StorageError.io(str(e))
    except pa.ArrowInvalid as e:
        raise StorageError.parquet(str(e))
    if table.num_rows == 0:
        raise StorageError.invalid("No data in parquet file")
    n_rows = int(table.column("n_rows")[0].as_py())
    n_cols = int(table.column("n_cols")[0].as_py())
    rows = table.column("row").to_numpy().astype(np.int64)
    cols = table.column("col").to_numpy().astype(np.int64)
    vals = table.column("value").to_numpy()
    out = np.zeros((n_rows, n_cols), dtype=np.float64)
    out[rows, cols] = vals
    return out


# ---------------------------------------------------------------------------
# Lambda vector
# ---------------------------------------------------------------------------

def save_projection(projection, path, name_id: str) -> str:
    """Write a projection's F×r matrix as the dense artifact ``name_id``;
    returns its file name."""
    save_dense_matrix(projection.matrix().numpy(), path, name_id)
    return f"{name_id}.parquet"


def save_lambda(lambdas, path, name_id: str, builder_config=None,
                projection=None) -> None:
    """The λ vector as ``name_id``; with a projection its matrix goes
    beside it as ``{index name}-projection`` (``name_id`` less its
    ``-lambdas`` suffix) and the metadata names that file."""
    lam = np.asarray(lambdas, dtype=np.float64)
    n_values = lam.size
    if n_values == 0:
        raise StorageError.invalid("Cannot save empty lambda vector")

    schema = pa.schema([
        pa.field("name_id", pa.utf8(), nullable=False),
        pa.field("n_values", pa.uint64(), nullable=False),
        pa.field("row_index", pa.uint64(), nullable=False),
        pa.field("lambda", pa.float64(), nullable=False),
    ])
    table = pa.Table.from_arrays([
        pa.array([name_id] * n_values, type=pa.utf8()),
        pa.array([n_values] * n_values, type=pa.uint64()),
        pa.array(np.arange(n_values, dtype=np.uint64), type=pa.uint64()),
        pa.array(lam, type=pa.float64()),
    ], schema=schema)

    file_path = pathlib.Path(path) / f"{name_id}.parquet"
    try:
        pq.write_table(table, file_path, compression="snappy")
    except OSError as e:
        raise StorageError.io(str(e))

    proj_file = None
    if projection is not None:
        base = name_id[:-len("-lambdas")] if name_id.endswith("-lambdas") \
            else name_id
        proj_file = save_projection(projection, path, f"{base}-projection")
    if builder_config is not None:
        size = os.path.getsize(file_path)
        md = (ArrowSpaceMetadata(name_id)
              .with_builder_config(builder_config)
              .with_dimensions(n_values, 1)
              .with_projection(projection, proj_file)
              .add_file("lambda_vector", FileInfo(
                  filename=f"{name_id}.parquet", file_type="lambda_vector",
                  rows=n_values, cols=1, size_bytes=size)))
        save_metadata(md, path, name_id)


def save_lambda_with_builder(lambdas, path, name_id: str,
                             builder=None, projection=None) -> None:
    cfg = builder.builder_config_typed() if builder is not None else None
    save_lambda(lambdas, path, name_id, cfg, projection=projection)


def load_lambda(path) -> np.ndarray:
    try:
        table = pq.read_table(path)
    except FileNotFoundError as e:
        raise StorageError.io(str(e))
    except pa.ArrowInvalid as e:
        raise StorageError.parquet(str(e))
    if table.num_rows == 0:
        raise StorageError.invalid("No data in parquet file")
    order = np.argsort(table.column("row_index").to_numpy())
    return table.column("lambda").to_numpy()[order]


# ---------------------------------------------------------------------------
# Checkpoint
# ---------------------------------------------------------------------------

def _projection_of(base: pathlib.Path, proj_md, use_dims: bool,
                   graph_nodes: int, n_features: int):
    """The projection a saved index was built with, from its artifact,
    or None when it was not projected.  Raises StorageError where the
    artifact holds only a seed (a JAX artifact, or an older one that
    recorded no projection): this package cannot regenerate the JAX
    package's threefry matrix."""
    from ..reduction import ImplicitProjection
    if proj_md is None:
        if use_dims and graph_nodes < n_features:
            raise StorageError.invalid(
                "Index was built with dims_reduction but its artifact "
                "records no projection; the JAX package would regenerate "
                "it from the clustering seed with its own generator "
                "(threefry), which this package cannot reproduce, so "
                "reloaded queries would score differently. Re-save the "
                "index with this package.")
        return None
    if proj_md.get("file") is None:
        raise StorageError.invalid(
            "Index was saved with a projection seed "
            f"({proj_md.get('generator', 'threefry')} generator) and no "
            "projection matrix; this package cannot regenerate the JAX "
            "package's threefry matrix, so reloaded queries would score "
            "differently. Save the index with this package (which stores "
            "the matrix itself).")
    mat = load_dense_matrix(base / proj_md["file"])
    if mat.shape != (int(proj_md["original_dim"]),
                     int(proj_md["reduced_dim"])):
        raise StorageError.invalid(
            f"projection matrix has shape {mat.shape}, metadata says "
            f"({proj_md['original_dim']}, {proj_md['reduced_dim']})")
    return ImplicitProjection.from_matrix(
        mat, generator=str(proj_md.get("generator", "torch")))


def load_arrowspace_index(path, name: str, *, device=None, dtype=None):
    """Reload a built index persisted via ArrowSpaceBuilder.with_persistence
    or ArrowIndex.save (artifacts: {name}-raw_input, {name}-gl-matrix,
    {name}-lambdas, {name}-laplacian-input, and {name}-projection and
    {name}-aspace-signals where the index has them, plus the metadata
    JSON with the typed builder config), as torch tensors on ``device``
    in ``dtype`` (config.resolve's defaults).

    Returns (ArrowSpace, GraphLaplacian) ready for prepare_query_item /
    search.  ``host_rows`` is the saved float64 raw input, so a float32
    index reloads bitwise as it was saved.  The reference has per-artifact
    loaders only; this composes them into a serving-ready index."""
    import torch

    from ..config import resolve
    from ..core import ArrowSpace
    from ..graph import GraphLaplacian, GraphParams

    dev, dt = resolve(device, dtype)
    base = pathlib.Path(path)
    raw = load_dense_matrix(base / f"{name}-raw_input.parquet")
    lap = load_sparse_matrix(base / f"{name}-gl-matrix.parquet")
    lambdas = load_lambda(base / f"{name}-lambdas.parquet")
    md = load_metadata(base, f"{name}-raw_input")
    try:
        md_lam = load_metadata(base, f"{name}-lambdas")
    except StorageError:
        md_lam = None

    cfg = md.builder_config
    taumode = cfg["synthesis"].as_tau_mode()

    def on_device(a):
        return torch.as_tensor(a).to(device=dev, dtype=dt)

    aspace = ArrowSpace.new(raw, taumode, device=dev, dtype=dt)
    aspace.lambdas = on_device(lambdas)

    proj_md = None
    for candidate in (md_lam, md):
        if candidate is not None and candidate.projection is not None:
            proj_md = candidate.projection
            break
    use_dims = cfg["use_dims_reduction"].as_bool() \
        if "use_dims_reduction" in cfg else False
    proj = _projection_of(base, proj_md, use_dims, lap.shape[0], raw.shape[1])
    if proj is not None:
        aspace.projection_matrix = proj
        aspace.reduced_dim = proj.reduced_dim

    params = GraphParams(
        eps=cfg["lambda_eps"].as_f64(),
        k=cfg["lambda_k"].as_usize(),
        topk=cfg["lambda_topk"].as_usize(),
        p=cfg["lambda_p"].as_f64(),
        sigma=cfg["lambda_sigma"].value,
        normalise=cfg["normalise"].as_bool(),
        sparsity_check=cfg["sparsity_check"].as_bool(),
    )
    mask = lap != 0.0
    np.fill_diagonal(mask, True)
    gl = GraphLaplacian(
        init_data=on_device(load_dense_matrix(
            base / f"{name}-laplacian-input.parquet")).T,
        matrix=on_device(lap),
        nnodes=raw.shape[0],
        graph_params=params,
        structural_nnz=int(mask.sum()),
    )
    signals_path = base / f"{name}-aspace-signals.parquet"
    if signals_path.exists():
        sig = load_sparse_matrix(signals_path)
        aspace.signals = on_device(sig)
        smask = sig != 0.0
        np.fill_diagonal(smask, True)
        aspace._signals_nnz = int(smask.sum())
    return aspace, gl


def save_arrowspace_checkpoint_with_builder(
    path, checkpoint_name: str, raw_data, adjacency, centroids, laplacian,
    signals, builder,
) -> None:
    """Multi-artifact checkpoint (reference: storage/parquet.rs:528-619)."""
    base = pathlib.Path(path)
    try:
        base.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise StorageError.io(f"Failed to create directory: {e}")

    save_dense_matrix(raw_data, base, f"{checkpoint_name}_raw_data")
    save_sparse_matrix(adjacency, base, f"{checkpoint_name}_adjacency")
    save_dense_matrix(centroids, base, f"{checkpoint_name}_centroids")
    save_sparse_matrix(laplacian, base, f"{checkpoint_name}_laplacian")
    save_sparse_matrix(signals, base, f"{checkpoint_name}_signals")

    raw = np.asarray(raw_data)
    md = (ArrowSpaceMetadata.from_builder(checkpoint_name, builder)
          .with_dimensions(raw.shape[0], raw.shape[1]))

    def _nnz(m):
        m = np.asarray(m)
        mask = m != 0.0
        if m.shape[0] == m.shape[1]:
            np.fill_diagonal(mask, True)
        return int(mask.sum())

    artifacts = [
        ("raw_data", "dense", np.asarray(raw_data).shape, None),
        ("adjacency", "sparse", np.asarray(adjacency).shape, _nnz(adjacency)),
        ("centroids", "dense", np.asarray(centroids).shape, None),
        ("laplacian", "sparse", np.asarray(laplacian).shape, _nnz(laplacian)),
        ("signals", "sparse", np.asarray(signals).shape, _nnz(signals)),
    ]
    for name, ftype, (rows, cols), nnz in artifacts:
        filename = f"{checkpoint_name}_{name}.parquet"
        size = os.path.getsize(base / filename)
        md = md.add_file(name, FileInfo(filename=filename, file_type=ftype,
                                        rows=int(rows), cols=int(cols),
                                        nnz=nnz, size_bytes=size))
    save_metadata(md, base, checkpoint_name)
