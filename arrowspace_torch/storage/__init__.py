"""Storage: Parquet persistence with reference-compatible schemas.

PyTorch counterpart of ``arrowspace_tpu.storage`` (reference:
storage/mod.rs, storage/parquet.rs): the same column names, types,
Snappy compression and metadata JSON, so the reference's tooling and the
JAX package read these artifacts and the other way round, projected
indexes excepted (see parquet.py).
"""

from .errors import StorageError  # noqa: F401
from . import parquet  # noqa: F401
