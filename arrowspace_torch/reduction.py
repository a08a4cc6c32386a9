"""Johnson-Lindenstrauss random projection with implicit (seed-only) storage.

PyTorch counterpart of ``arrowspace_tpu.reduction`` (reference:
reduction.rs:126-203).  The projection matrix is not stored: only
(original_dim, reduced_dim, seed), and the F×r Gaussian matrix, scaled by
1/√r, is regenerated from the seed on demand.

Divergence: the matrix comes from ``torch.randn`` on an explicit CPU
``torch.Generator`` seeded with ``seed mod 2^63``, so its numbers differ
from the JAX package's (threefry) as those differ from the reference's
(ChaCha8).  Determinism, shape, linearity and the 1/√r scale match.  An
index built by the JAX package carries its own matrix across
(``ImplicitProjection.from_matrix``, used by ``convert.from_jax_state``).
``generator`` records which generator made the matrix ("torch" for this
package's, "threefry" for one carried across from the JAX package), and
a saved projected index stores the matrix itself (storage/parquet), so
no package regenerates another's numbers from a seed.
"""

from __future__ import annotations

import math
import secrets
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .config import resolve
from .utils.log import get_logger

logger = get_logger("arrowspace.reduction")

__all__ = ["compute_jl_dimension", "ImplicitProjection", "project_matrix"]


def compute_jl_dimension(n_points: int, epsilon: float) -> int:
    """r = max(32, ceil(8·ln(n)/ε²)) (reference: reduction.rs:126-139)."""
    jl_dim = math.ceil(8.0 * math.log(n_points) / (epsilon ** 2))
    return max(jl_dim, 32)


@dataclass
class ImplicitProjection:
    """Seed-deterministic Gaussian projection (reference:
    reduction.rs:168-203).

    ``held``, when set, is a given (F, r) matrix used instead of the one
    the seed generates; ``generator`` names what made the matrix."""

    original_dim: int
    reduced_dim: int
    seed: int = field(default_factory=lambda: secrets.randbits(64))
    held: Optional[np.ndarray] = None
    generator: str = "torch"

    @staticmethod
    def from_matrix(mat, seed: int = 0,
                    generator: str = "torch") -> "ImplicitProjection":
        """A projection that holds the given (F, r) matrix, made by
        ``generator``."""
        m = np.array(mat, dtype=np.float64)
        return ImplicitProjection(m.shape[0], m.shape[1], seed, held=m,
                                  generator=generator)

    def _cpu_matrix(self) -> torch.Tensor:
        """The F×r matrix on the CPU, cached: float32 Gaussians times
        1/√r when generated (as the JAX package rounds them), float64
        when held."""
        cached = getattr(self, "_cpu_cache", None)
        if cached is None:
            if self.held is not None:
                cached = torch.as_tensor(self.held)
            else:
                gen = torch.Generator(device="cpu")
                gen.manual_seed(self.seed % (2 ** 63))
                gauss = torch.randn((self.original_dim, self.reduced_dim),
                                    generator=gen, dtype=torch.float32)
                cached = gauss * (1.0 / math.sqrt(self.reduced_dim))
            self._cpu_cache = cached
        return cached

    def matrix(self, dtype=torch.float64, device="cpu") -> torch.Tensor:
        """The F×r projection matrix in ``dtype`` on ``device``."""
        return self._cpu_matrix().to(device=device, dtype=dtype)

    def project(self, query) -> np.ndarray:
        """Project a single F-vector to r dims on the host, in float64
        (reference: reduction.rs:185-202)."""
        q = np.asarray(query, dtype=np.float64)
        return q[: self.original_dim] @ self.matrix().numpy()

    def project_batch_host(self, rows) -> np.ndarray:
        """Batched host projection, float64."""
        rows = np.asarray(rows, dtype=np.float64)
        return rows[:, : self.original_dim] @ self.matrix().numpy()

    def project_device(self, rows: torch.Tensor) -> torch.Tensor:
        """(N, F) @ (F, r) on the rows' device, in their dtype."""
        return rows @ self.matrix(dtype=rows.dtype, device=rows.device)


def project_matrix(data, projection: ImplicitProjection, *, device=None,
                   dtype=None) -> torch.Tensor:
    """Every row of an (N, F) matrix projected (reference:
    reduction.rs:141-166): a tensor on its own device in its own dtype,
    an array-like on ``device`` in ``dtype`` (config.resolve)."""
    if not torch.is_tensor(data):
        dev, dt = resolve(device, dtype)
        data = torch.as_tensor(np.asarray(data, dtype=np.float64)).to(
            device=dev, dtype=dt)
    return projection.project_device(data)
