"""Global configuration for arrowspace-torch.

Numeric constants shared with the JAX package, and the dtype/device
policy: an index lives on one device in one dtype, chosen when it is
built.  The default is float32 on CUDA; the CPU parity tests pass
``dtype=torch.float64, device="cpu"`` explicitly.
"""

from __future__ import annotations

import os

import torch

# Floor applied to every selected tau (reference: taumode.rs:84).
TAU_FLOOR = 1e-10

# Guard for near-zero Rayleigh denominators (reference: taumode.rs:597).
DENOM_EPS = 1e-12

# Corpora whose item matrix exceeds this many bytes compute λτ in fixed
# row windows over the resident tensor, so the transient working set of
# the λ pass stays one window's worth next to the corpus.
TAUMODE_WINDOW_BYTES = 2 << 30

# Float32 batches of at least this many values select τ (median or
# percentile) with the K4 kernel (ops/select_tau.py), as the JAX package
# takes its Pallas τ kernel from PALLAS_TAU_MIN_ELEMS (config.py:45).
SELECT_TAU_KERNEL_MIN_ELEMS = 1 << 22

DEFAULT_DTYPE = torch.float32
DEFAULT_DEVICE = "cuda"

# Every float32 product in this package feeds an exact top-k or an order
# statistic that is compared with the JAX package, whose reference runs
# at full float32 (and float64 on the CPU).  TF32 keeps ~10 mantissa
# bits, which reorders near-tied scores and moves λ by ~1e-3, so it is
# off for matmuls and for cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device=None, dtype=None):
    """(torch.device, torch.dtype) with the package defaults filled in."""
    dev = torch.device(device if device is not None else DEFAULT_DEVICE)
    return dev, (dtype if dtype is not None else DEFAULT_DTYPE)


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def is_test_mode() -> bool:
    """Mirrors the reference's #[cfg(test)] gates (e.g. the sampling-ratio
    runtime assert in clustering.rs:896-900 is disabled in test builds)."""
    return os.environ.get("ARROWSPACE_TEST_MODE", "0") not in ("0", "", "false")
