"""arrowspace-torch: the λτ spectral vector-search engine on PyTorch/CUDA.

The PyTorch counterpart of ``arrowspace_tpu``: it indexes a dense N×F
matrix with one bounded scalar per item (the λτ "taumode" index, from a
Rayleigh quotient against a feature-graph Laplacian plus an edgewise
dispersion term) and blends cosine similarity with λ proximity at query
time.  Plain tensor code is PyTorch; the hot kernels are hand-written
CUDA C++ for Hopper (csrc/), built with nvcc at first use.

This package imports neither JAX nor ``arrowspace_tpu``.
"""

from .utils.log import init  # noqa: F401
from .taumode import TauMode, TAU_FLOOR, TAUDEFAULT  # noqa: F401
from .core import ArrowItem, ArrowSpace  # noqa: F401
from .graph import GraphFactory, GraphLaplacian, GraphParams  # noqa: F401
from .builder import ArrowSpaceBuilder, ConfigValue  # noqa: F401
from .sampling import SamplerType  # noqa: F401
from . import eigenmaps  # noqa: F401  (attaches the staged API)
from .index import ArrowIndex, SearchSession  # noqa: F401
from .live import LiveEnergySearchSession, LiveSearchSession  # noqa: F401
from .pruned import (  # noqa: F401
    PrunedCells, PrunedSearchSession, build_cells, build_cells_device,
    load_cells, save_cells)
from .ops.streaming import (streamed_lambda_topk,  # noqa: F401
                            streamed_taumode_lambdas)

__version__ = "0.1.0"
