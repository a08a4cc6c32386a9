"""State carried across from an index built by the JAX package.

``from_jax_state`` takes the arrays of a built index as numpy (the item
matrix, λ, the graph Laplacian, the τ policy, the clustering fields,
the signals graph of a spectral build and, for a dims-reduced or energy
build, the F×r projection matrix and the tall-graph flag) and returns
this package's ArrowIndex on a given device, so an index built once can
be served here.  It needs nothing of
the JAX package: a τ policy is anything with ``kind`` and ``value``.

``sharded_from_jax_state`` does the same and then splits the corpus and
λ over a mesh's shards (parallel.mesh.shard_rows), for the distributed
functions and the mesh sessions; ``ensemble_from_jax`` carries an
ensemble of the JAX package (hypergraph.build_ensemble's list of
(GraphLaplacian, λ), as numpy arrays) across.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import resolve
from .core import ArrowSpace
from .graph import GraphLaplacian
from .index import ArrowIndex
from .reduction import ImplicitProjection
from .taumode import TauMode

__all__ = ["from_jax_state", "sharded_from_jax_state", "ensemble_from_jax"]


def from_jax_state(data, lambdas, laplacian, taumode, *,
                   n_clusters: int = 0,
                   cluster_assignments: Optional[np.ndarray] = None,
                   cluster_sizes: Optional[np.ndarray] = None,
                   cluster_radius: float = 0.0,
                   projection: Optional[np.ndarray] = None,
                   pad_tall_graphs: bool = False,
                   signals=None,
                   device=None, dtype=None) -> ArrowIndex:
    """ArrowIndex over the given state.  ``data`` (N, F), ``lambdas``
    (N,) and ``laplacian`` (n, n) are array-likes; ``taumode`` is a
    TauMode of either package; ``projection`` the (F, r) matrix of a
    projected build (the JAX package's
    ``aspace.projection_matrix.matrix()``), held as it is; ``signals``
    the F′×F′ signals graph (``aspace.signals``) where the build made
    one."""
    dev, dt = resolve(device, dtype)
    rows = np.array(data, dtype=np.float64)       # owned, writable copy
    lap = np.asarray(laplacian, dtype=np.float64)
    n_items, n_features = rows.shape
    mode = TauMode(str(taumode.kind), float(taumode.value))
    aspace = ArrowSpace(
        nfeatures=n_features,
        nitems=n_items,
        data=torch.as_tensor(rows).to(device=dev, dtype=dt),
        lambdas=torch.tensor(np.asarray(lambdas, dtype=np.float64)).to(
            device=dev, dtype=dt),
        taumode=mode,
        n_clusters=int(n_clusters),
        cluster_assignments=np.asarray(
            cluster_assignments if cluster_assignments is not None else [],
            dtype=np.int64),
        cluster_sizes=np.asarray(
            cluster_sizes if cluster_sizes is not None else [],
            dtype=np.int64),
        cluster_radius=float(cluster_radius),
        host_rows=rows,
        pad_tall_graphs=bool(pad_tall_graphs),
    )
    if projection is not None:
        aspace.projection_matrix = ImplicitProjection.from_matrix(
            projection, generator="threefry")
        aspace.reduced_dim = aspace.projection_matrix.reduced_dim
    if signals is not None:
        sig = np.asarray(signals, dtype=np.float64)
        aspace.signals = torch.tensor(sig).to(device=dev, dtype=dt)
        aspace._signals_nnz = int(np.count_nonzero(sig))
    gl = GraphLaplacian(
        init_data=torch.empty((0, n_items), device=dev, dtype=dt),
        matrix=torch.tensor(lap).to(device=dev, dtype=dt),
        nnodes=n_items,
        graph_params=None,
        structural_nnz=int(np.count_nonzero(lap)),
    )
    return ArrowIndex(aspace, gl)


def sharded_from_jax_state(data, lambdas, laplacian, taumode, mesh,
                           **kwargs):
    """(ArrowIndex, items ShardedTensor, λ ShardedTensor): from_jax_state
    on the mesh's first device (``kwargs`` as there), then the corpus and
    its λ split over the mesh's shards; a shard on the index's device is
    a view of the index's tensor, not a copy."""
    from .parallel.mesh import shard_rows
    kwargs.setdefault("device", mesh.first_device)
    index = from_jax_state(data, lambdas, laplacian, taumode, **kwargs)
    a = index.aspace
    return index, shard_rows(a.data, mesh), shard_rows(a.lambdas, mesh)


def _graph_params(gp):
    """A GraphParams of this package from either package's (None stays
    None)."""
    from .graph import GraphParams
    if gp is None:
        return None
    return GraphParams(eps=gp.eps, k=gp.k, topk=gp.topk, p=gp.p,
                       sigma=gp.sigma, normalise=gp.normalise,
                       sparsity_check=gp.sparsity_check)


def ensemble_from_jax(ensemble, *, device=None, dtype=None):
    """An ensemble of the JAX package (hypergraph.build_ensemble's list
    of (GraphLaplacian, λ)) as this package's, on ``device`` in
    ``dtype``: each graph's matrix, init data, node count, parameters and
    structural nnz, and each λ vector, carried as numpy."""
    dev, dt = resolve(device, dtype)
    out = []
    for gl, lam in ensemble:
        out.append((GraphLaplacian(
            init_data=torch.tensor(np.asarray(gl.init_data,
                                              dtype=np.float64)).to(
                device=dev, dtype=dt),
            matrix=torch.tensor(np.asarray(gl.matrix,
                                           dtype=np.float64)).to(
                device=dev, dtype=dt),
            nnodes=int(gl.nnodes),
            graph_params=_graph_params(gl.graph_params),
            structural_nnz=int(gl.structural_nnz)),
            torch.tensor(np.asarray(lam, dtype=np.float64)).to(
                device=dev, dtype=dt)))
    return out
