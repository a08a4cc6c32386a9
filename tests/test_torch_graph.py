"""arrowspace_torch.laplacian / graph against the JAX package on the
test_laplacian.py cases: the Laplacian agrees to 1e-12 (float64; only the
cosine products' summation order differs), with the same structural
non-zero count, node bookkeeping and sparsity check."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arrowspace_tpu.graph import GraphFactory as JGraphFactory
from arrowspace_tpu.graph import GraphParams as JGraphParams
from arrowspace_tpu.laplacian import build_laplacian_matrix as j_build
from arrowspace_torch.graph import GraphFactory, GraphParams
from arrowspace_torch.laplacian import build_laplacian_matrix
from data import make_gaussian_blob

CASES = [
    # (rows seed, n, dims, eps, k, topk, p, sigma, normalise)
    (5, 24, 10, 0.8, 3, 4, 2.0, None, False),      # bruteforce-oracle case
    (1, 40, 6, 1.0, 3, 5, 2.0, None, False),       # properties case
    (2, 30, 8, 0.5, 3, 3, 2.0, None, False),       # eps filter
    (3, 30, 8, 0.7, 3, 3, 2.0, 0.3, False),        # explicit sigma
    (4, 30, 8, 0.7, 3, 3, 1.5, None, True),        # standard scaling
    (6, 80, 12, 1.0, 20, 20, 2.0, None, False),    # avg degree > 10: sparsify
    (7, 300, 16, 1.0, 6, 8, 2.0, None, False),     # n > 256 (JAX jit path)
]


def _params(cls, eps, k, topk, p, sigma, normalise):
    return cls(eps=eps, k=k, topk=topk, p=p, sigma=sigma,
               normalise=normalise, sparsity_check=False)


@pytest.mark.parametrize("seed,n,dims,eps,k,topk,p,sigma,normalise", CASES)
def test_laplacian_matches_jax(seed, n, dims, eps, k, topk, p, sigma,
                               normalise):
    rows = make_gaussian_blob(n, dims=dims, spread=0.4, seed=seed)
    jgl = j_build(jnp.asarray(rows), _params(JGraphParams, eps, k, topk, p,
                                              sigma, normalise), n_items=99)
    tgl = build_laplacian_matrix(
        torch.from_numpy(rows), _params(GraphParams, eps, k, topk, p, sigma,
                                        normalise),
        n_items=99, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(tgl.matrix.numpy(), np.asarray(jgl.matrix),
                               rtol=1e-12, atol=1e-12)
    assert tgl.structural_nnz == jgl.structural_nnz
    assert tgl.nnodes == jgl.nnodes == 99
    assert tgl.shape() == jgl.shape()


def test_from_k_cluster_transpose_quirk_matches_jax():
    cent = make_gaussian_blob(12, dims=20, spread=0.5, seed=9)
    args = (1.0, 6, 3, 2.0, None, False, False, 5000)
    jgl = JGraphFactory.build_laplacian_matrix_from_k_cluster(cent, *args)
    tgl = GraphFactory.build_laplacian_matrix_from_k_cluster(
        cent, *args, device="cpu", dtype=torch.float64)
    assert tgl.shape() == (20, 20) == jgl.shape()        # F′×F′
    assert tgl.nnodes == 5000
    np.testing.assert_allclose(tgl.matrix.numpy(), np.asarray(jgl.matrix),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tgl.degrees(), jgl.degrees(), rtol=1e-12)


def test_sparsity_check_raises_like_jax():
    cent = make_gaussian_blob(6, dims=30, spread=0.5, seed=13)
    args = (1e-9, 3, 3, 2.0, None, False, True, 100)   # no edges: 96.7%
    with pytest.raises(ValueError):
        JGraphFactory.build_laplacian_matrix_from_k_cluster(cent, *args)
    with pytest.raises(ValueError):
        GraphFactory.build_laplacian_matrix_from_k_cluster(
            cent, *args, device="cpu", dtype=torch.float64)


def test_laplacian_dtype_follows_index():
    rows = make_gaussian_blob(20, dims=6, spread=0.4, seed=11)
    gl = build_laplacian_matrix(torch.from_numpy(rows),
                                _params(GraphParams, 1.0, 3, 3, 2.0, None,
                                        False),
                                device="cpu", dtype=torch.float32)
    assert gl.matrix.dtype == torch.float32
    np.testing.assert_allclose(gl.matrix.sum(dim=1).numpy(), 0.0, atol=1e-6)
    assert torch.equal(gl.matrix, gl.matrix.T)
