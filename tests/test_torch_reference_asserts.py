"""tests/test_reference_asserts.py (the Rust reference's own asserted
values: τ floor and modes, distances, builder parameters, zero-vector
projection) run in both packages: each case once as the JAX package runs
it (by calling the JAX test itself) and once on ``arrowspace_torch`` on
the CPU in float64, on the same inputs.  The reference file and line of
each value is in the JAX case's docstring.

Tolerances: those of the reference's asserts (exact, 1e-12, 1e-10,
1e-8), unchanged."""

import numpy as np
import pytest
import torch

import test_reference_asserts as J
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.clustering import euclidean_dist
from arrowspace_torch.reduction import ImplicitProjection
from arrowspace_torch.taumode import TAU_FLOOR, TauMode, select_tau
from data import make_moons_hd


def _builder():
    return ArrowSpaceBuilder(device="cpu", dtype=torch.float64)


def test_tau_floor_value():
    J.test_tau_floor_value()
    assert TAU_FLOOR == 1e-10
    assert TAU_FLOOR < 1e-6


def test_select_tau_fixed_reference_values():
    J.test_select_tau_fixed_reference_values()
    energies = [0.1, 0.5, 1.0]
    assert select_tau(energies, TauMode.fixed(0.3)) == 0.3
    for bad in (-0.1, 0.0, float("nan"), float("inf")):
        assert select_tau(energies, TauMode.fixed(bad)) == TAU_FLOOR


def test_select_tau_mean_reference_values():
    J.test_select_tau_mean_reference_values()
    assert select_tau([1.0, 2.0, 3.0], TauMode.mean()) == \
        pytest.approx(2.0, abs=1e-12)
    assert select_tau([1.0, float("nan"), 3.0, float("inf"), 2.0],
                      TauMode.mean()) == pytest.approx(2.0, abs=1e-12)
    assert select_tau([float("nan"), float("inf"), float("-inf")],
                      TauMode.mean()) == TAU_FLOOR
    assert select_tau([], TauMode.mean()) == TAU_FLOOR


def test_select_tau_median_reference_values():
    J.test_select_tau_median_reference_values()
    assert select_tau([3.0, 1.0, 2.0], TauMode.median()) == 2.0
    assert select_tau([1.0, 2.0, 3.0, 4.0], TauMode.median()) == \
        pytest.approx(2.5, abs=1e-12)
    assert select_tau([5.0], TauMode.median()) == 5.0


def test_euclidean_dist_reference_values():
    J.test_euclidean_dist_reference_values()
    assert euclidean_dist([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]) == \
        pytest.approx(np.sqrt(3.0), abs=1e-10)
    assert euclidean_dist([3.5, -2.1, 4.8], [3.5, -2.1, 4.8]) == \
        pytest.approx(0.0, abs=1e-10)
    assert euclidean_dist([5.0], [2.0]) == pytest.approx(3.0, abs=1e-10)


def _params(noise, data_seed, *graph):
    items = make_moons_hd(50, noise=noise, hd_noise=0.4, dims=7,
                          seed=data_seed)
    _, gl = (_builder()
             .with_lambda_graph(*graph)
             .with_normalisation(False)
             .with_inline_sampling(None)
             .build(items.tolist()))
    return gl.graph_params


def test_builder_parameter_preservation_graph_factory():
    J.test_builder_parameter_preservation_graph_factory()
    gp = _params(0.2, 321, 0.123, 7, 3, 3.5, 0.456)
    assert (gp.eps, gp.k, gp.topk, gp.p, gp.sigma) == \
        (0.123, 7, 3 + 1, 3.5, 0.456)
    assert gp.normalise is False


def test_builder_parameter_preservation_unnormalised():
    J.test_builder_parameter_preservation_unnormalised()
    gp = _params(0.18, 456, 0.25, 6, 3, 2.5, 0.15)
    assert gp.eps == 0.25 and gp.k == 6 and gp.topk == 4
    assert gp.p == 2.5 and gp.sigma == 0.15 and gp.normalise is False


def test_implicit_projection_zero_vector():
    J.test_implicit_projection_zero_vector()
    out = np.asarray(ImplicitProjection(40, 10).project(np.zeros(40)))
    assert out.shape == (10,)
    assert np.all(np.abs(out) < 1e-10)


def test_project_query_zero_vector_through_builder():
    """The port's projection draws its own Gaussians (a projected build
    is held to properties in each package, not to the other's)."""
    J.test_project_query_zero_vector_through_builder()
    rng = np.random.default_rng(11)
    items = rng.uniform(0.1, 1.0, (60, 100))
    aspace, _gl = (_builder()
                   .with_lambda_graph(0.2, 4, 2, 2.0, None)
                   .with_dims_reduction(True, 0.8)
                   .with_sparsity_check(False)
                   .with_inline_sampling(None)
                   .build(items.tolist()))
    assert aspace.projection_matrix is not None
    projected = np.asarray(aspace.project_query(np.zeros(100)))
    assert projected.shape[0] == aspace.projection_matrix.reduced_dim
    assert np.all(np.abs(projected) < 1e-8)
