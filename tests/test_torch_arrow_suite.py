"""tests/test_arrow.py (ArrowItem and ArrowSpace, mirroring the
reference's tests/test_arrow.rs and the magnitude checks of
test_laplacian_unnormalised.rs) run in both packages: each case once as
the JAX package runs it (by calling the JAX test itself) and once on
``arrowspace_torch.core`` on the CPU in float64, on the same rows.  The
seeded, unprojected builds of the mutation cases are also held to the
JAX package's builds: the same mutated row and λ.

Tolerances: the JAX case's own (exact, 1e-9, 1e-12); λ across packages
within 1e-10 (float64, another summation order)."""

import copy

import numpy as np
import pytest
import torch

import test_arrow as J
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import (ArrowFeature, ArrowItem, ArrowSpace,
                                   densematrix_to_vecvec)
from arrowspace_torch.taumode import TauMode
from data import make_moons_hd


def _builder():
    return ArrowSpaceBuilder(device="cpu", dtype=torch.float64)


def test_arrow_item_basics():
    J.test_arrow_item_basics()
    a = ArrowItem([1.0, 2.0, 3.0], 0.5)
    b = ArrowItem([4.0, 5.0, 6.0], 0.0)
    assert len(a) == 3 and not a.is_empty()
    assert a.dot(b) == pytest.approx(32.0)
    assert ArrowItem.norm([3.0, 4.0]) == pytest.approx(5.0)
    assert a.euclidean_distance(ArrowItem([1.0, 2.0, 3.0], 0.0)) == 0.0
    assert ArrowItem([1.0, 1.0], 0).euclidean_distance(
        ArrowItem([4.0, 5.0], 0)) == pytest.approx(5.0)


def test_cosine_similarity_zero_guard():
    J.test_cosine_similarity_zero_guard()
    assert ArrowItem([1.0, 0.0], 0.0).cosine_similarity([0.0, 1.0]) == \
        pytest.approx(0.0)
    assert ArrowItem([0.0, 0.0], 0.0).cosine_similarity([1.0, 1.0]) == 0.0


def test_lambda_similarity_blend():
    J.test_lambda_similarity_blend()
    a = ArrowItem([1.0, 0.0], 0.5)
    assert a.lambda_similarity(ArrowItem([1.0, 0.0], 0.6), 0.7) == \
        pytest.approx(0.97)
    assert a.lambda_component_similarity(ArrowItem([1.0, 0.0], 5.0)) == 0.0
    with pytest.raises(AssertionError):
        a.lambda_similarity(ArrowItem([1.0, 0.0, 0.0], 0.1), 0.5)


def test_item_inplace_ops():
    J.test_item_inplace_ops()
    a = ArrowItem([1.0, 2.0], 0.0)
    a.add_inplace(ArrowItem([3.0, 4.0], 0.0))
    np.testing.assert_allclose(a.item, [4.0, 6.0])
    a.mul_inplace(ArrowItem([2.0, 0.5], 0.0))
    np.testing.assert_allclose(a.item, [8.0, 3.0])
    a.scale(0.5)
    np.testing.assert_allclose(a.item, [4.0, 1.5])


def test_arrowspace_new_validation():
    J.test_arrowspace_new_validation()
    with pytest.raises(AssertionError):
        ArrowSpace.new(np.zeros((0, 3)))
    with pytest.raises(AssertionError, match="one arrow"):
        ArrowSpace.new([[1.0, 2.0]])


def test_get_set_item_and_feature():
    J.test_get_set_item_and_feature()
    aspace = ArrowSpace.new(np.arange(12, dtype=float).reshape(4, 3),
                            device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(aspace.get_item(2).item, [6.0, 7.0, 8.0])
    np.testing.assert_allclose(aspace.get_feature(1).feature,
                               [1.0, 4.0, 7.0, 10.0])
    aspace.set_item(0, ArrowItem([9.0, 9.0, 9.0], 0.0))
    np.testing.assert_allclose(np.asarray(aspace.data[0]), 9.0)
    aspace.set_feature(2, ArrowFeature([1.0, 1.0, 1.0, 1.0]))
    np.testing.assert_allclose(np.asarray(aspace.data[:, 2]), 1.0)
    with pytest.raises(AssertionError):
        aspace.get_item(99)


def _built_space(builder):
    rows = make_moons_hd(40, noise=0.1, hd_noise=0.05, dims=8, seed=2)
    return (builder.with_lambda_graph(1.0, 5, 3, 2.0, None)
            .with_seed(4).build(rows.tolist()))


def _both():
    return _built_space(_builder()), _built_space(JBuilder())


def test_add_items_recomputes_lambdas():
    J.test_add_items_recomputes_lambdas()
    (aspace, gl), (j_aspace, j_gl) = _both()
    before = np.asarray(aspace.lambdas).copy()
    aspace.add_items(0, 1, gl)
    j_aspace.add_items(0, 1, j_gl)
    after = np.asarray(aspace.lambdas)
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, np.asarray(j_aspace.lambdas),
                               rtol=1e-10, atol=1e-14)
    with pytest.raises(AssertionError):
        aspace.add_items(0, 999, gl)


def test_scale_item_lambda_invariance():
    J.test_scale_item_lambda_invariance()
    aspace, gl = _built_space(_builder())
    aspace.taumode = TauMode.fixed(0.5)
    aspace.recompute_lambdas(gl)
    before = np.asarray(aspace.lambdas).copy()
    aspace.scale_item(3, 2.0, gl)
    np.testing.assert_allclose(before, np.asarray(aspace.lambdas),
                               rtol=1e-9)


def test_mul_items():
    J.test_mul_items()
    aspace, gl = _built_space(_builder())
    row0 = np.asarray(aspace.data[0]).copy()
    row1 = np.asarray(aspace.data[1]).copy()
    aspace.mul_items(0, 1, gl)
    np.testing.assert_allclose(np.asarray(aspace.data[0]), row0 * row1,
                               rtol=1e-12)


def test_update_lambdas_shape_check():
    J.test_update_lambdas_shape_check()
    aspace, _ = _built_space(_builder())
    with pytest.raises(AssertionError):
        aspace.update_lambdas(np.zeros(3))


def test_unnormalised_magnitude_sensitivity():
    J.test_unnormalised_magnitude_sensitivity()
    rows = make_moons_hd(50, noise=0.1, hd_noise=0.05, dims=8, seed=6)
    scaled = rows.copy()
    scaled[::2] *= 100.0

    def build(b, r):
        return np.asarray((b.with_lambda_graph(1.0, 5, 3, 2.0, None)
                           .with_seed(8).build(r.tolist()))[0].lambdas)
    l1, l2 = build(_builder(), rows), build(_builder(), scaled)
    assert not np.allclose(l1, l2)
    np.testing.assert_allclose(l2, build(JBuilder(), scaled), rtol=1e-10,
                               atol=1e-14)


def test_cluster_of_and_lambdas_accessor():
    J.test_cluster_of_and_lambdas_accessor()
    aspace, _ = _built_space(_builder())
    assert aspace.lambdas_list().shape == (40,)
    seen = {aspace.cluster_of(i) for i in range(aspace.nitems)}
    assert any(v is not None for v in seen)
    assert aspace.cluster_of(10 ** 6) is None


def test_densematrix_to_vecvec():
    J.test_densematrix_to_vecvec()
    assert densematrix_to_vecvec(np.arange(6).reshape(2, 3)) == \
        [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]


def test_single_row_lambda_refresh_equals_full_recompute():
    J.test_single_row_lambda_refresh_equals_full_recompute()
    aspace, gl = _built_space(_builder())
    aspace2 = copy.copy(aspace)
    aspace2.data = aspace.data.clone()
    aspace2.lambdas = aspace.lambdas.clone()
    aspace.add_items(2, 5, gl)
    aspace2.data[2] += aspace2.data[5]
    aspace2.recompute_lambdas(gl)
    np.testing.assert_allclose(np.asarray(aspace.lambdas),
                               np.asarray(aspace2.lambdas), rtol=1e-9)
