"""``use_pallas`` of ArrowSpace.search_lambda_aware_batch and
ArrowIndex.search against the JAX package, on the CPU.

The JAX package's ``use_pallas=True`` reaches its Pallas kernels without
``interpret`` and raises off a TPU, so the port's True is held to the
JAX kernels called directly in interpret mode
(pallas_binned_topk_with_repair, fused_lambda_topk) and to JAX's
``use_pallas=False`` full scan, at a corpus just above BINNED_MIN_ITEMS
(65536) rows and at one below it.  The port's gate is keyed on size:
None takes K1 above the row floor and the plain scan below it, True K1
at any row count (K3 where K1 does not admit F), False the plain scan;
on the CPU each kernel runs its plain version, counted here by wrapping
the plain versions.

Tolerances: ids exact (ties to the lowest id); float32 scores within
1e-6 (one dot product summed in another order), float64 within 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arrowspace_tpu.core import ArrowSpace as JSpace
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.ops.pallas_topk import fused_lambda_topk as j_merge
from arrowspace_tpu.ops.search import \
    pallas_binned_topk_with_repair as j_binned
from arrowspace_torch import core
from arrowspace_torch.core import ArrowSpace
from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import topk as tk

ABOVE, BELOW = core.BINNED_MIN_ITEMS + 512, 3000


def _data(n, f=16, b=5, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.1, 1.0, (b, f)).astype(np.float32)
    ql = rng.uniform(0, 1, (b,)).astype(np.float32)
    x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    xl = rng.uniform(0, 1, (n,)).astype(np.float32)
    x[n // 2 + 1] = x[n // 2]                 # an exact duplicate pair
    xl[n // 2 + 1] = xl[n // 2]
    q[0] = x[n // 2] * 1.5                    # whose tie query 0 meets
    ql[0] = xl[n // 2]
    return q, ql, x, xl


def _spaces(x, xl):
    t = ArrowSpace.new(x, device="cpu", dtype=torch.float32)
    t.update_lambdas(torch.from_numpy(xl))
    j = JSpace.new(x)
    j.data, j.lambdas = jnp.asarray(x), jnp.asarray(xl)
    return t, j


@pytest.fixture
def counted(monkeypatch):
    """Calls of K1's and K3's plain versions (what the CPU runs where the
    card launches the kernels)."""
    seen = {"k1": 0, "k3": 0}
    k1, k3 = bt.binned_topk_pool_plain, tk.merge_topk_partial_plain

    def c1(*a, **kw):
        seen["k1"] += 1
        return k1(*a, **kw)

    def c3(*a, **kw):
        seen["k3"] += 1
        return k3(*a, **kw)
    monkeypatch.setattr(bt, "binned_topk_pool_plain", c1)
    monkeypatch.setattr(tk, "merge_topk_partial_plain", c3)
    return seen


@pytest.fixture(scope="module")
def above():
    return _data(ABOVE, seed=1)


@pytest.fixture(scope="module")
def below():
    return _data(BELOW, seed=2)


@pytest.fixture(scope="module")
def jax_refs(above, below):
    """JAX's kernels in interpret mode and its use_pallas=False scan."""
    out = {}
    for name, (q, ql, x, xl) in (("above", above), ("below", below)):
        _t, j = _spaces(x, xl)
        out[name] = {
            "binned": j_binned(jnp.asarray(q), jnp.asarray(ql),
                               jnp.asarray(x), jnp.asarray(xl), 0.9, k=10,
                               interpret=True),
            "merge": j_merge(jnp.asarray(q), jnp.asarray(ql),
                             jnp.asarray(x), jnp.asarray(xl), 0.9, k=10,
                             interpret=True),
            "scan": j.search_lambda_aware_batch(q, ql, 10, 0.9,
                                                use_pallas=False),
        }
    return out


def _same(got, want, atol=1e-6):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=atol)


@pytest.mark.parametrize("use_pallas", [None, True, False])
@pytest.mark.parametrize("size", ["above", "below"])
def test_use_pallas_routes_and_matches_jax(size, use_pallas, above, below,
                                           jax_refs, counted):
    q, ql, x, xl = above if size == "above" else below
    t, _j = _spaces(x, xl)
    got = t.search_lambda_aware_batch(q, ql, 10, 0.9, use_pallas=use_pallas)
    kernels = use_pallas or (use_pallas is None and size == "above")
    assert counted["k1"] == (1 if kernels else 0)
    assert counted["k3"] == 0
    refs = jax_refs[size]
    _same(got, refs["scan"])
    _same(got, refs["merge"])
    _same(got, refs["binned"])
    # the duplicate pair: ties to the lowest id
    assert got[1][0, :2].tolist() == [x.shape[0] // 2, x.shape[0] // 2 + 1]


def test_use_pallas_true_takes_k3_above_k1s_gate(counted):
    """F beyond K1's float32 gate: True takes K3 at any row count, as
    the JAX package's use_pallas=True takes its merge kernel off a TPU."""
    f = 1300
    assert not bt.bintopk_fits(f)
    q, ql, x, xl = _data(700, f=f, b=3, seed=3)
    t, j = _spaces(x, xl)
    got = t.search_lambda_aware_batch(q, ql, 7, 0.8, use_pallas=True)
    assert counted == {"k1": 0, "k3": 1}
    want = j_merge(*map(jnp.asarray, (q, ql, x, xl)), 0.8, k=7,
                   interpret=True)
    _same(got, want)
    _same(got, j.search_lambda_aware_batch(q, ql, 7, 0.8, use_pallas=False))


def test_use_pallas_true_refuses_k_past_the_kernels():
    q, ql, x, xl = _data(600, seed=4)
    t, _j = _spaces(x, xl)
    with pytest.raises(ValueError, match="k <= 128"):
        t.search_lambda_aware_batch(q, ql, 129, 0.9, use_pallas=True)
    s, i = t.search_lambda_aware_batch(q, ql, 129, 0.9, use_pallas=False)
    assert i.shape == (5, 129)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    c = rng.uniform(0.2, 0.8, (10, 24))
    rows = c[rng.integers(0, 10, BELOW)] + rng.normal(0, 0.05, (BELOW, 24))
    j = JIndex.build(rows, eps=1.0, k=6, topk=3, seed=11)
    t = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=11,
                         device="cpu", dtype=torch.float64)
    return rows, j, t


@pytest.mark.parametrize("precision", ["f32", "f64_rescore"])
@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_index_search_passes_use_pallas(built, use_pallas, precision,
                                        counted):
    """ArrowIndex.search passes use_pallas on to every engine, the
    f64_rescore candidate pool included; below the row floor True runs
    K1's plain version in float64 and its ids equal JAX's float64 scan
    (use_pallas=False: its True needs a TPU)."""
    rows, j, t = built
    q = rows[[5, 77, 1500]] * 1.02
    ts, ti = t.search(q, k=8, alpha=0.9, use_pallas=use_pallas,
                      precision=precision)
    assert counted["k1"] == (1 if use_pallas else 0)
    js, ji = j.search(q, k=8, alpha=0.9, use_pallas=False,
                      precision=precision)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-12, atol=1e-12)
