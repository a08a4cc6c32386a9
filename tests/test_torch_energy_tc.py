"""The arithmetic of the energy tile (csrc/energy_tile.cuh: K6 and K7 on
the tensor cores) emulated on the CPU, on chip_smoke.py's z-plane, and
the z-plane centring of the binned energy engine.

The emulation (tests/test_torch_bintopk.py ``_tensor_core_dot``) splits
every float32 value into TF32 hi and lo parts, accumulates lo·hi, hi·lo
and hi·hi per 8-feature k-step with the tensor core's truncating
accumulate, and joins 32-feature partials with one rounded add; d² and
u = w_D/(1+√d²) then round as the kernels' tails do (energy_plane).  The
plane: chip_smoke.py's generator (64 centres in [0.2, 0.8], noise 0.05,
F = 128) at 4000 rows, a seeded Gaussian JL matrix to G = 64 (scaled by
1/√G), queries the rows ×1.02, whose nearest neighbours sit at d² ≈ 0.01
where u magnifies an error of d² about twofold.

Tolerances: E_TOL = 5e-5 is chip_smoke.py's energy score tolerance; the
shipped scheme (the plane centred on its mean, a zeroed partial per 32
features) must keep u within E_TOL/2 of float64, so that the kernel and
a float32 plain version, each on its own rounding, stay within E_TOL of
each other.  The emulation sums each mma exactly before it truncates;
the card truncates more (a partial per 64-feature slice on the centred
plane: 1.3e-5 emulated, 2.4e-5 measured with tools/kernel_ablation.py),
so the shipped length was chosen on the card.  Ids of certified or unflagged rows equal the
float64 oracle's outside near-ties: two ids may trade places only where
their float64 scores lie within twice the measured score error."""

import numpy as np
import pytest
import torch

from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops import energy_approx as ea
from arrowspace_torch.ops import energy_bintopk as eb
from test_torch_bintopk import _THREE_TF32, _tensor_core_dot

E_TOL = 5e-5
WL, WD, K = 1.0, 0.5, 10


def _smoke_plane(n=4000, b=256, seed=11, centred=True):
    """(queries (b, 64), rows (n, 64), query λ, row λ) in float32; row
    300 is an exact copy of row 7."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.2, 0.8, (64, 128))
    x = centres[rng.integers(0, 64, n)] + rng.normal(0, 0.05, (n, 128))
    x[300] = x[7]
    proj = rng.normal(size=(128, 64)) / 8.0
    z = (x @ proj).astype(np.float32)
    zq = ((x[rng.integers(0, n, b)] * 1.02) @ proj).astype(np.float32)
    if centred:
        mu = z.mean(axis=0, dtype=np.float32)
        z, zq = z - mu, zq - mu
    lam = rng.uniform(0, 0.05, n).astype(np.float32)
    qlam = rng.uniform(0, 0.05, b).astype(np.float32)
    return (torch.from_numpy(zq), torch.from_numpy(z),
            torch.from_numpy(qlam), torch.from_numpy(lam))


def _tile_dot(a, b):
    """The shipped scheme's dot products: 3×TF32, truncating, a zeroed
    partial per 32 features."""
    return _tensor_core_dot(a, b, _THREE_TF32, truncate=True, partial=32)


def _u(zq, z, dot):
    """(u of the kernel's tail from float32 dot products, float64 u)."""
    qn, xn = (zq * zq).sum(dim=1), (z * z).sum(dim=1)
    d2 = (qn[:, None] + xn[None, :]) - 2.0 * dot
    q64, x64 = zq.double(), z.double()
    d64 = ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :]
           - 2.0 * q64 @ x64.T).clamp_min(0.0)
    return eb.energy_u(d2, WD), WD / (1.0 + d64.sqrt())


@pytest.mark.parametrize("centred,partial,within", [
    (True, 32, True),      # shipped: centred plane, 32-feature partials
    (True, 8, True),       # a partial per k-step: more adds, no need
    (False, 64, False),    # raw plane (|z|² ≈ 45): one partial a slice
    (False, None, False),  # raw plane, one truncating run over all of G
])
def test_energy_tile_precision_on_the_smoke_plane(centred, partial, within):
    """u from the emulated tensor-core d² against float64: the shipped
    scheme stays within E_TOL/2; on the raw plane a truncating partial
    per 64-feature slice (K1's scheme) does not.  Identical rows are
    scored bitwise alike."""
    zq, z, _, _ = _smoke_plane(centred=centred)
    dot = _tensor_core_dot(zq, z, _THREE_TF32, truncate=True,
                           partial=partial)
    u, u64 = _u(zq, z, dot)
    err = float((u.double() - u64).abs().max())
    assert (err <= E_TOL / 2) == within, err
    assert torch.equal(u[:, 300], u[:, 7])


def test_rounded_accumulate_would_hide_the_truncation():
    """The same product with a rounding accumulate (what PR 5's first
    emulation modelled) misses the raw plane's truncation error: the
    card, not a rounding model, decides the scheme."""
    zq, z, _, _ = _smoke_plane(centred=False)
    u_t, u64 = _u(zq, z, _tensor_core_dot(zq, z, _THREE_TF32,
                                          truncate=True, partial=64))
    u_r, _ = _u(zq, z, _tensor_core_dot(zq, z, _THREE_TF32, partial=64))
    err_t = float((u_t.double() - u64).abs().max())
    err_r = float((u_r.double() - u64).abs().max())
    assert err_r < err_t / 2


def _agree_outside_near_ties(s, i, oracle, zq, qlam, z, lam, ok):
    """Rows ``ok``: ids equal the float64 oracle's except where two ids'
    float64 scores lie within twice the measured score error."""
    s64, i64 = oracle
    d = zq.double()[:, None, :] - z.double()[i]
    got64 = WD / (1.0 + (d * d).sum(-1).sqrt()) - WD \
        - WL * (qlam.double()[:, None] - lam.double()[i]).abs()
    err = float((s.double() - got64)[ok].abs().max())
    assert err <= E_TOL / 2
    for r, j in zip(*np.nonzero((i != i64).numpy() & ok.numpy()[:, None])):
        assert abs(float(got64[r, j]) - float(s64[r, j])) <= 2.0 * err


@pytest.mark.parametrize("kernel", ["k6", "k7"])
def test_flush_on_emulated_tensor_core_d2_matches_float64(monkeypatch,
                                                         kernel):
    """K6's flush, and K7's rescore and certification, with the pool
    scored from the emulated tensor-core dot products on the centred
    plane: unflagged (K6) and certified (K7) rows equal the float64
    oracle's top-k outside near-ties, within E_TOL/2."""
    zq, z, qlam, lam = _smoke_plane(n=4000, b=64)
    n = z.shape[0]
    oracle = eb.energy_topk_chunked(zq.double(), qlam.double(), z.double(),
                                    lam.double(), WL, WD, k=K)
    zx, xl, xn = eb.prepare_binned_energy_corpus(z, lam)
    if kernel == "k6":
        monkeypatch.setattr(eb, "dot_plane", _tile_dot)
        s, i, fl, _ = eb.binned_energy_topk(zq, qlam, zx, xl, xn, WL, WD,
                                            k=K, n=n)
    else:
        monkeypatch.setattr(ea, "dot_plane", _tile_dot)
        z_s, xn_s = ea.prepare_energy_chord_sample(zx, xn, n)
        s, i, fl = ea.binned_energy_topk_approx(zq, qlam, zx, xl, xn, z_s,
                                                xn_s, WL, WD, k=K, n=n)
    ok = ~fl
    assert bool(ok.any())
    _agree_outside_near_ties(s, i, oracle, zq, qlam, z, lam, ok)


def test_engine_centres_the_plane_and_its_queries():
    """BinnedEnergyTopK serves the z-plane centred on its mean: a plane
    shifted by a constant vector gives the same ids and, to float32
    rounding of the shift, the same scores, where the raw float32 scan of
    the shifted plane loses the near neighbours' scores to cancellation
    (|z|² ≈ 4000)."""
    zq, z, qlam, lam = _smoke_plane(n=70_000, b=16, centred=False)
    shift = torch.full((64,), 8.0)
    base = br.BinnedEnergyTopK(z, lam, WL, WD, K)
    moved = br.BinnedEnergyTopK(z + shift, lam, WL, WD, K)
    assert torch.allclose(moved.centre - base.centre, shift, atol=1e-5)
    assert float(moved.zx[:z.shape[0]].mean(dim=0).abs().max()) < 1e-4
    s0, i0 = base(zq, qlam)
    s1, i1 = moved(zq + shift, qlam)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-5)
    raw, _ = eb.energy_topk_chunked(zq + shift, qlam, z + shift, lam, WL, WD,
                                    k=K)
    assert float(np.abs(raw.numpy() - s0).max()) > E_TOL
