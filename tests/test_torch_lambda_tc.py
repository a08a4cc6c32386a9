"""The arithmetic of the λ body shared by K2 and K5 (csrc/lambda_tile.cuh:
the five quadratic forms of the λ formula on the tensor cores) emulated
on the CPU, and the gates of both kernels.

The emulation splits every float32 operand (the rows' graph coordinates
x, x² = x·x and x³ = x²·x, and L, W, W2) into TF32 hi and lo parts
(tests/test_torch_bintopk.py ``_tf32_rna``); at each 8-column k-step it
sums lo·hi, hi·lo and hi·hi, in that order, from zero with the tensor
core's truncating accumulate (each mma summed exactly, then truncated
toward zero) and joins the partial to the running product P with one
rounded add; then it folds P into each row's five sums by xᵢ, xᵢ² or xᵢ³
in the kernel's order (each thread's nodes by fused multiply-adds, the
quad's four threads as a tree, then the two warp groups).  The O(F) row
sums and the λ formula are the plain version's.

Rows: chip_smoke.py's generator (64 centres in [0.2, 0.8], noise 0.05)
over a 10 %-dense random graph, and cancellation-prone rows 0.5 ± 0.05
and 0.5 ± 0.01 over a dense graph, where S = Σ W(xᵢ - xⱼ)² and G's
numerator Σ W2(xᵢ - xⱼ)⁴, expanded by moments, are small differences of
large terms, so a one-sided error of the products moves λ far more than
their size.  At 0.5 ± 0.01 the plain float32 version itself is 7e-4 to
1.4e-3 from float64, so no other summation order agrees with it within
TOL = 1e-5 (chip_smoke.py's λ tolerance); there the emulated kernel is
held to float64 within twice the plain float32 version's distance.
Elsewhere it must also stay within TOL of the plain float32 version.
Partials of 2, 4 and 8 k-steps emulate at up to 1.4, 1.9 and 2.6 times
the plain version's distance from float64; on the card, partials of 4
k-steps read 4.6 times at 0.5 ± 0.05 (the card truncates more than this
emulation), hence a partial per k-step."""

import numpy as np
import pytest
import torch

from arrowspace_torch.config import DENOM_EPS
from arrowspace_torch.ops import lambda_batch as lb
from arrowspace_torch.ops import taulambda as tl
from test_torch_bintopk import _tf32_rna, _trunc32

TOL = 1e-5


def _split(v):
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


def _products(a, b):
    """a @ b.T (rows × graph rows) as the kernel sums it: per 8-column
    k-step lo·hi, hi·lo, hi·hi from zero, each summed exactly and
    truncated toward zero, then one rounded add into the product."""
    n8 = -(-a.shape[1] // 8) * 8
    a = torch.nn.functional.pad(a, (0, n8 - a.shape[1]))
    b = torch.nn.functional.pad(b, (0, n8 - b.shape[1]))
    (ah, al), (bh, bl) = _split(a), _split(b)
    prod = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
    for k0 in range(0, n8, 8):
        ks = slice(k0, k0 + 8)
        part = torch.zeros_like(prod)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = _trunc32(part.double()
                            + x[:, ks].double() @ y[:, ks].double().T)
        prod = prod + part
    return prod


def _fold(by, prod):
    """Σᵢ by·prod per row in the kernel's order: thread (group, t) of a
    quad adds nodes pass·32 + group·16 + 8j + 2t + c by fused
    multiply-adds, the quad sums as (t0 + t1) + (t2 + t3), then the
    groups."""
    n8 = -(-by.shape[1] // 8) * 8
    by = torch.nn.functional.pad(by, (0, n8 - by.shape[1])).double()
    prod = torch.nn.functional.pad(prod, (0, n8 - prod.shape[1])).double()
    groups = []
    for grp in range(2):
        quad = []
        for t in range(4):
            s = torch.zeros(by.shape[0], dtype=torch.float32)
            for p0 in range(0, n8, 32):
                for i in range(p0 + grp * 16 + 2 * t,
                               min(n8, p0 + grp * 16 + 16), 8):
                    for c in range(2):
                        s = (by[:, i + c] * prod[:, i + c] + s).float()
            quad.append(s)
        groups.append((quad[0] + quad[1]) + (quad[2] + quad[3]))
    return groups[0] + groups[1]


def _emulated_lambda(items, laplacian, taus):
    """λ of float32 rows as the tensor-core λ body computes it."""
    n = laplacian.shape[0]
    lap, w, w2, d_r, d_c, d2_r, d2_c = lb.graph_operands(laplacian,
                                                        torch.float32)
    x = items[:, :n]
    x2 = x * x
    x3 = x2 * x

    def form(a, m, by):
        return _fold(by, _products(a, m))

    num, xwx = form(x, lap, x), form(x, w, x)
    tb, tc, td = form(x2, w2, x2), form(x3, w2, x), form(x, w2, x3)
    den = (items * items).sum(dim=1)
    s_part = (x2 * d_r).sum(dim=1) + (x2 * d_c).sum(dim=1)
    ta = (x2 * x2 * d2_r).sum(dim=1) + (x2 * x2 * d2_c).sum(dim=1)
    zero = torch.zeros((), dtype=torch.float32)
    e = torch.where(den > DENOM_EPS, num / den.clamp_min(DENOM_EPS), zero)
    s = s_part - 2.0 * xwx
    g = torch.where(s > 0.0, (ta + 6.0 * tb - 4.0 * tc - 4.0 * td)
                    / (s * s).clamp_min(DENOM_EPS), zero).clamp(0.0, 1.0)
    return taus * (e / (e + taus)) + (1.0 - taus) * g


def _graph(n, seed, density):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < density)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    return np.diag(a.sum(1)) - a


def _rows(kind, n_rows, f, seed):
    rng = np.random.default_rng(seed)
    if kind == "smoke":
        centres = rng.uniform(0.2, 0.8, (64, f))
        return centres[rng.integers(0, 64, n_rows)] + rng.normal(
            0, 0.05, (n_rows, f))
    spread = {"spread_0.05": 0.05, "spread_0.01": 0.01}[kind]
    return 0.5 + rng.uniform(-spread, spread, (n_rows, f))


@pytest.mark.parametrize("kind", ["smoke", "spread_0.05", "spread_0.01"])
@pytest.mark.parametrize("f,n", [(768, 185), (128, 128)])
def test_three_tf32_lambda_body_keeps_float32_accuracy(f, n, kind):
    """K5's shape at the wide build (768, 185) and K2's at the cosine
    build (128, 128); errors seen: within 1.2e-7 of the plain version on
    the smoke's rows, 1.5e-6 and 2.5e-6 at ±0.05, 0.95 and 1.37 times the
    plain version's distance to float64 at ±0.01."""
    x = _rows(kind, 600, f, seed=f + n)
    lap = _graph(n, seed=n, density=0.1 if kind == "smoke" else 1.0)
    taus = np.random.default_rng(n).uniform(0.01, 1.0, x.shape[0])
    t32 = [torch.tensor(a, dtype=torch.float32) for a in (x, lap, taus)]
    ref64 = lb.lambda_batch_plain(*[torch.tensor(a) for a in (x, lap,
                                                               taus)])
    plain = lb.lambda_batch_plain(*t32)
    emu = _emulated_lambda(*t32)
    plain_err64 = float((plain.double() - ref64).abs().max())
    emu_err64 = float((emu.double() - ref64).abs().max())
    emu_err = float((emu - plain).abs().max())
    print(f"F={f} n={n} {kind}: emulated vs plain {emu_err:.3e}, vs "
          f"float64 {emu_err64:.3e}; plain vs float64 {plain_err64:.3e}")
    assert torch.isfinite(emu).all()
    assert emu_err64 <= 2.0 * plain_err64 + 1e-7
    if kind == "spread_0.01":
        assert plain_err64 > TOL          # plain float32 is no reference
    else:
        assert emu_err <= TOL


def test_identical_rows_get_identical_emulated_lambda():
    x = _rows("smoke", 200, 128, seed=4)
    x[150] = x[3]
    lap = torch.tensor(_graph(128, seed=4, density=0.1), dtype=torch.float32)
    lam = _emulated_lambda(torch.tensor(x, dtype=torch.float32), lap,
                           torch.full((200,), 0.3))
    assert torch.equal(lam[150], lam[3])


def _fp32_body_fits_k5(f, n):
    """lambda_batch_fits of the fp32 λ body (128 rows, 32×32 blocks)."""
    smem = (128 * (n + 1) + 3 * 32 * 33 + 8 * 128) * 4
    return 1 <= n <= f and smem <= 227 * 1024


def _fp32_body_fits_k2(f, n):
    """taulambda_fits of the fp32 λ body (128 rows, 32-column panels)."""
    smem = (128 * (f + 1) + 3 * n * 33 + 9 * 128) * 4
    return 1 <= n <= f <= 256 and smem <= 227 * 1024


@pytest.mark.parametrize("gate,old", [(lb.lambda_batch_fits,
                                       _fp32_body_fits_k5),
                                      (tl.taulambda_fits,
                                       _fp32_body_fits_k2)])
def test_gates_admit_every_shape_the_fp32_body_admitted(gate, old):
    """taumode routes on these gates, so the tensor-core body admits at
    least what the fp32 body did; K5 admits n <= 680, K2 every n <= F <=
    256."""
    shapes = [(f, n) for f in (1, 7, 33, 64, 128, 200, 256, 300, 420, 680,
                               768, 1536) for n in range(1, min(f, 800) + 1)]
    assert all(gate(f, n) for f, n in shapes if old(f, n))
    assert lb.lambda_batch_fits(680, 680)
    assert not lb.lambda_batch_fits(1024, 681)
    assert tl.taulambda_fits(256, 256) and not tl.taulambda_fits(257, 8)
