"""The JAX package's kernel suites on the card: the seeded draws of
tests/test_pallas_kernels.py, tests/test_bin_repair.py and
tests/test_energy_approx.py (replayed by tests/suite_draws.py) with CUDA
tensors, so each draw launches the kernel, held against the kernel's
plain version on the same operands:

- K1 in both modes: the fuzz (:290-327), the deep-depth fuzz (:329-365),
  the k-band at k = 64, 100, 128 (:403-445) and the α = 1 anchor
  (:674-692);
- K3 in both modes: test_fused_topk_*'s cases, k past a tile's tail
  (:21-72);
- K6: the energy fuzz (:607-641);
- K7: the certified rows of test_energy_approx.py:101-123, against the
  exact chunked scan too;
- the repair path end to end: the storm fuzz (test_bin_repair.py:
  264-313) through ops.search.pallas_binned_topk_with_repair, and
  through K1 at one chunk (where the storms collide and flag, as in the
  JAX layout) and ops.bin_repair.repair_flagged: every row, flagged rows
  included, equal to the plain full scan;
- K2 and K5: λ of the reference's 384-d fixtures against the CSR-loop
  oracle (tests/oracle_csr.py), and K2, K4, K5 on the suites' λ and τ
  draws against their plain versions.

The draws run through chip_smoke.py's phase [16] functions, the same
code the smoke runs.  These tests need an NVIDIA card and nvcc, and skip
without them.  This file imports no JAX, so on a machine without JAX run
it alone:

    python -m pytest tests/test_torch_cuda_suites.py -q -m cuda --noconftest

Tolerances (chip_smoke.py, tests/test_torch_cuda.py): float32 scores
within 1e-5 of the plain version's and of float64 (energy scores 5e-5,
or, for near duplicates, three times the plain version's own distance
from float64, chip_smoke.py ``energy_tol``),
ids equal outside near-ties (where both scores lie within twice the
measured error, chip_smoke.py ``agree``), flags and certifications alike
outside such near-ties, τ bitwise; λ within 1e-5 of the plain version,
or, where the plain float32 λ is itself far from float64, within twice
its distance (tests/test_torch_lambda_tc.py), against float64 from the
CSR oracle here."""

import pytest
import torch

import chip_smoke as cs
from oracle_csr import dense_to_csr, synthetic_lambda_csr_oracle

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _counted(rec, draws):
    assert rec["draws"] == draws and rec["launches"] >= draws
    return rec


@pytest.mark.parametrize("use_bf16", [False, True])
def test_k1_suite_draws(dev, use_bf16):
    d = cs.suite_draws()
    draws = len(list(d.k1_fuzz())) + len(list(d.k1_deep())) + \
        len(d.KBAND) + 1
    rec = _counted(cs.suite_k1(torch, dev, use_bf16=use_bf16), draws)
    assert rec["max_abs_err"] <= cs.TOL


@pytest.mark.parametrize("use_bf16", [False, True])
def test_k3_suite_draws(dev, use_bf16):
    rec = _counted(cs.suite_k3(torch, dev, use_bf16=use_bf16),
                   len(cs.suite_draws().MERGE_CASES))
    assert rec["max_abs_err"] <= cs.TOL


def test_k6_energy_fuzz(dev):
    _counted(cs.suite_k6(torch, dev), 8)


def test_k7_certified_rows(dev):
    _counted(cs.suite_k7(torch, dev), len(cs.suite_draws().APPROX_CASES))


def test_storm_fuzz_through_search_equals_the_full_scan(dev):
    """At the wrapper's chunking and at one chunk, where the storms
    collide and flag, their rows repaired (suite_storms)."""
    rec = cs.suite_storms(torch, dev)
    assert rec["draws"] == 8 and rec["flagged"] > 0 and rec["repairs"] > 0
    assert rec["max_abs_err"] <= cs.TOL


def test_k2_k4_k5_suite_draws(dev):
    rec = cs.suite_lambda_tau(torch, dev)
    for name in ("taulambda", "select_tau", "lambda_batch"):
        assert rec[name]["launches"] == rec[name]["draws"] > 0
    assert rec["select_tau"]["max_abs_err"] == 0.0


def _csr(x, lap, tau):
    indptr, indices, data = dense_to_csr(lap)
    return torch.tensor([synthetic_lambda_csr_oracle(
        x[i], indptr, indices, data, float(tau[i]))
        for i in range(x.shape[0])], dtype=torch.float64)


@pytest.mark.parametrize("kernel", ["K2", "K5"])
def test_k2_k5_fixtures_against_the_csr_oracle(dev, kernel):
    """λ of the reference's fixtures: K2 over the rows cut to 256
    features and a 256-node graph, K5 over the 384-wide rows and a
    192-node graph (the partial-coordinate case), each against the CSR
    oracle given the τ the kernel's path uses."""
    from arrowspace_torch.ops import lambda_batch as lb
    from arrowspace_torch.ops import taulambda as tl
    from arrowspace_torch.taumode import TauMode, select_tau_batch
    seen = 0
    for what, x_h, lap_h, k in cs._fixture_graphs(torch):
        if k != kernel:
            continue
        x = torch.tensor(x_h, dtype=torch.float32, device=dev)
        lap = torch.tensor(lap_h, dtype=torch.float32, device=dev)
        if kernel == "K2":
            before = tl.fused_taulambda.launches
            lam_k, tau = tl.fused_taulambda(x, lap, TauMode.median())
            lam_p, tau_p = tl.taulambda_plain(x, lap, TauMode.median())
            assert torch.equal(tau, tau_p)
            assert tl.fused_taulambda.launches == before + 1
        else:
            tau = select_tau_batch(x, TauMode.median())
            before = lb.fused_lambda_batch.launches
            lam_k = lb.fused_lambda_batch(x, lap, tau)
            lam_p = lb.lambda_batch_plain(x, lap, tau)
            assert lb.fused_lambda_batch.launches == before + 1
        torch.cuda.synchronize()
        oracle = _csr(x.double().cpu().numpy(),
                      lap.double().cpu().numpy(), tau.double().cpu())
        cs.lambda_within(f"{kernel} {what}", lam_k.cpu(), lam_p.cpu(),
                         oracle)
        err_p = float((lam_p.cpu().double() - oracle).abs().max())
        err_k = float((lam_k.cpu().double() - oracle).abs().max())
        assert err_k <= max(cs.TOL, 2.0 * err_p), (what, err_k, err_p)
        seen += 1
    assert seen == 2

