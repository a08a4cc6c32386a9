"""``prepare_corpus=False`` serving sessions of arrowspace_torch: bitwise
equal to the prepared sessions, and equal in ids to the JAX package's
sessions, on the CPU in float64.

With prepare_corpus=False a session keeps no prepared corpus copy: the
binned engine prepares one per step for K1 and its repair prepares the
rows it gathers from the raw corpus (the strided repair with
prepared=False); the merge engine prepares one per step for K3; the
energy engine prepares its centred z-plane per step and per repair.  The
kernels then read the same prepared operands, so every result equals
the prepared session's bitwise.  Duplicate rows planted deeper than the
bin depth in one bin make batch 0 flag and run the strided repair, so
the two sides' per-row normalisation (all N rows against the gathered
ones) is held bitwise, ties included.

The engine gates are lowered for a small corpus (core.BINNED_MIN_ITEMS,
energymaps.ENERGY_CHUNK), as tests/test_torch_bf16.py and
tests/test_torch_live.py lower them.  The indexes are built by the JAX
package and carried across (convert.from_jax_state).

Tolerances: port against port bitwise; ids against the JAX package
exact, scores within 1e-10 (float64, summed in another order)."""

import numpy as np
import pytest
import torch

from arrowspace_tpu.energymaps import EnergyParams as JEnergyParams
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.index import EnergySearchSession as JEnergySession
from arrowspace_tpu.index import SearchSession as JSession
from arrowspace_torch import core, energymaps
from arrowspace_torch import index as tindex
from arrowspace_torch.convert import from_jax_state
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops import bintopk as bt

CPU64 = dict(device="cpu", dtype=torch.float64)
N, F, K, B = 6000, 16, 10, 16


def _rows(n=N, f=F, seed=3):
    """Clustered rows; rows 0 and 1 each get depth+2 exact copies in one
    bin of K1 (and of K6, the same bins)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (24, f))
    rows = c[rng.integers(0, 24, n)] + rng.normal(0, 0.05, (n, f))
    depth, bins = bt.binned_topk_depth_for(K), bt.bins_target(K)
    for src in (0, 1):
        rows[src + 7 + bins * (2 + np.arange(depth + 2))] = rows[src]
    return rows


def _carry(j, rows):
    a = j.aspace
    proj = None if a.projection_matrix is None else \
        np.asarray(a.projection_matrix.matrix())
    return from_jax_state(rows, np.asarray(a.lambdas), np.asarray(j.gl.matrix),
                          a.taumode, projection=proj,
                          pad_tall_graphs=a.pad_tall_graphs, **CPU64)


@pytest.fixture(scope="module")
def cosine():
    rows = _rows()
    j = JIndex.build(rows, eps=1.0, k=6, topk=3, seed=11)
    return rows, j, _carry(j, rows)


@pytest.fixture(scope="module")
def energy():
    rows = _rows(seed=4)
    j = JIndex.build_energy(rows, JEnergyParams(allow_tall_graphs=True),
                            seed=5)
    return rows, j, _carry(j, rows)


def _batches(rows, seed):
    rng = np.random.default_rng(seed)
    q = rows[rng.integers(0, rows.shape[0], 3 * B)] * 1.02
    q[:2] = rows[:2] * 1.02                   # the two deep collisions
    return [q[:B], q[B:2 * B], q[2 * B:2 * B + 5]]      # a short tail


def _stream(sess, batches):
    got = list(sess.search_stream(batches))
    return (np.concatenate([s for s, _ in got]),
            np.concatenate([i for _, i in got]))


def _bitwise(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].dtype == b[0].dtype
    np.testing.assert_array_equal(a[0].view(np.int64), b[0].view(np.int64))


def _against_jax(got, jsess, batches):
    js, ji = _stream(jsess, batches)
    np.testing.assert_array_equal(got[1], ji)
    np.testing.assert_allclose(got[0], js, rtol=0, atol=1e-10)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_binned_session_without_a_prepared_copy(cosine, monkeypatch,
                                                precision):
    rows, j, t = cosine
    monkeypatch.setattr(core, "BINNED_MIN_ITEMS", 1000)
    batches = _batches(rows, 1)
    calls = br.strided_lambda_repair.calls
    prep = t.make_search_session(B, k=K, precision=precision)
    raw = t.make_search_session(B, k=K, precision=precision,
                                prepare_corpus=False)
    assert prep.kernel == raw.kernel == "binned"
    assert prep.precision == raw.precision == precision
    assert raw.prepare_corpus is False
    raw.warmup()
    want, got = _stream(prep, batches), _stream(raw, batches)
    assert br.strided_lambda_repair.calls >= calls + 2 + 1   # + warm-up
    _bitwise(got, want)
    # the copies of row 0 tie bitwise and come back in id order
    depth, bins = bt.binned_topk_depth_for(K), bt.bins_target(K)
    copies = [0] + (7 + bins * (2 + np.arange(depth + 2))).tolist()
    assert got[1][0, :len(copies)].tolist() == copies
    assert len(set(got[0][0, :len(copies)].tolist())) == 1
    if precision == "f32":
        _against_jax(got, JSession(j, B, k=K, prepare_corpus=False),
                     batches)


def test_merge_session_without_a_prepared_copy(cosine, monkeypatch):
    rows, j, t = cosine
    monkeypatch.setattr(core, "BINNED_MIN_ITEMS", 1000)
    monkeypatch.setattr(tindex, "binned_fits", lambda *a: False)
    batches = _batches(rows, 2)
    prep = t.make_search_session(B, k=K)
    raw = t.make_search_session(B, k=K, prepare_corpus=False)
    assert prep.kernel == raw.kernel == "merge"
    raw.warmup()
    got = _stream(raw, batches)
    _bitwise(got, _stream(prep, batches))
    _against_jax(got, JSession(j, B, k=K, prepare_corpus=False), batches)


def test_energy_session_without_a_prepared_plane(energy, monkeypatch):
    rows, j, t = energy
    monkeypatch.setattr(energymaps, "ENERGY_CHUNK", 1000)
    batches = _batches(rows, 3)
    prep = t.make_energy_session(B, k=K)
    raw = t.make_energy_session(B, k=K, prepare_corpus=False)
    assert prep.kernel == raw.kernel == "binned"
    assert raw.engine.zx is None and prep.engine.zx is not None
    raw.warmup()
    calls = br.strided_energy_repair.calls
    got = _stream(raw, batches)
    assert br.strided_energy_repair.calls > calls
    assert raw.engine.flagged_rows >= 2
    _bitwise(got, _stream(prep, batches))
    _against_jax(got, JEnergySession(j, B, k=K, prepare_corpus=False),
                 batches)


def test_energy_approx_needs_the_prepared_plane(energy, monkeypatch):
    rows, _j, t = energy
    monkeypatch.setattr(energymaps, "ENERGY_CHUNK", 1000)
    t.make_energy_session(B, k=K, approx=True)
    with pytest.raises(ValueError, match="prepare_corpus=False"):
        t.make_energy_session(B, k=K, approx=True, prepare_corpus=False)


def test_plain_session_ignores_prepare_corpus(cosine):
    """Below the row floor the plain scan serves both settings."""
    rows, j, t = cosine
    batches = _batches(rows, 4)
    raw = t.make_search_session(B, k=K, prepare_corpus=False)
    assert raw.kernel == "plain"
    got = _stream(raw, batches)
    _bitwise(got, _stream(t.make_search_session(B, k=K), batches))
    _against_jax(got, j.make_search_session(B, k=K), batches)


def test_unprepared_repair_rescores_as_the_prepared_one(cosine):
    """strided_lambda_repair(prepared=False) prepares the rows it gathers
    and equals the repair over the prepared corpus bitwise."""
    rows, _j, t = cosine
    x, lam = t.aspace.data, t.aspace.lambdas
    q = torch.from_numpy(rows[:2] * 1.02)
    ql = torch.tensor([0.3, 0.6], dtype=torch.float64)
    s, i, flags, det = bt.binned_lambda_topk(q, ql, x, lam, 0.9, k=K)
    assert flags.all()
    args = (q, ql, det.numpy(), s[:, K - 1].numpy(), i.numpy())
    xh, xl = bt.prepare_binned_corpus(x, lam)
    a = br.strided_lambda_repair(*args, xh, xl, 0.9, k=K, n=N,
                                 prepared=True, cur_scores=s.numpy())
    b = br.strided_lambda_repair(*args, x, lam, 0.9, k=K, n=N,
                                 prepared=False, cur_scores=s.numpy())
    _bitwise(b, a)


@pytest.mark.parametrize("dtype,f", [(torch.float32, 99),
                                     (torch.float64, 13)])
def test_unprepared_repair_gathers_rows_at_the_corpus_width(monkeypatch,
                                                            dtype, f):
    """The strided repair over a raw corpus of F features prepares each
    row it gathers at the prepared corpus's width (operand_width: F
    zero-padded to whole 16 bytes, 100 float32 or 14 float64 features),
    so it rescores the same operands and equals the repair over the
    prepared corpus bitwise."""
    x = torch.as_tensor(_rows(f=f), dtype=dtype)
    lam = torch.linspace(0.1, 0.9, N, dtype=dtype)
    depth, bins = bt.binned_topk_depth_for(K), bt.bins_target(K)
    for src in (0, 1):           # the copies' λ as their source's
        lam[src + 7 + bins * (2 + np.arange(depth + 2))] = float(lam[src])
    width = bt.operand_width(f, dtype)
    assert width == -(-f * dtype.itemsize // 16) * 16 // dtype.itemsize
    assert width > f
    xh, xl = bt.prepare_binned_corpus(x, lam)
    assert xh.shape[1] == width
    q = x[:2] * 1.02
    ql = lam[:2].clone()
    s, i, flags, det = bt.binned_lambda_topk(q, ql, x, lam, 0.9, k=K)
    assert flags.all()
    widths = []
    row_dots = br.row_dots

    def spy(qhat, rows):
        widths.append((qhat.shape[-1], rows.shape[-1]))
        return row_dots(qhat, rows)
    monkeypatch.setattr(br, "row_dots", spy)
    args = (q, ql, det.numpy(), s[:, K - 1].numpy(), i.numpy())
    a = br.strided_lambda_repair(*args, xh, xl, 0.9, k=K, n=N,
                                 prepared=True, cur_scores=s.numpy())
    b = br.strided_lambda_repair(*args, x, lam, 0.9, k=K, n=N,
                                 prepared=False, cur_scores=s.numpy())
    assert widths and set(widths) == {(width, width)}
    _bitwise(b, a)
