"""The τ selection of K4 (csrc/select_tau.cu) and of K2's τ phase
(csrc/taulambda.cu), both on common.cuh's radix select, emulated on the
CPU, and K4's gate.

The emulation follows the kernel step by step: the lane layout (16-byte
loads, slot 4j + c of lane l holding value 4(32j + l) + c, where F % 4
== 0; else slot m holding value 32m + l), each value's sortable int y
(ASP_NO_VALUE for a non-finite value or a slot past the row), the finite
count and the [lo, hi] range by warp reductions, the offsets u = y - lo
(ASP_NO_OFFSET, 2³² - 1, where there is no value), then the radix
select: 8-bit digits from the range's top bit down, t = (u ^ ans) >>
shift the digit of a candidate and lim or more for any other offset, a
256-bin histogram of the candidates per pass, lane l scanning digits 8l
.. 8l+7, the owner lane's digit, count below and count in the digit, the
early end by a warp min or max when the rank is the digit's least or
greatest candidate, and the median's second value (the count at or below
the first, then the least offset above it). It is held bitwise against
``taumode.select_tau_sorted`` (the plain version), the JAX package's
``select_tau_batch`` and its Pallas kernel ``fused_select_tau`` in
interpret mode (at the widths its gate admits), on seeded rows of
awkward kinds: constant, negative, mixed -0.0/+0.0, denormal, heavy with
duplicates, sorted and reverse-sorted, one finite value, all NaN, ±inf,
values near the float32 maximum, and rows whose values share one digit
for every pass but the last. It also counts the passes: none for a
constant row, at most ⌈bits(hi - lo)/8⌉ <= 4 otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrowspace_torch import taumode
from arrowspace_torch.ops import select_tau as st
from arrowspace_torch.taumode import TauMode
from arrowspace_tpu import taumode as j_taumode
from arrowspace_tpu.ops.pallas_tau import fused_select_tau as j_tau
from arrowspace_tpu.ops.pallas_tau import fused_select_tau_fits
from test_torch_cuda import awkward_rows

NO_VALUE = 2**31 - 1
NO_OFFSET = 2**32 - 1
FLOOR = np.float32(taumode.TAU_FLOOR)
WIDTHS = [1, 7, 31, 32, 33, 128, 768, 1024, 1025, 1536]
MODES = [TauMode.median(), TauMode.percentile(0.0), TauMode.percentile(0.3),
         TauMode.percentile(0.75), TauMode.percentile(1.0)]


def _sortable(v: np.ndarray) -> np.ndarray:
    i = v.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, i ^ 0x7FFFFFFF, i)


def _from_sortable(y: int) -> np.float32:
    i = y ^ 0x7FFFFFFF if y < 0 else y
    return np.array([i], dtype=np.int64).astype(np.int32).view(
        np.float32)[0]


def lane_slots(row: np.ndarray, vec: bool) -> np.ndarray:
    """(32, slots) sortable ints of one row as K4's lanes hold it."""
    f = row.size
    if vec:
        slots = 4 * -(-f // 128)
        idx = np.array([[4 * (32 * (s // 4) + lane) + s % 4
                         for s in range(slots)] for lane in range(32)])
    else:
        slots = -(-f // 32)
        idx = np.array([[32 * s + lane for s in range(slots)]
                        for lane in range(32)])
    inside = idx < f
    vals = row[np.where(inside, idx, 0)]
    keys = np.where(np.isfinite(vals), _sortable(vals), NO_VALUE)
    return np.where(inside, keys, NO_VALUE)


def radix_select(u: np.ndarray, k: int, rng: int) -> tuple:
    """(the (k+1)-th smallest held offset, passes) as asp_radix_select
    finds it: u holds y - lo for held values, NO_OFFSET elsewhere."""
    if rng == 0:
        return 0, 0
    shift, prev = max(0, rng.bit_length() - 8), 32
    ans = passes = 0
    rank = k
    while True:
        passes += 1
        t = (u ^ ans) >> shift
        lim = 1 << min(prev - shift, 8)
        hist = np.bincount(t[t < lim], minlength=256)
        c = hist.reshape(32, 8)
        tot = c.sum(axis=1)
        incl = np.cumsum(tot)
        found = []
        for lane in range(32):       # each lane's walk over its 8 digits
            b, hit = int(incl[lane] - tot[lane]), None
            for j in range(8):
                if b + c[lane, j] > rank:
                    hit = (8 * lane + j, b, int(c[lane, j]))
                    break
                b += int(c[lane, j])
            found.append(hit)
        digit, below, cnt = next(h for h in found if h is not None)
        ans |= digit << shift
        prev = shift
        rank -= below
        assert 0 <= rank < cnt
        if shift == 0:
            return ans, passes
        if rank == 0 or rank + 1 == cnt:
            pick = u[((u ^ ans) >> prev) == 0]
            return int(pick.min() if rank == 0 else pick.max()), passes
        shift = max(shift - 8, 0)


def emulate_tau(row: np.ndarray, mode: TauMode, vec: bool) -> tuple:
    """(τ as float32, passes) of one row as K4 computes it."""
    y = lane_slots(row, vec)
    held = y != NO_VALUE
    m = int(held.sum())
    if m == 0:
        return FLOOR, 0
    lo, hi = int(y.min()), int(y[held].max())
    u = np.where(held, y - lo, NO_OFFSET)
    assert int(u[held].max()) < 0xFF000000
    if mode.kind == "percentile":
        pct = np.float32(min(max(mode.value, 0.0), 1.0))
        pos = np.float32(np.float32(m - 1) * pct) + np.float32(0.5)
        idx = min(max(int(np.floor(pos)), 0), m - 1)
        o, passes = radix_select(u, idx, hi - lo)
        tau = _from_sortable(lo + o)
    else:
        lo_r = (m - 1) // 2
        o_lo, passes = radix_select(u, lo_r, hi - lo)
        o_hi = o_lo
        if m % 2 == 0:
            le = int((u <= o_lo).sum())
            above = u[u > o_lo]
            o_hi = o_lo if le >= lo_r + 2 else int(above.min())
        with np.errstate(over="ignore"):
            tau = np.float32(0.5) * (_from_sortable(lo + o_lo)
                                     + _from_sortable(lo + o_hi))
    return max(np.float32(tau), FLOOR), passes


@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"{m.kind}{m.value}")
@pytest.mark.parametrize("f", WIDTHS)
def test_emulated_selection_matches_the_sort_bitwise(f, mode):
    x = awkward_rows(f, seed=f)
    ref = taumode.select_tau_sorted(torch.from_numpy(x), mode).numpy()
    jmode = j_taumode.TauMode(mode.kind, mode.value)
    jref = np.asarray(j_taumode.select_tau_batch(jnp.asarray(x), jmode))
    np.testing.assert_array_equal(ref.view(np.int32),
                                  jref.astype(np.float32).view(np.int32))
    if fused_select_tau_fits(f):
        pct = mode.value if mode.kind == "percentile" else 0.5
        pal = np.asarray(j_tau(jnp.asarray(x), kind=mode.kind, pct=pct,
                               tile=8, interpret=True))
        np.testing.assert_array_equal(ref.view(np.int32),
                                      pal.view(np.int32))
    layouts = (True, False) if f % 4 == 0 else (False,)
    for vec in layouts:
        assert lane_slots(x[0], vec).shape[1] <= 48
        for r, row in enumerate(x):
            tau, passes = emulate_tau(row, mode, vec)
            assert tau.view(np.int32) == ref[r].view(np.int32), (r, vec)
            fin = row[np.isfinite(row)]
            if fin.size == 0 or fin.min() == fin.max():
                assert passes == 0
            else:
                keys = _sortable(fin)
                bits = int(keys.max() - keys.min()).bit_length()
                assert 1 <= passes <= min(4, -(-bits // 8))


def test_selection_runs_every_pass_on_rows_sharing_digits():
    """A row whose values agree on every digit but the last runs all
    four passes (the case that serialises the histogram's adds on the
    card); a spread row ends after one or two."""
    f = 1536
    row = (np.float32(1.0).view(np.int32)
           + np.arange(f) % 200).astype(np.int32).view(np.float32)
    # an outlier near -3e38 whose sortable int ends in a zero byte, so u =
    # y - lo keeps the other values' low bytes: they share every digit
    # above the last
    row[0] = _from_sortable(int(_sortable(np.float32([-3.0e38]))[0])
                            & ~0xFF)
    assert emulate_tau(row, TauMode.median(), True)[1] == 4
    rng = np.random.default_rng(0)
    spread = rng.uniform(0.15, 0.85, (64, f)).astype(np.float32)
    passes = [emulate_tau(r, TauMode.median(), True)[1] for r in spread]
    assert max(passes) <= 3 and np.mean(passes) <= 2.5


def test_k4_gate_takes_1536_wide_rows_and_the_jax_gate_is_unchanged():
    assert st.MAX_F == 1536
    assert st.select_tau_fits(1) and st.select_tau_fits(1536)
    assert not st.select_tau_fits(1537) and not st.select_tau_fits(0)
    # the JAX package's Pallas gate still sends 1536 to its sort
    assert fused_select_tau_fits(768) and not fused_select_tau_fits(1536)


def test_select_tau_batch_sends_rows_above_the_gate_to_the_sort(
        monkeypatch):
    calls = []
    real = st.fused_select_tau

    def spy(x, mode):
        calls.append(tuple(x.shape))
        return real(x, mode)
    monkeypatch.setattr(st, "fused_select_tau", spy)
    rng = np.random.default_rng(1)
    wide = torch.from_numpy(rng.normal(size=(2731, 1537)).astype(np.float32))
    tau = taumode.select_tau_batch(wide, TauMode.median())
    assert calls == []
    assert torch.equal(tau, taumode.select_tau_sorted(wide,
                                                      TauMode.median()))
