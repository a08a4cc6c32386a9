"""The strided repairs over a mesh det plane (ops/bin_repair, shard_n),
on the CPU.

A mesh det plane is the per-shard (B, bins) det planes gathered along
the columns: column s·bins + b is local bin b of shard s, whose rows are
s·shard_n + b + j·bins below min((s+1)·shard_n, n).  The candidate
decoding is held against the JAX package's
arrowspace_tpu.ops.bin_repair._fired_to_slices; the repairs over a list
of shards against the plain full scan; and the single-device decoding
(shard_n 0 or n) against the decoding the repair had before shard_n was
added, so single-device repairs stay bitwise as they were.

Tolerances: candidate sets, ids and tie order exact; float64 scores of a
repair against the full scan within 1e-12."""

import numpy as np
import pytest
import torch

from arrowspace_tpu.ops.bin_repair import _fired_to_slices
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops.bintopk import (binned_lambda_topk,
                                          binned_topk_depth_for, bins_target,
                                          prepare_binned_corpus)
from arrowspace_torch.ops.energy_bintopk import (binned_energy_topk,
                                                 energy_topk_chunked,
                                                 prepare_binned_energy_corpus)
from arrowspace_torch.ops.search import batched_lambda_aware_topk

TOL = 1e-12


def _old_candidates(fired, out_idx, n, k, bins):
    """The single-device decoding as it stood before the mesh's shard_n
    (column b is bin b, rows b + j·bins < n)."""
    dev = out_idx.device
    r, n_fired = fired.shape
    m = -(-n // bins)
    j = torch.arange(m, device=dev)
    base = fired.long()
    gidx = base.clamp_min(0)[:, :, None] + j[None, None, :] * bins
    valid_g = (base[:, :, None] >= 0) & (gidx < n)
    out_i = out_idx.long()
    in_fired = ((base[:, None, :] >= 0)
                & (out_i[:, :, None] % bins == base[:, None, :])).any(dim=2)
    earlier = torch.ones(k, k, dtype=torch.bool, device=dev).tril(-1)
    rep = ((out_i[:, :, None] == out_i[:, None, :]) & earlier).any(dim=2)
    valid_o = ~in_fired & ~rep & (out_i >= 0) & (out_i < n)
    cand = torch.cat([gidx.reshape(r, n_fired * m), out_i], dim=1)
    valid = torch.cat([valid_g.reshape(r, n_fired * m), valid_o], dim=1)
    return cand, valid, torch.where(valid, cand, torch.zeros_like(cand))


def _random_fired(rng, r, cols):
    fired = np.full((r, br.MAX_FIRED), -1, dtype=np.int32)
    for i in range(r):
        c = rng.choice(cols, size=rng.integers(0, br.MAX_FIRED + 1),
                       replace=False)
        fired[i, :c.size] = np.sort(c)
    return fired


@pytest.mark.parametrize("n,bins,shard_n", [(4096, 128, 512),
                                            (8192, 256, 2048),
                                            (3000, 128, 750),
                                            (1000, 128, 250)])
def test_mesh_decoding_matches_jax_slices(n, bins, shard_n):
    """Each fired column's candidate rows are exactly JAX's (base, limit)
    slice with stride bins; current ids in a fired (shard, bin) are
    dropped, the rest kept once."""
    rng = np.random.default_rng(n + bins)
    shards = n // shard_n
    r, k = 24, 7
    fired = _random_fired(rng, r, shards * bins)
    out = rng.integers(0, n, (r, k))
    out[0, 3] = out[0, 1]                        # a repeated id
    cand, valid, _ = br._candidates(torch.as_tensor(fired),
                                    torch.as_tensor(out), n, k, bins, shard_n)
    base, limit = _fired_to_slices(fired, bins, shard_n, n)
    m = -(-shard_n // bins)
    cand, valid = cand.numpy(), valid.numpy()
    for i in range(r):
        want = []
        for c in range(br.MAX_FIRED):
            if fired[i, c] >= 0:
                want += [g for g in range(base[i, c], limit[i, c], bins)]
        got_g = cand[i, :br.MAX_FIRED * m][valid[i, :br.MAX_FIRED * m]]
        assert sorted(got_g.tolist()) == sorted(want)
        in_slice = set(want)
        keep = []
        for j, g in enumerate(out[i]):
            if g not in in_slice and g not in out[i][:j]:
                keep.append(g)
        got_o = cand[i, br.MAX_FIRED * m:][valid[i, br.MAX_FIRED * m:]]
        assert got_o.tolist() == keep


@pytest.mark.parametrize("n,bins", [(4096, 128), (3000, 256), (700, 512)])
@pytest.mark.parametrize("shard_n", [0, None])
def test_single_device_decoding_unchanged(n, bins, shard_n):
    """shard_n 0 (the default) or n decodes exactly as before."""
    rng = np.random.default_rng(bins)
    r, k = 32, 10
    fired = torch.as_tensor(_random_fired(rng, r, bins))
    out = torch.as_tensor(rng.integers(0, n, (r, k)))
    out[1, 2] = out[1, 0]
    new = br._candidates(fired, out, n, k, bins,
                         n if shard_n is None else shard_n)
    old = _old_candidates(fired, out, n, k, bins)
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def _storm(n_shards, shard_n, f, k, seed):
    """Corpus with depth+2 copies of query 0 in local bin 5 of shard 2
    (depth+1 in two more bins of shard 1 and 3 for query 1: three fired
    columns, an overflow)."""
    rng = np.random.default_rng(seed)
    n = n_shards * shard_n
    bins, depth = bins_target(k), binned_topk_depth_for(k)
    x = rng.uniform(0.1, 1.0, (n, f))
    q = rng.uniform(0.1, 1.0, (3, f))
    dup0 = [2 * shard_n + 5 + j * bins for j in range(depth + 2)]
    dup1 = [s * shard_n + b + j * bins for s, b in ((1, 9), (1, 70), (3, 9))
            for j in range(depth + 1)]
    x[dup0], x[dup1] = q[0], q[1]
    return x, q, rng.uniform(0, 1, n), dup0, sorted(dup1)


def _mesh_pass(shards, lams, q, qlam, alpha, k, shard_n):
    """Per-shard K1 (plain) and the merge: host (scores, ids, flags,
    gathered det)."""
    s_p, i_p, f_p, d_p = [], [], [], []
    for j, (xs, ls) in enumerate(zip(shards, lams)):
        s, i, fl, det = binned_lambda_topk(q, qlam, xs, ls, alpha, k=k,
                                           prepared=True, n_items=shard_n)
        s_p.append(s)
        i_p.append(i + j * shard_n)
        f_p.append(fl)
        d_p.append(det)
    from arrowspace_torch.ops.search import two_key_topk
    s, i = two_key_topk(torch.cat(s_p, 1), torch.cat(i_p, 1), k)
    return (s.numpy(), i.numpy(), torch.stack(f_p).any(0).numpy(),
            torch.cat(d_p, 1))


@pytest.mark.parametrize("alpha", [1.0, 0.8])
def test_mesh_lambda_repair_restores_exactness(alpha):
    """Strided repair over four shards (a list of prepared shard
    tensors): the flagged rows equal the plain full scan, the copies
    lowest id first; the overflowing row takes the fallback."""
    shard_n, f, k = 2048, 16, 8
    x, q, lam, dup0, dup1 = _storm(4, shard_n, f, k, 3)
    lam[dup0], lam[dup1] = lam[0], lam[1]
    qlam = torch.as_tensor(lam[:3].copy())
    xt, lt = torch.as_tensor(x), torch.as_tensor(lam)
    pairs = [prepare_binned_corpus(xt[s * shard_n:(s + 1) * shard_n],
                                   lt[s * shard_n:(s + 1) * shard_n])
             for s in range(4)]
    shards, lams = [p[0] for p in pairs], [p[1] for p in pairs]
    qt = torch.as_tensor(q)
    s, i, flags, det = _mesh_pass(shards, lams, qt, qlam, alpha, k, shard_n)
    assert flags[0] and flags[1]
    rows = np.nonzero(flags)[0]
    ref_s, ref_i = batched_lambda_aware_topk(qt, qlam, xt, lt, alpha, k=k)
    seen = []

    def fallback(rel):
        seen.extend(rows[rel].tolist())
        rs, ri = batched_lambda_aware_topk(qt[rows[rel]], qlam[rows[rel]],
                                           xt, lt, alpha, k=k)
        return rs.numpy(), ri.numpy()

    rs, ri = br.strided_lambda_repair(
        qt[rows], qlam[rows], det[rows].numpy(), s[rows, k - 1], i[rows],
        shards, lams, alpha, k=k, n=4 * shard_n, prepared=True,
        fallback=fallback, cur_scores=s[rows], shard_n=shard_n)
    assert seen == [1]                     # three fired columns overflow
    np.testing.assert_array_equal(ri, ref_i.numpy()[rows])
    np.testing.assert_allclose(rs, ref_s.numpy()[rows], rtol=0, atol=TOL)
    assert list(ri[0][:len(dup0)]) == dup0
    # raw shards (prepared=False) repair to the same result
    rs2, ri2 = br.strided_lambda_repair(
        qt[rows], qlam[rows], det[rows].numpy(), s[rows, k - 1], i[rows],
        [xt[j * shard_n:(j + 1) * shard_n] for j in range(4)],
        [lt[j * shard_n:(j + 1) * shard_n] for j in range(4)], alpha, k=k,
        n=4 * shard_n, prepared=False, fallback=fallback,
        cur_scores=s[rows], shard_n=shard_n)
    np.testing.assert_array_equal(ri2, ri)
    np.testing.assert_allclose(rs2, rs, rtol=0, atol=TOL)


def test_mesh_energy_repair_restores_exactness():
    """The strided energy repair over four prepared z shards (K6's plain
    version per shard): equal to the chunked scan of the whole plane."""
    shard_n, f, k = 2048, 16, 8
    wl, wd = 1.0, 0.5
    z, q, lam, dup0, _dup1 = _storm(4, shard_n, f, k, 7)
    lam[:] = 0.5
    zt, lt = torch.as_tensor(z), torch.as_tensor(lam)
    qt, qlam = torch.as_tensor(q), torch.full((3,), 0.5,
                                              dtype=torch.float64)
    prep = [prepare_binned_energy_corpus(zt[s * shard_n:(s + 1) * shard_n],
                                         lt[s * shard_n:(s + 1) * shard_n])
            for s in range(4)]
    s_p, i_p, f_p, d_p = [], [], [], []
    for j, (zx, zl, zn) in enumerate(prep):
        s, i, fl, det = binned_energy_topk(qt, qlam, zx, zl, zn, wl, wd, k=k,
                                           n=shard_n)
        s_p.append(s)
        i_p.append(i + j * shard_n)
        f_p.append(fl)
        d_p.append(det)
    from arrowspace_torch.ops.search import two_key_topk
    s, i = two_key_topk(torch.cat(s_p, 1), torch.cat(i_p, 1), k)
    flags = torch.stack(f_p).any(0).numpy()
    det = torch.cat(d_p, 1)
    rows = np.nonzero(flags)[0]
    assert 0 in rows and 1 in rows
    ref_s, ref_i = energy_topk_chunked(qt, qlam, zt, lt, wl, wd, k=k)

    def fallback(rel):
        rs, ri = energy_topk_chunked(qt[rows[rel]], qlam[rows[rel]], zt, lt,
                                     wl, wd, k=k)
        return rs.numpy(), ri.numpy()

    rs, ri = br.strided_energy_repair(
        qt[rows], qlam[rows], det[rows].numpy(), s.numpy()[rows, k - 1],
        i.numpy()[rows], [p[0] for p in prep], [p[1] for p in prep],
        [p[2] for p in prep], wl, wd, k=k, n=4 * shard_n, fallback=fallback,
        cur_scores=s.numpy()[rows], shard_n=shard_n)
    np.testing.assert_array_equal(ri, ref_i.numpy()[rows])
    np.testing.assert_allclose(rs, ref_s.numpy()[rows], rtol=0, atol=TOL)
    assert list(ri[list(rows).index(0)][:len(dup0)]) == dup0


def test_single_device_repair_bitwise_with_shard_n_n():
    """A single-device strided repair gives bitwise the same result with
    shard_n left at 0 and set to n."""
    rng = np.random.default_rng(9)
    n, f, k = 6000, 16, 10
    bins, depth = bins_target(k), binned_topk_depth_for(k)
    x = rng.uniform(0.1, 1.0, (n, f))
    q = rng.uniform(0.1, 1.0, (2, f))
    x[[40 + j * bins for j in range(depth + 2)]] = q[0]
    xt, lt = torch.as_tensor(x), torch.as_tensor(rng.uniform(0, 1, n))
    qt, ql = torch.as_tensor(q), torch.as_tensor([0.3, 0.6])
    xhat, xlam = prepare_binned_corpus(xt, lt)
    s, i, fl, det = binned_lambda_topk(qt, ql, xhat, xlam, 0.9, k=k,
                                       prepared=True, n_items=n)
    assert bool(fl[0])
    args = (qt, ql, det.numpy(), s.numpy()[:, k - 1], i.numpy(), xhat, xlam,
            0.9)
    a = br.strided_lambda_repair(*args, k=k, n=n, prepared=True)
    b = br.strided_lambda_repair(*args, k=k, n=n, prepared=True, shard_n=n)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    ref_s, ref_i = batched_lambda_aware_topk(qt, ql, xt, lt, 0.9, k=k)
    np.testing.assert_array_equal(a[1], ref_i.numpy())
