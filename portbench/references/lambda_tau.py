"""Plain reference of a λτ search deployment, in float64.

It imports nothing of the system under test.  From the rows the
benchmark made it works out again the feature-graph Laplacian (over the
centroids the build's clustering chose, see below), every item's λ, each
query's λ and the exact λ-aware scores, and compares the program's
outputs with them.  The semantics are arrowspace's, as its documentation
states them:

- graph (laplacian.rs:122-417): nodes are the F′ feature rows of the
  centroid matrix; each node keeps its topk + 1 nearest by rectified
  cosine distance d = 1 − max(0, cos) (itself first), drops itself and
  every d > eps, weights w = 1 / (1 + (d / σ)^p) (σ = 1 unless given),
  keeps w > 1e-12, symmetrises by the larger weight, L = D − A; topk is
  4 for 5 < k < 10, 3 for k <= 5, else as given (builder.rs:225-233);
- λ (taumode.rs:552-660): τ is the median of the row's finite values
  (floored at 1e-10); with x′ the row's first n values (n = graph nodes),
  E = x′ᵀ L x′ / |x|², S = Σ_{i≠j} W_ij (x_i − x_j)², G = Σ_{i≠j} W_ij²
  (x_i − x_j)⁴ / S² clamped to [0, 1], W_ij = max(−L_ij, 0), and
  λ = τ E / (E + τ) + (1 − τ) G;
- projected builds (reduction.rs:126-203): the centroids are projected
  by an F × r Gaussian matrix scaled by 1/√r, r = min(max(32, ⌈8 ln X /
  ε²⌉), F / 2) for X centroids; a query's λ is taken from its projection,
  an item's from its raw row;
- score (core.rs:135-175): α cos(q, x) + (1 − α)(1 − min(|λ_q − λ_x|,
  1)), zero rows scoring cos 0; the top-k is the k best scores, ties to
  the lowest id.

- clustering (clustering.rs:547-910, sampling.rs:108-159): the seeded
  simple sampler keeps a row iff the row's uniform, one per row in row
  order from numpy's PCG64 seeded with the build seed, is below the keep
  rate; a kept row's nearest centroid is taken by squared distance d²
  (first on ties); it starts a new centroid iff fewer than K exist and
  d² > radius/2, else moves its centroid by the running mean c += (x −
  c)/count iff d² <= radius, else (K reached) counts without moving iff
  d² <= 1.5 radius, else is dropped.

The reference works the centroids out again from the rows: it replays
the scan's running means, cluster by cluster in row order, over the
members the build assigned, and holds every member to the scan's rule
against its own centroid as it stood then; at rows drawn from the seed
it rebuilds every centroid as it stood then and decides the row's fate
by the rule above, which the build's assignment has to match.  K and the
radius are the optimal-K heuristic's (a seeded sweep over at most 1,000
sampled rows); the reference takes them from the build and checks only
their documented bounds.  It projects its own centroids with the
regenerated JL matrix, and builds the Laplacian and every λ from them.
It also checks that the rows the index holds are the rows it was given.

``derive(..., tf32=True)`` is the control: the same reference in the
program's place, every product of its matrices taken with TF32 operands
(10 mantissa bits, rounded to nearest) and float32 sums, as a TF32
kernel computes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TAU_FLOOR = 1e-10
DENOM_EPS = 1e-12
ROW_BLOCK = 1 << 16

NUMBERS = ("score_gap", "rank_gap", "order_faults", "lambda_gap",
           "laplacian_gap", "centroid_gap", "data_mismatch",
           "cluster_faults")
SAMPLED_ROWS = 64       # kept rows whose whole scan decision is replayed
SAMPLED_DROPS = 16      # and kept rows the build dropped


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest,
    ties away from zero (what the tensor cores read)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if not tf32:
        return a.double() @ b.double()
    return round_tf32(a) @ round_tf32(b)


def result_topk(k: int, topk: int) -> int:
    """The graph's topk as the builder sets it from k (builder.rs:225-233)."""
    if k <= 5:
        return 3
    if k < 10:
        return 4
    return topk


def laplacian(nodes: torch.Tensor, graph: dict, tf32: bool = False
              ) -> torch.Tensor:
    """L = D − A over the rows of ``nodes`` (F′ × X), float64 (float32
    with ``tf32``)."""
    dt = torch.float32 if tf32 else torch.float64
    x = nodes.to(dt)
    n = x.shape[0]
    kq = min(result_topk(int(graph["k"]), int(graph["topk"])) + 1, n)
    sigma = 1.0 if graph.get("sigma") is None else float(graph["sigma"])
    norms = x.norm(dim=1)
    unit = x / torch.where(norms > 0, norms, torch.ones_like(norms))[:, None]
    cos = matmul(unit, unit.T, tf32).to(dt)
    cos = torch.where((norms[:, None] > 0) & (norms[None, :] > 0), cos,
                      torch.zeros_like(cos))
    dist = 1.0 - cos.clamp_min(0.0)
    dist.fill_diagonal_(-1.0)
    nbr = torch.sort(dist, dim=1, stable=True).indices[:, :kq]
    d = dist.gather(1, nbr)
    own = torch.arange(n, device=x.device)[:, None]
    keep = (nbr != own) & (d <= float(graph["eps"]))
    if keep.sum(dim=1).double().mean() > 10.0:
        raise NotImplementedError("inline sparsification (average degree "
                                  "above 10) is not in this reference")
    w = 1.0 / (1.0 + (d.clamp_min(0.0) / sigma) ** float(graph["p"]))
    keep &= w > 1e-12
    adj = torch.zeros((n, n), dtype=dt, device=x.device)
    rows = own.expand(n, kq)[keep]
    adj[rows, nbr[keep]] = w[keep]
    adj = torch.maximum(adj, adj.T)
    adj.fill_diagonal_(0.0)
    return torch.diag(adj.sum(dim=1)) - adj


def median_tau(x: torch.Tensor) -> torch.Tensor:
    """Per-row median of the finite values, floored at TAU_FLOOR."""
    finite = torch.isfinite(x)
    m = finite.sum(dim=1)
    v = torch.sort(torch.where(finite, x, torch.full_like(x, math.inf)),
                   dim=1).values
    m1 = m.clamp_min(1)
    lo = v.gather(1, ((m1 - 1) // 2)[:, None])[:, 0]
    hi = v.gather(1, (m1 // 2)[:, None])[:, 0]
    med = torch.where(m > 0, 0.5 * (lo + hi), torch.full_like(lo, TAU_FLOOR))
    return med.clamp_min(TAU_FLOOR)


def lambdas(x: torch.Tensor, lap: torch.Tensor, tf32: bool = False
            ) -> torch.Tensor:
    """λ of every row of x against the graph ``lap``, in blocks of rows."""
    dt = torch.float32 if tf32 else torch.float64
    lap = lap.to(device=x.device, dtype=dt)
    n = lap.shape[0]
    if n > x.shape[1]:
        raise ValueError("the graph has more nodes than the rows have values")
    w = (-lap).clamp_min(0.0)
    w.fill_diagonal_(0.0)
    src, dst = torch.nonzero(w, as_tuple=True)
    we = w[src, dst]
    out = []
    for r0 in range(0, x.shape[0], ROW_BLOCK):
        xb = x[r0:r0 + ROW_BLOCK].to(dt)
        xn = xb[:, :n]
        tau = median_tau(xb)
        num = (matmul(xn, lap, tf32).to(dt) * xn).sum(dim=1)
        den = (xb * xb).sum(dim=1)
        e = torch.where(den > DENOM_EPS, num / den.clamp_min(DENOM_EPS),
                        torch.zeros_like(num))
        diff2 = (xn[:, src] - xn[:, dst]) ** 2
        s = (diff2 * we).sum(dim=1)
        g_num = (diff2 * diff2 * we * we).sum(dim=1)
        g = torch.where(s > 0, g_num / (s * s).clamp_min(DENOM_EPS),
                        torch.zeros_like(s)).clamp(0.0, 1.0)
        out.append(tau * (e / (e + tau)) + (1.0 - tau) * g)
    return torch.cat(out)


def projection(cfg: dict, seed: int, n_centroids: int):
    """The build's F × r projection matrix as float32, or None when the
    build does not project: torch.randn on a CPU generator seeded with
    seed mod 2**63, scaled by 1/√r in float32."""
    f = int(cfg["features"])
    build = cfg["build"]
    if not build.get("dims_reduction") or f <= 64:
        return None
    eps = float(build.get("rp_eps") or 0.5)
    r = min(max(32, math.ceil(8.0 * math.log(n_centroids) / eps ** 2)), f // 2)
    if r >= f:
        return None
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed) % (2 ** 63))
    gauss = torch.randn((f, r), generator=gen, dtype=torch.float32)
    return gauss * (1.0 / math.sqrt(r))


def unit(x: torch.Tensor) -> torch.Tensor:
    norms = x.norm(dim=1, keepdim=True)
    return torch.where(norms > 0, x / torch.where(norms > 0, norms,
                                                   torch.ones_like(norms)),
                       torch.zeros_like(x))


def scan(qunit, qlam, xunit, xlam, alpha: float, k: int, tf32: bool,
         ids: bool, block: int = 128):
    """Top-k of the λ-aware scores of every query over every row: (scores
    descending, ids) with ties to the lowest id when ``ids``, else the
    scores alone."""
    c1 = 1.0 - alpha
    out_s, out_i = [], []
    for b0 in range(0, qunit.shape[0], block):
        plane = matmul(qunit[b0:b0 + block], xunit.T, tf32).to(xunit.dtype)
        plane = alpha * plane + c1 * (1.0 - (qlam[b0:b0 + block, None]
                                             - xlam[None, :]).abs()
                                      .clamp_max(1.0))
        extra = min(k + 16, plane.shape[1])
        s, i = torch.topk(plane, extra, dim=1)
        if ids:
            # ties to the lowest id: order by id, then stably by score
            i, order = torch.sort(i, dim=1)
            s = s.gather(1, order)
            s, order = torch.sort(s, dim=1, descending=True, stable=True)
            i = i.gather(1, order)
            out_i.append(i[:, :k])
        out_s.append(s[:, :k])
    return torch.cat(out_s), (torch.cat(out_i) if ids else None)


def keep_mask(seed: int, n: int, rate: float) -> np.ndarray:
    """The seeded simple sampler's decisions: a row is kept iff its
    uniform, one a row in row order from numpy's PCG64 seeded with the
    build seed, is below the keep rate."""
    return np.random.default_rng(int(seed)).random(n) < rate


def sample_rows(seed: int, keep: np.ndarray, assign: np.ndarray
                ) -> np.ndarray:
    """Rows whose whole scan decision is replayed, drawn from the seed:
    SAMPLED_ROWS kept rows and SAMPLED_DROPS kept rows the build
    dropped, in row order."""
    rng = np.random.default_rng([int(seed), 1])
    kept = np.flatnonzero(keep)
    dropped = kept[assign[kept] < 0]
    pick = [rng.choice(kept, min(SAMPLED_ROWS, kept.size), replace=False),
            rng.choice(dropped, min(SAMPLED_DROPS, dropped.size),
                       replace=False)]
    return np.unique(np.concatenate(pick)).astype(np.int64)


def replay_clustering(rows: torch.Tensor, assign: np.ndarray,
                      keep: np.ndarray, cap: int, radius: float,
                      picked: np.ndarray, dt=torch.float64):
    """(centroids X × F in ``dt``, faults): the scan's centroids worked
    out again from the rows, and the count of the build's departures
    from the scan's rule.

    Each centroid starts at its first member and takes the running mean
    of the later ones in row order, except a member that came once the
    cap was reached (``cap`` centroids made) farther than ``radius``,
    which counts without moving it.  Every member is held to the rule
    against its own centroid as it stood then (at most radius/2 before
    the cap, at most 1.5 radius after); every row of ``picked`` to the
    whole rule against every centroid as it stood then."""
    dev, n = rows.device, rows.shape[0]
    a = torch.as_tensor(assign, device=dev).long()
    kept = torch.as_tensor(keep, device=dev)
    faults = ((a >= 0) & ~kept).sum() + (a < -1).sum()
    idx = torch.nonzero(a >= 0).squeeze(1)
    if idx.numel() == 0:
        return None, int(faults) + 1
    n_c = int(a.max()) + 1
    sizes = torch.bincount(a[idx], minlength=n_c)
    faults += (sizes == 0).sum() + max(0, n_c - cap)
    # members of each centroid in row order, padded with n
    grouped = idx[torch.sort(a[idx], stable=True).indices]
    start = torch.cumsum(sizes, 0) - sizes
    l_max = int(sizes.max())
    members = torch.full((n_c, l_max), n, dtype=torch.long, device=dev)
    members[a[grouped], torch.arange(grouped.numel(), device=dev)
            - start[a[grouped]]] = grouped
    creators = members[:, 0]
    # centroids are numbered in the order the scan made them, the first
    # by the first kept row; before the cap every kept row is assigned
    faults += (creators[1:] <= creators[:-1]).sum()
    faults += int(creators[0]) != int(np.flatnonzero(keep)[0])
    sat = int(creators[cap - 1]) if n_c >= cap else n
    faults += (kept[:sat] & (a[:sat] < 0)).sum()
    # where each picked row's snapshot of each centroid is taken: after
    # the centroid's members before that row
    t = torch.as_tensor(picked, device=dev).long()
    before = torch.searchsorted(members, t.expand(n_c, -1).contiguous())
    before = before.clamp_max(l_max).cpu().numpy()
    plan = {}
    for c, j in zip(*np.nonzero(before)):
        cs, js = plan.setdefault(int(before[c, j]), ([], []))
        cs.append(int(c))
        js.append(int(j))
    cent = rows[creators].to(dt)
    count = torch.ones(n_c, dtype=torch.long, device=dev)
    snap = torch.zeros((t.numel(), n_c, rows.shape[1]), dtype=dt,
                       device=dev)

    def record(step):
        if step in plan:
            cs, js = plan[step]
            snap[js, cs] = cent[cs]

    for step in range(1, l_max):
        record(step)
        r = members[:, step]
        valid = r < n
        diff = rows[r.clamp_max(n - 1)].to(dt) - cent
        d2 = (diff * diff).sum(dim=1)
        late = r > sat
        faults += (valid & ~late & (d2 > 0.5 * radius)).sum()
        faults += (valid & late & (d2 > 1.5 * radius)).sum()
        move = valid & ~(late & (d2 > radius))
        count += valid.long()
        cent = torch.where(move[:, None], cent + diff / count[:, None].to(dt),
                           cent)
    record(l_max)
    # the whole rule at the picked rows
    live = creators[None, :] < t[:, None]
    d2 = ((snap - rows[t].to(dt)[:, None, :]) ** 2).sum(dim=2)
    d2 = torch.where(live, d2, torch.full_like(d2, math.inf))
    made = live.sum(dim=1)
    best, near = d2.min(dim=1)
    expect = torch.where(best <= 1.5 * radius, near, torch.full_like(near, -1))
    expect = torch.where((made == 0) | ((made < cap) & (best > 0.5 * radius)),
                         made, expect)
    faults += (expect != a[t]).sum()
    return cent, int(faults)


def derive(cfg: dict, seed: int, rows: torch.Tensor, queries: torch.Tensor,
           centroids: torch.Tensor, tf32: bool = False) -> dict:
    """The reference's projected centroids, Laplacian, item λ and query λ
    (and the projection it used) on rows' device, from its own
    ``centroids`` (X × F, as the scan made them)."""
    dt = torch.float32 if tf32 else torch.float64
    proj = projection(cfg, seed, centroids.shape[0])
    cent = centroids.to(dt)
    q = queries.to(dt)
    if proj is not None:
        cent = matmul(cent, proj.to(cent.device), tf32).to(dt)
        q = matmul(q, proj.to(q.device), tf32).to(dt)
    lap = laplacian(cent.T, cfg["build"]["graph"], tf32)
    return {"centroids": cent, "laplacian": lap, "projection": proj,
            "item_lambdas": lambdas(rows, lap, tf32),
            "query_lambdas": lambdas(q, lap, tf32)}


def gap(program, ref: torch.Tensor) -> float:
    """Largest gap of an entry; infinite where the shapes differ."""
    prog = torch.as_tensor(program).to(ref.device).double()
    if prog.shape != ref.shape:
        return math.inf
    return float((prog - ref.double()).abs().max())


def compare(cfg: dict, ref: dict, program: dict, served: dict,
            rows_unit: torch.Tensor, qunit: torch.Tensor) -> dict:
    """The compared numbers of one run.

    ``program``: the index's Laplacian, item λ and centroids (as the
    graph took them); ``served``: the
    sampled queries' row numbers in the pool (``query_rows``) and what
    the timed path returned for them (``scores``, ``ids``, host arrays);
    ``ref``: derive()'s float64 values; rows_unit and qunit the
    reference's unit rows and queries."""
    alpha, k = float(cfg["search"]["alpha"]), int(cfg["search"]["k"])
    dev = rows_unit.device
    lam = ref["item_lambdas"].double()
    out = {"laplacian_gap": gap(program["laplacian"], ref["laplacian"]),
           "lambda_gap": gap(program["item_lambdas"], lam),
           "centroid_gap": gap(program["centroids"], ref["centroids"])}
    qi = torch.as_tensor(served["query_rows"], device=dev).long()
    ids = torch.as_tensor(served["ids"], device=dev).long()
    s_prog = torch.as_tensor(served["scores"], device=dev).double()
    qlam = ref["query_lambdas"].double()[qi]
    n = rows_unit.shape[0]
    valid = (ids >= 0) & (ids < n)
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    score_gap = rank_gap = 0.0
    ties = 0
    for b0 in range(0, qi.shape[0], 256):
        sl = slice(b0, b0 + 256)
        qu = qunit[qi[sl]]
        best, _ = scan(qu, qlam[sl], rows_unit, lam, alpha, k, False, False)
        cos = torch.bmm(rows_unit[safe[sl]].double(),
                        qu.double()[:, :, None])[:, :, 0]
        s_ref = alpha * cos + (1.0 - alpha) * (
            1.0 - (qlam[sl, None] - lam[safe[sl]]).abs().clamp_max(1.0))
        ok = valid[sl]
        zero = torch.zeros_like(s_ref)
        score_gap = max(score_gap, float(torch.where(
            ok, (s_prog[sl] - s_ref).abs(), zero).max()))
        rank_gap = max(rank_gap, float(torch.where(
            ok, best[:, :ids.shape[1]] - s_ref, zero).max()))
        i = ids[sl]
        ties += int(((s_ref[:, 1:] == s_ref[:, :-1]) & (i[:, 1:] < i[:, :-1])
                     & ok[:, 1:] & ok[:, :-1]).sum())
    dup = int((torch.sort(ids, dim=1).values.diff(dim=1) == 0).sum())
    out["score_gap"], out["rank_gap"] = score_gap, rank_gap
    out["order_faults"] = (int((~valid).sum()) + dup + ties
                           + int(ids.shape[1] != min(k, n)))
    return out


def data_mismatch(held: torch.Tensor, rows: np.ndarray) -> int:
    """Values of the index's resident rows that differ from the rows it
    was given (the rows are float32 values held as float64)."""
    if tuple(held.shape) != rows.shape:
        return max(1, rows.size)
    bad = 0
    for r0 in range(0, rows.shape[0], ROW_BLOCK):
        given = torch.from_numpy(rows[r0:r0 + ROW_BLOCK]).to(held.device)
        bad += int((held[r0:r0 + ROW_BLOCK].double() != given).sum())
    return bad


def cap_bounds(n: int, f: int) -> tuple:
    """The range the optimal-K heuristic's K lies in (clustering.rs:75-98:
    k_min = max(⌈√(N/10)⌉, 2); k_max = max(min(F, N/10, 5·ID, √N),
    k_min + 1), at most N/2; the Two-NN estimate ID left out, which only
    narrows it)."""
    k_min = max(math.ceil(math.sqrt(n / 10.0)), 2)
    return k_min, min(max(min(f, n // 10, int(n ** 0.5)), k_min + 1), n // 2)


def check(cfg: dict, seed: int, rows: np.ndarray, queries: np.ndarray,
          state: dict, served: dict, device, control: bool = False) -> dict:
    """Every compared number of a run: the program's outputs (``state``:
    its Laplacian, item λ, centroids as the graph took them, assignments,
    cluster sizes, K, radius and data_mismatch; ``served``: see compare)
    against the float64 reference.  With ``control`` the numbers of the
    TF32 reference put in the program's place instead (its centroids
    replayed in float32 from the same assignments), on the same sampled
    queries."""
    x = torch.from_numpy(rows).to(device)
    # only the sampled queries: their pool rows, renumbered
    asked, where = np.unique(served["query_rows"], return_inverse=True)
    served = {**served, "query_rows": where}
    q = torch.from_numpy(np.asarray(queries[asked], dtype=np.float64)).to(
        device)
    n, f = rows.shape
    if cfg["build"]["sampling"]["kind"] != "simple":
        raise NotImplementedError("only the simple sampler is replayed")
    keep = keep_mask(seed, n, float(cfg["build"]["sampling"]["rate"]))
    assign = np.asarray(state["assignments"], dtype=np.int64)
    cap, radius = int(state["cap"]), float(state["radius"])
    lo, hi = cap_bounds(n, f)
    faults = int(not lo <= cap <= hi) + int(not 1e-6 <= radius < math.inf)
    if assign.shape != (n,):
        return {k: math.inf for k in NUMBERS}
    picked = sample_rows(seed, keep, assign)
    cent, bad = replay_clustering(x, assign, keep, cap, radius, picked)
    if cent is None:
        return {k: math.inf for k in NUMBERS}
    sizes = np.bincount(assign[assign >= 0], minlength=cent.shape[0])
    held = np.asarray(state["sizes"], dtype=np.int64)
    faults += bad + (int((held != sizes).sum()) if held.shape == sizes.shape
                     else max(1, sizes.size))
    ref = derive(cfg, seed, x, q, cent)
    xu, qu = unit(x), unit(q)
    out = {"data_mismatch": int(state["data_mismatch"]),
           "cluster_faults": faults}
    if control:
        c32, _ = replay_clustering(x.float(), assign, keep, cap, radius,
                                   picked, torch.float32)
        ctl = derive(cfg, seed, x.float(), q.float(), c32, tf32=True)
        alpha, k = float(cfg["search"]["alpha"]), int(cfg["search"]["k"])
        qi = torch.as_tensor(where, device=device).long()
        s, i = scan(unit(q.float())[qi], ctl["query_lambdas"][qi],
                    unit(x.float()), ctl["item_lambdas"], alpha, k, True,
                    True)
        state = {"laplacian": ctl["laplacian"], "centroids": ctl["centroids"],
                 "item_lambdas": ctl["item_lambdas"]}
        served = {"query_rows": where, "scores": s.double().cpu().numpy(),
                  "ids": i.cpu().numpy()}
    out.update(compare(cfg, ref, state, served, xu, qu))
    return out
