"""The reference against the port at tiny size: sound runs prove
correct; the TF32 control, the session's bf16 mode, each planted fault
of the timed path and each wrong stage of the build come out not
correct."""

import numpy as np
import pytest

from portbench.systems import search_session
from portbench.tests.tiny import tiny_run

PROJECTED = {"features": 96}
CELLS = [("glove100-batch2048", {}), ("cohere768-batch2048", PROJECTED)]


def failed(numbers: dict) -> set:
    return {k for k, v in numbers.items() if v["value"] > v["limit"]}


@pytest.mark.parametrize("cell,cfg", CELLS)
def test_sound_runs_prove_correct(cell, cfg):
    out = tiny_run(cell, cfg=cfg)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["lambda_gap"]["value"] > 0      # λ was compared
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell,cfg", CELLS)
def test_tf32_control_fails_every_graded_number(cell, cfg):
    out = tiny_run(cell, cfg=cfg, control=True)
    assert out["correct"] is True
    ctl = out["control"]["tf32"]
    assert ctl["correct"] is False
    assert failed(ctl["checks"]) >= {
        "score_gap", "rank_gap", "lambda_gap", "laplacian_gap"}


def test_bf16_session_fails_where_the_binned_engine_serves():
    # 65536 rows and more take K1's route (its plain version on the CPU)
    out = tiny_run("glove100-batch2048", cfg={"rows": 70000},
                   mix={"keep_batches": 1}, seconds=0.2, control=True)
    assert out["correct"] is True, out["checks"]
    assert out["control"]["bf16"]["correct"] is False
    assert "score_gap" in failed(out["control"]["bf16"]["checks"])


class Broken:
    """The session with its answers broken as they are produced."""

    def __init__(self, session, fault):
        self.session, self.fault, self.last = session, fault, None

    def warmup(self):
        self.session.warmup()

    def search_stream(self, batches):
        for s, i in self.session.search_stream(batches):
            s, i = s.copy(), i.copy()
            if self.fault == "stale":           # the state left unchanged
                out, self.last = (self.last or (s, i)), (s, i)
                s, i = out
            elif self.fault == "half":          # half of the batch left out
                h = len(s) // 2
                s[h:], i[h:] = s[:h][:len(s) - h], i[:h][:len(s) - h]
            elif self.fault == "id":            # an answer altered
                i[0, -1] = (i[0, -1] + 1) % 3000
            elif self.fault == "score":
                s[0, 0] += 1e-4
            yield s, i


@pytest.mark.parametrize("fault", ["stale", "half", "id", "score"])
def test_faults_of_the_timed_path_come_out_not_correct(fault):
    out = tiny_run("glove100-batch2048", mix={"keep_batches": 4},
                   breaker=lambda s: Broken(s, fault))
    assert out["correct"] is False
    assert failed(out["checks"]) & {"score_gap", "rank_gap", "order_faults"}


def test_wrong_item_lambdas_come_out_not_correct(monkeypatch):
    def shift(index):
        index.aspace.lambdas += 1e-4

    out = built(monkeypatch, shift)
    assert out["correct"] is False
    assert "lambda_gap" in failed(out["checks"])


def test_rows_the_index_does_not_hold_come_out_not_correct(monkeypatch):
    def swap(index):
        index.aspace.data[7, 3] += 1.0

    out = built(monkeypatch, swap)
    assert out["correct"] is False
    assert out["checks"]["data_mismatch"]["value"] == 1


def built(monkeypatch, change):
    """A tiny run whose build's state is changed by ``change(index)``
    before anything reads it."""
    build = search_session.System.build

    def changed(self, rows, seed):
        build(self, rows, seed)
        change(self.index)

    monkeypatch.setattr(search_session.System, "build", changed)
    return tiny_run("glove100-batch2048")


def test_centroids_moved_within_their_rows_come_out_not_correct(
        monkeypatch):
    def nudge(index):       # inside its rows' box, off the running mean
        index.gl.init_data[:, 0] += 1e-3

    out = built(monkeypatch, nudge)
    assert out["correct"] is False
    assert "centroid_gap" in failed(out["checks"])


def test_a_row_assigned_to_another_centroid_comes_out_not_correct(
        monkeypatch):
    def reassign(index):
        a = index.aspace.cluster_assignments
        i = int(np.flatnonzero(a >= 0)[-1])
        a[i] = (a[i] + 1) % int(a.max() + 1)

    out = built(monkeypatch, reassign)
    assert out["correct"] is False
    assert "cluster_faults" in failed(out["checks"])


def test_a_wrong_radius_comes_out_not_correct(monkeypatch):
    def shrink(index):
        index.builder.cluster_radius *= 0.25

    out = built(monkeypatch, shrink)
    assert out["correct"] is False
    assert "cluster_faults" in failed(out["checks"])


def test_replay_follows_the_scan_on_its_own_state():
    """The reference's replay against the port's plain numpy scan on a
    corpus that reaches the cap (so some members count without moving),
    from nothing but the rows and the assignments."""
    import torch
    from arrowspace_torch import clustering
    from arrowspace_torch.sampling import SamplerType
    from portbench.references import lambda_tau

    class Builder:
        sampling = SamplerType.simple(0.6)

    rng = np.random.default_rng(5)
    rows = rng.uniform(0.2, 0.8, (6, 8))[rng.integers(0, 6, 2000)] \
        + rng.normal(0, 0.05, (2000, 8))
    cent, assign, sizes = clustering._incremental_clustering_numpy(
        Builder(), rows, 8, 5, 0.04, Builder.sampling.make(seed=77))
    assign = np.array([-1 if a is None else a for a in assign])
    keep = lambda_tau.keep_mask(77, 2000, 0.6)
    assert np.all(assign[~keep] == -1)
    picked = lambda_tau.sample_rows(77, keep, assign)
    ref, faults = lambda_tau.replay_clustering(
        torch.from_numpy(rows), assign, keep, 5, 0.04, picked)
    assert faults == 0
    assert np.array_equal(ref.numpy(), cent)        # bit for bit
    assert sum(sizes) > 0 and (assign[keep] == -1).any()
    # the cap was reached, and a member that counted without moving
    # changes the centroid when it is taken as a mover
    moved, _ = lambda_tau.replay_clustering(
        torch.from_numpy(rows), assign, keep, 5, 1e9, picked)
    assert not np.array_equal(moved.numpy(), cent)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch
    from portbench.references.lambda_tau import round_tf32
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -3.0 - 2.0 ** -10])
    assert round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                      1.0, -3.0 - 2.0 ** -9]
    assert np.all(np.isfinite(round_tf32(torch.randn(100)).numpy()))
