"""The generator: the same seed gives the same corpus and queries."""

import torch

from portbench.generators import mixture

CFG = {"rows": 500, "features": 12,
       "generator": {"kind": "mixture", "centres": 8, "centres_seed": 3,
                     "low": 0.2, "high": 0.8, "noise": 0.05}}


def test_same_seed_same_data():
    a_rows, a_q = mixture.make(CFG, 2**31 + 99, "cpu", 40)
    b_rows, b_q = mixture.make(CFG, 2**31 + 99, "cpu", 40)
    assert torch.equal(a_rows, b_rows) and torch.equal(a_q, b_q)
    assert a_rows.shape == (500, 12) and a_q.shape == (40, 12)
    assert a_rows.dtype == torch.float32


def test_other_seed_other_data():
    a_rows, a_q = mixture.make(CFG, 1, "cpu", 40)
    b_rows, b_q = mixture.make(CFG, 2, "cpu", 40)
    assert not torch.equal(a_rows, b_rows)
    assert not torch.equal(a_q, b_q)


def test_every_seed_draws_around_the_configured_centres():
    a, _ = mixture.make(CFG, 1, "cpu", 4)
    b, _ = mixture.make(CFG, 2, "cpu", 4)
    other = {**CFG, "generator": {**CFG["generator"], "centres_seed": 4}}
    c, _ = mixture.make(other, 1, "cpu", 4)
    # two draws around one centre lie about 0.05·√(2F) = 0.24 apart;
    # centres drawn anew lie farther from every row
    near = torch.cdist(a.double(), b.double()).min(dim=1).values
    assert float(near.max()) < 0.4
    far = torch.cdist(c.double(), a.double()).min(dim=1).values
    assert float(far.max()) > 0.4


def test_queries_are_fresh_draws_around_the_corpus_centres():
    rows, q = mixture.make(CFG, 5, "cpu", 200)
    # every query lies near some corpus row (same centres), none is a copy
    d = torch.cdist(q.double(), rows.double()).min(dim=1).values
    assert float(d.min()) > 0.0
    assert float(d.max()) < 1.0


def test_seeds_past_63_bits_are_taken():
    a, _ = mixture.make(CFG, 2**64 + 3, "cpu", 4)
    b, _ = mixture.make(CFG, 3 + 2**63, "cpu", 4)
    assert torch.equal(a, b)
