"""Corpus and query pool of a configuration, made from the seed.

The generator is the serving mixture of the repository's smoke test
(chip_smoke.py:278-285, itself from bench.py:324-328): ``centres``
uniform centres in [low, high] and Gaussian noise of ``noise`` around
them.  The centres are the deployment's: the configuration fixes them
(``centres_seed``), so that every seed serves the same corpus shape and
the same work; the run's seed draws each row's centre and noise.  It
draws on the given device from ``torch.Generator``s in a few large
calls, in float32, the type the index serves.  Queries are fresh draws
around the same centres, made after the corpus from the run's generator.
The same seed on the same device gives the same numbers.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    below 2**63; larger ones are reduced modulo 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def make(cfg: dict, seed: int, device, n_queries: int):
    """(rows (N, F), queries (n_queries, F)) float32 tensors on ``device``
    for a configuration whose ``generator`` is a mixture."""
    gen = cfg["generator"]
    n, f = int(cfg["rows"]), int(cfg["features"])
    lo, hi = float(gen["low"]), float(gen["high"])
    centres = torch.rand((int(gen["centres"]), f),
                         generator=generator(gen["centres_seed"], device),
                         device=device) * (hi - lo) + lo
    g = generator(seed, device)

    def draw(count: int) -> torch.Tensor:
        labels = torch.randint(0, centres.shape[0], (count,), generator=g,
                               device=device)
        out = torch.randn((count, f), generator=g, device=device)
        out.mul_(float(gen["noise"])).add_(centres[labels])
        return out

    rows = draw(n)
    return rows, draw(n_queries)
