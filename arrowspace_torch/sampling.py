"""Inline sampling strategies for incremental clustering.

Port of the reference's sampling module (reference: sampling.rs:64-238).

Divergence (deliberate, recorded in SURVEY.md §2): the reference seeds its
samplers from the OS (`StdRng::from_os_rng`), making sampled builds
nondeterministic even under `with_seed`.  Here a sampler accepts an
optional seed; the builder threads its clustering seed through so seeded
builds are fully reproducible, while unseeded builds keep OS entropy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .utils.log import get_logger

logger = get_logger("arrowspace.sampling")

__all__ = ["SamplerType", "SimpleRandomSampler", "DensityAdaptiveSampler",
           "InlineSampler"]


@dataclass(frozen=True)
class SamplerType:
    """Dispatch enum (reference: sampling.rs:89-102)."""

    kind: str   # "simple" | "density_adaptive"
    rate: float

    @staticmethod
    def simple(rate: float) -> "SamplerType":
        return SamplerType("simple", float(rate))

    @staticmethod
    def density_adaptive(rate: float) -> "SamplerType":
        return SamplerType("density_adaptive", float(rate))

    def make(self, seed: Optional[int] = None) -> "InlineSampler":
        if self.kind == "simple":
            return SimpleRandomSampler(self.rate, seed=seed)
        if self.kind == "density_adaptive":
            return DensityAdaptiveSampler(self.rate, seed=seed)
        raise ValueError(f"unknown sampler kind {self.kind!r}")

    def __str__(self) -> str:  # Display parity (sampling.rs:240-247)
        name = "Simple" if self.kind == "simple" else "DensityAdaptive"
        r = repr(self.rate)
        r = r[:-2] if r.endswith(".0") else r
        return f"{name}({r})"

    def to_config(self):
        name = "Simple" if self.kind == "simple" else "DensityAdaptive"
        return {name: self.rate}

    @staticmethod
    def from_config(cfg) -> "SamplerType":
        (k, v), = cfg.items()
        return SamplerType.simple(v) if k == "Simple" \
            else SamplerType.density_adaptive(v)


class InlineSampler:
    """Trait analogue (reference: sampling.rs:64-81)."""

    def should_keep(self, row, nearest_dist_sq: float,
                    centroids_count: int, max_centroids: int) -> bool:
        raise NotImplementedError

    def get_stats(self):
        return (self.sampled_count, self.discarded_count)

    def name(self) -> str:
        raise NotImplementedError

    # Vectorised fast path used by the chunked clustering mode: returns the
    # per-row keep probability; decisions are made against precomputed
    # uniforms so sequential and chunked modes agree for a given seed.
    def keep_probability(self, nearest_dist_sq, centroids_count,
                         max_centroids):
        raise NotImplementedError


class SimpleRandomSampler(InlineSampler):
    """Uniform keep-rate sampler (reference: sampling.rs:108-159)."""

    def __init__(self, target_rate: float, seed: Optional[int] = None):
        logger.info("Simple random sampler with keep rate %.1f%%",
                    target_rate * 100.0)
        self.keep_rate = target_rate
        self._rng = np.random.default_rng(seed)
        self.sampled_count = 0
        self.discarded_count = 0

    def should_keep(self, row, nearest_dist_sq, centroids_count,
                    max_centroids) -> bool:
        keep = self._rng.random() < self.keep_rate
        if keep:
            self.sampled_count += 1
        else:
            self.discarded_count += 1
        return keep

    def keep_probability(self, nearest_dist_sq, centroids_count,
                         max_centroids):
        return np.full_like(np.asarray(nearest_dist_sq, dtype=np.float64),
                            self.keep_rate)

    def name(self) -> str:
        return "SimpleRandomSampler"


class DensityAdaptiveSampler(InlineSampler):
    """Density-adaptive sampler (reference: sampling.rs:167-238).

    rate = base·(1 - 0.1·saturation)·(1 + 0.3·max(0, ln(d² + 0.1))),
    clamped to [0.01, 1].
    """

    def __init__(self, target_rate: float, seed: Optional[int] = None):
        logger.info("Density-adaptive sampler with base rate %.2f%%",
                    target_rate * 100.0)
        self.base_rate = target_rate
        self.current_idx = 0
        self._rng = np.random.default_rng(seed)
        self.sampled_count = 0
        self.discarded_count = 0

    def _rate(self, nearest_dist_sq, centroids_count, max_centroids):
        saturation = centroids_count / max_centroids if max_centroids else 0.0
        dist_factor = max(math.log(nearest_dist_sq + 0.1), 0.0) \
            if np.isfinite(nearest_dist_sq) else 0.0
        rate = self.base_rate * (1.0 - saturation * 0.1) \
            * (1.0 + dist_factor * 0.3)
        return min(max(rate, 0.01), 1.0)

    def should_keep(self, row, nearest_dist_sq, centroids_count,
                    max_centroids) -> bool:
        self.current_idx += 1
        rate = self._rate(nearest_dist_sq, centroids_count, max_centroids)
        keep = self._rng.random() < rate
        if keep:
            self.sampled_count += 1
        else:
            self.discarded_count += 1
        return keep

    def keep_probability(self, nearest_dist_sq, centroids_count,
                         max_centroids):
        d2 = np.asarray(nearest_dist_sq, dtype=np.float64)
        saturation = centroids_count / max_centroids if max_centroids else 0.0
        dist_factor = np.maximum(np.log(np.where(np.isfinite(d2), d2, 0.0)
                                        + 0.1), 0.0)
        dist_factor = np.where(np.isfinite(d2), dist_factor, 0.0)
        rate = self.base_rate * (1.0 - saturation * 0.1) \
            * (1.0 + dist_factor * 0.3)
        return np.clip(rate, 0.01, 1.0)

    def name(self) -> str:
        return "DensityAdaptiveSampler"
