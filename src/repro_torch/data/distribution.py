"""Skewed sequence-length distributions resembling ByteScale Fig. 4.

Two presets:
  * "github" — code repositories: moderately heavy tail (the paper reports
    16.2% of tokens from sequences >128K at a 2M context).
  * "byted"  — production mix: ~80% of samples ≤4K, yet 0.05% of samples
    reach 2M and sequences ≥128K carry ~40% of the tokens.

Deterministic given a seed; used by tests, benchmarks (Fig. 4/6/17/18) and
the example drivers.  Lengths are clipped to [16, context] and the sampler
can draw "a global batch of B tokens" like the paper's 32M-token batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class LengthDistribution:
    name: str
    lognorm_mean: float          # body of the distribution (log-space)
    lognorm_sigma: float
    tail_frac: float             # fraction of samples drawn from the tail
    tail_alpha: float            # pareto exponent (smaller = heavier)
    tail_scale: float            # pareto x_m

    def sample(self, rng: np.random.Generator, n: int,
               context: int) -> np.ndarray:
        body = rng.lognormal(self.lognorm_mean, self.lognorm_sigma, size=n)
        tail = self.tail_scale * (1.0 + rng.pareto(self.tail_alpha, size=n))
        is_tail = rng.random(n) < self.tail_frac
        lens = np.where(is_tail, tail, body)
        return np.clip(lens, 16, context).astype(np.int64)

    def sample_tokens(self, rng: np.random.Generator, total_tokens: int,
                      context: int) -> List[int]:
        """Draw sequences until ~total_tokens accumulated (global batch)."""
        out: List[int] = []
        acc = 0
        while acc < total_tokens:
            ln = int(self.sample(rng, 1, context)[0])
            ln = min(ln, total_tokens - acc) or 16
            out.append(ln)
            acc += ln
        return out


GITHUB = LengthDistribution("github", lognorm_mean=7.6, lognorm_sigma=1.3,
                            tail_frac=0.05, tail_alpha=1.3,
                            tail_scale=16_384)
BYTED = LengthDistribution("byted", lognorm_mean=7.2, lognorm_sigma=1.1,
                           tail_frac=0.005, tail_alpha=0.85,
                           tail_scale=65_536)

DISTRIBUTIONS = {"github": GITHUB, "byted": BYTED}


def token_share_above(lengths, threshold: int) -> float:
    a = np.asarray(lengths, dtype=np.float64)
    return float(a[a >= threshold].sum() / a.sum()) if a.sum() else 0.0
