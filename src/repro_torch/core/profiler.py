"""Cost-model fitting of the Profiler (ByteScale Fig. 7's third component).

Copy of the numpy part of `repro/core/profiler.py`: `fit_time_coeffs`
least-squares fits measured (length, seconds) samples to

    T(s)   = α₁·s² + β₁·s + γ        per-layer step time

and `blend_coeffs` mixes a fit into running coefficients, as the online
calibrator (`sched/calibrate.py`) uses them.  Timing real forwards
(`profile_model`) and host-transfer bandwidths come later.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.offload import CostCoeffs


def fit_time_coeffs(lengths: Sequence[int], seconds: Sequence[float],
                    act_per_token: float, quadratic: bool = True
                    ) -> CostCoeffs:
    """Least-squares fit of T(s) = α₁s² + β₁s + γ (α₁ pinned to 0 for
    attention-free models)."""
    s = np.asarray(lengths, np.float64)
    y = np.asarray(seconds, np.float64)
    cols = [s * s, s, np.ones_like(s)] if quadratic else [s, np.ones_like(s)]
    a = np.stack(cols, axis=1)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    if quadratic:
        a1, b1, g = coef
    else:
        a1, (b1, g) = 0.0, coef
    return CostCoeffs(a1=max(float(a1), 0.0), b1=max(float(b1), 0.0),
                      g=max(float(g), 0.0), a2=float(act_per_token), b2=0.0)


def blend_coeffs(base: CostCoeffs, fitted: CostCoeffs,
                 blend: float = 0.5) -> CostCoeffs:
    """Convex blend of two coefficient sets (blend=1 → fully fitted).

    The online calibrator (sched/calibrate.py) refits T(s) from a sliding
    window of measured wave times; blending toward the previous
    coefficients keeps one noisy window from capsizing every plan in the
    lookahead buffer.  Act(s) is a byte count, not a timing — it stays at
    the base's value."""
    b = min(max(float(blend), 0.0), 1.0)
    mix = lambda x, y: (1.0 - b) * x + b * y
    return CostCoeffs(a1=mix(base.a1, fitted.a1), b1=mix(base.b1, fitted.b1),
                      g=mix(base.g, fitted.g), a2=base.a2, b2=base.b2)
