"""Selective activation offloading — ByteScale Eq. 3.

A copy of `repro/core/offload.py` (only the imports rewritten), so the
port plans exactly as the reference does.  Given per-layer compute time
T(s) = α₁s² + β₁s + γ and activation bytes Act(s) = α₂s + β₂, pick the
offload ratio r that minimizes the number of HDP ranks D(s) needed for a
sequence of length s, subject to the transfer being hidden under compute:

    D(s) = ceil( (2·Act(s) + (1-r)(l-2)·Act(s)) / (l·Act(C)) )
    T(s) ≥ Act(s)·r / min(B_d2h, B_h2d)
    min(1, l·Act(C) / ((l-2)·Act(s))) ≥ r ≥ 0        (paper's bound)

The hardware constants of `OffloadHW` are the reference's defaults, kept
so that planner parity holds; they are not measured on the card the port
runs on.  The planner calls `solve_eq3` without ``hw``, so Eq. 3's
overlap bound uses them (`chip_smoke.py` prints the card's measured
pinned-copy bandwidth and the bound at both).

Execution side: the first ``offload_periods(cfg, r)`` layer periods of a
wave keep their input residual in pinned host memory between the forward
and the backward's recompute (`models/transformer.py::apply_periods`,
`parallel/host_offload.py`), the FILO order of the paper's act_ctx, with
a copy stream beside the compute stream.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class OffloadHW:
    """Transfer/compute constants: the reference's defaults (planner
    parity), not figures of the port's card."""
    d2h_bw: float = 25e9           # device->host bytes/s
    h2d_bw: float = 25e9           # host->device bytes/s
    peak_flops: float = 197e12     # compute rate, flop/s


@dataclass(frozen=True)
class CostCoeffs:
    """T(s) = a1 s^2 + b1 s + g ; Act(s) = a2 s + b2   (per layer, per rank
    set of tokens s)."""
    a1: float
    b1: float
    g: float
    a2: float
    b2: float


def analytic_coeffs(cfg: ModelConfig, hw: OffloadHW = OffloadHW(),
                    mfu: float = 0.5) -> CostCoeffs:
    """Derive Eq. 3 coefficients from the model config (the Profiler can
    replace these with measured fits — core/profiler.py)."""
    d = cfg.d_model
    h = cfg.num_heads
    dk = cfg.resolved_head_dim
    eff = hw.peak_flops * mfu
    # attention: 4·s²·H·dk flops per layer (fwd QK^T + AV); linear: ~(qkvo +
    # ffn) ≈ 2·s·(4·d·H·dk + mlp)
    mlp_flops = 2 * 3 * d * cfg.d_ff if cfg.gated_mlp else 2 * 2 * d * cfg.d_ff
    a1 = 4.0 * h * dk / eff
    b1 = (2 * 4 * d * h * dk + mlp_flops) / eff
    # activations per token per layer (bf16): residual + attn/ffn
    # checkpoints ~ (2·d + H·dk + d_ff/4) · 2 bytes (remat-lite estimate)
    act_per_tok = (2 * d + h * dk + cfg.d_ff // 4) * 2
    return CostCoeffs(a1=a1, b1=b1, g=1e-5, a2=float(act_per_tok), b2=0.0)


def act_bytes(c: CostCoeffs, s: float) -> float:
    return c.a2 * s + c.b2


def layer_time(c: CostCoeffs, s: float) -> float:
    return c.a1 * s * s + c.b1 * s + c.g


def max_overlap_ratio(c: CostCoeffs, s: float, hw: OffloadHW) -> float:
    """Largest r hidden under compute: T(s) ≥ Act(s)·r / min(B)."""
    bw = min(hw.d2h_bw, hw.h2d_bw)
    if act_bytes(c, s) <= 0:
        return 1.0
    return min(1.0, layer_time(c, s) * bw / act_bytes(c, s))


def solve_eq3(cfg_or_coeffs, s: int, capacity: int, num_layers: int,
              hw: OffloadHW = OffloadHW(), quadratic: bool = True):
    """Returns (r, D) — offload ratio and min required HDP ranks for a
    sequence of length s (paper Alg. 1 lines 1–6).

    ``quadratic=False`` zeroes α₁ (attention-free archs like RWKV: linear
    compute cannot hide linear transfers, so r is bounded by β₁·B/α₂ —
    DESIGN.md §5)."""
    c = cfg_or_coeffs if isinstance(cfg_or_coeffs, CostCoeffs) \
        else analytic_coeffs(cfg_or_coeffs, hw)
    if not quadratic:
        c = CostCoeffs(a1=0.0, b1=c.b1, g=c.g, a2=c.a2, b2=c.b2)
    ell = max(num_layers, 3)
    if s <= capacity:
        return 0.0, 1
    act_s = act_bytes(c, s)
    act_c = act_bytes(c, capacity)
    r = min(max_overlap_ratio(c, s, hw), 1.0)
    # Paper's upper bound on r, applied in its exact form.  The transcribed
    # ``r_cap = l·Act(C)/((l-2)·Act(s))`` was dead code (computed, then
    # del'd without clamping) — and applying it verbatim would be wrong:
    # for s >> C it caps r at ~Act(C)/Act(s) ≈ 0, erasing the offload win
    # of Fig. 11.  The bound's intent is "offloading past the point where
    # D(s) stops shrinking is wasted transfer", so we cap r at the
    # *saturation ratio*: the smallest r that already reaches the best
    # achievable D (the D at full offload, where only the first/last
    # layers' 2·Act(s) remain resident).  D(s) is unchanged at every s;
    # only wasted D2H/H2D traffic is dropped.
    d_best = max(1, math.ceil(2 * act_s / (ell * act_c)))
    r_sat = max(0.0, 1.0 - (d_best * ell * act_c - 2 * act_s)
                / max((ell - 2) * act_s, 1e-9))
    if r_sat < r:
        r, d = r_sat, d_best        # D(r_sat) == d_best by construction
    else:
        d = math.ceil((2 * act_s + (1 - r) * (ell - 2) * act_s)
                      / (ell * act_c))
    d_no_offload = math.ceil(act_s / act_c)
    return r, max(1, min(d, d_no_offload))


def eq3_bytes(cfg_or_coeffs, s: int, r: float, num_layers: int,
              hw: OffloadHW = OffloadHW(), quadratic: bool = True):
    """(d2h, h2d) byte totals Eq. 3 moves for one sequence of length s at
    offload ratio r — the arithmetic `solve_eq3` prices internally (the
    ``r·(l-2)·Act(s)`` term its D(s) numerator subtracts): the first and
    last layers never offload, every other layer ships ``r`` of its
    activations out and back.  Shared by the bytes ledger and
    benchmarks/offload_sweep.py so neither re-derives the formula."""
    if r <= 0:
        return 0.0, 0.0
    c = cfg_or_coeffs if isinstance(cfg_or_coeffs, CostCoeffs) \
        else analytic_coeffs(cfg_or_coeffs, hw)
    if not quadratic:
        c = CostCoeffs(a1=0.0, b1=c.b1, g=c.g, a2=c.a2, b2=c.b2)
    ell = max(num_layers, 3)
    moved = float(r) * (ell - 2) * act_bytes(c, s)
    return moved, moved


def ratio_for_d(cfg_or_coeffs, s: int, capacity: int, num_layers: int,
                d: int, hw: OffloadHW = OffloadHW(),
                quadratic: bool = True):
    """Smallest offload ratio that makes `d` ranks memory-feasible for a
    sequence of length s (inverts Eq. 3's D formula); None if infeasible
    (transfer can't hide under compute)."""
    c = cfg_or_coeffs if isinstance(cfg_or_coeffs, CostCoeffs) \
        else analytic_coeffs(cfg_or_coeffs, hw)
    if not quadratic:
        c = CostCoeffs(a1=0.0, b1=c.b1, g=c.g, a2=c.a2, b2=c.b2)
    ell = max(num_layers, 3)
    act_s = act_bytes(c, s)
    if act_s <= 0:
        return 0.0
    r = 1.0 - (d * ell * act_bytes(c, capacity) - 2 * act_s) \
        / max((ell - 2) * act_s, 1e-9)
    if r > 1.0 + 1e-9:
        return None                     # even full offload can't reach d
    r = max(0.0, min(1.0, r))
    if r > max_overlap_ratio(c, s, hw) + 1e-9:
        return None
    return r


def scan_periods(cfg: ModelConfig) -> int:
    """Number of scanned layer periods (the unit the offload window counts
    in — matches parallel/pipeline.num_scan_periods)."""
    period = len(cfg.layer_pattern)
    head_n = cfg.moe.first_k_dense if cfg.moe else 0
    return (cfg.num_layers - head_n) // period


def offload_periods(cfg: ModelConfig, r: float, num_stages: int = 1) -> int:
    """Map a token-level ratio to layer periods whose residuals offload.

    ``num_stages > 1`` (pipeline parallelism): the executor's stage vmap is
    SPMD — every stage runs one program, so the static offload count is
    necessarily *per stage*.  The old global count applied per stage
    offloaded up to ``num_stages×`` the planned fraction (each stage took
    the full global window out of its own slice); the stage-aware count is
    sized against the stage's local period window instead, so the union
    over stages matches the planned global ratio."""
    n_periods = scan_periods(cfg)
    if num_stages > 1:
        n_periods //= num_stages
    return int(round(r * n_periods))


def stage_offload_windows(cfg: ModelConfig, r: float,
                          num_stages: int) -> list:
    """The global leading offload window [0, round(r·n)) split at stage
    boundaries: stage s's share is the overlap with its period span
    [s·n/S, (s+1)·n/S).  The windows are disjoint and contiguous and tile
    the global window exactly — the planner's stage-aware view (and the
    layout an interleaved/virtual-stage schedule would execute directly;
    the current SPMD wavefront realizes the same per-stage *counts* as its
    leading local periods — see `offload_periods`)."""
    n = scan_periods(cfg)
    n_local = n // max(num_stages, 1)
    k = int(round(r * n))
    return [(s * n_local, max(s * n_local, min(k, (s + 1) * n_local)))
            for s in range(num_stages)]


def quantize_stage_ratio(r: float, n_periods: int, num_stages: int) -> float:
    """Smallest ratio ≥ r whose global offload-period count is a multiple
    of ``num_stages`` — with it, the uniform per-stage counts
    (`offload_periods(cfg, r, num_stages)`) sum to the global count
    exactly, so PP-Balance can co-plan one ratio for its uniform-width
    stream without per-stage drift."""
    if r <= 0.0 or n_periods <= 0:
        return 0.0
    if num_stages <= 1:
        return min(1.0, r)
    k_local = math.ceil(r * n_periods / num_stages - 1e-9)
    return min(1.0, k_local * num_stages / n_periods)
