"""Unified planner API: ByteScale Alg. 1, Alg. 2 and the static-CP baseline
behind one validated entry point.

Every consumer (Trainer via GlobalScheduler, the dry-run, benchmarks,
examples) obtains plans through ``plan(lengths, spec)``; the three
underlying constructors (`naive_hdp_plan`, `balance_plan`, `static_cp_plan`)
are implementation details of `core/`.  A `PlanSpec` bundles everything the
planners need — strategy, capacity/HDP geometry, the Eq. 3 cost
coefficients, the ring-traffic comm model, offload and straggler knobs —
and `PlanSpec.for_config` derives the model-dependent parts from a
ModelConfig, which is what the loader/trainer/benchmarks used to duplicate
by hand.

`plan()` ALWAYS runs `validate_plan` (exact token cover + per-rank capacity)
before returning: a plan that reaches an executor is a checked plan.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import offload as OF
from repro_torch.core.balance import balance_plan
from repro_torch.core.hdp import (CommModel, StepPlan, kv_bytes_per_token,
                            naive_hdp_plan, static_cp_plan,
                            uniform_cp_width, validate_plan)

STRATEGIES = ("balance", "naive", "static")


@dataclass(frozen=True)
class PlanSpec:
    """Everything `plan()` needs beyond the batch's lengths.

    strategy  "balance" (Alg. 2) | "naive" (Alg. 1) | "static" (CP baseline)
    mode      balance sub-mode: "dp" (DP-Balance) | "pp" (PP-Balance)
    coeffs    Eq. 3 per-layer cost model T(s)/Act(s)
    comm      ring dist-attention traffic model (None = compute-only)
    rank_speed  [hdp] relative throughput (straggler mitigation), or None
    cp_degree   static strategy: fixed CP width (None = auto divisor width)
    balance_d   naive strategy: Eq. 3 D floor with balanced group sizing
    num_stages  pipeline depth the plan will execute on (stamped into
                plan.stats so the executor layer can match plan ↔ schedule;
                mode="pp" is the intended pairing when > 1)
    pp_width    force PP-Balance's uniform CP width (the lookahead window
                planner sizes one width for a whole window of steps)
    n_periods   scanned layer periods of the model (offload-window grid for
                the PP × offload co-plan; derived by `for_config`)
    snap_widths DP-Balance: round long-sequence group widths UP onto the
                HDP divisor grid (compile-reuse-aware sizing — the
                lookahead scheduler turns this on)
    """
    capacity: int
    hdp: int
    coeffs: OF.CostCoeffs
    num_layers: int
    strategy: str = "balance"
    mode: str = "dp"
    num_stages: int = 1
    use_offload: bool = True
    balance_d: bool = False
    quadratic: bool = True
    zigzag: bool = True
    comm: Optional[CommModel] = None
    rank_speed: Optional[np.ndarray] = None
    cp_degree: Optional[int] = None
    pp_width: Optional[int] = None
    n_periods: Optional[int] = None
    snap_widths: bool = False
    n_buckets: int = 8
    delta: Optional[float] = None

    @classmethod
    def for_config(cls, cfg, *, capacity: int, hdp: int,
                   hw: Optional[OF.OffloadHW] = None, mfu: float = 0.5,
                   ici_bw: Optional[float] = None, **overrides) -> "PlanSpec":
        """Derive the model-dependent fields (cost coefficients, ring
        payload, attention-free quadratic/zigzag switches) from a
        ModelConfig + hardware preset."""
        coeffs = OF.analytic_coeffs(cfg, hw or OF.OffloadHW(), mfu=mfu)
        comm_kw = dict(kv_bytes_per_token=kv_bytes_per_token(cfg))
        if ici_bw is not None:
            comm_kw["ici_bw"] = ici_bw
        kw = dict(capacity=capacity, hdp=hdp, coeffs=coeffs,
                  num_layers=cfg.num_layers, comm=CommModel(**comm_kw),
                  quadratic=not cfg.attention_free,
                  zigzag=not cfg.attention_free,
                  n_periods=OF.scan_periods(cfg))
        kw.update(overrides)        # explicit overrides win over derived
        return cls(**kw)

    def replace(self, **kw) -> "PlanSpec":
        return dataclasses.replace(self, **kw)


def auto_cp_degree(lengths: Sequence[int], capacity: int, hdp: int) -> int:
    """The baseline's CP width: the smallest width covering the longest
    sequence at `capacity` tokens/rank that also DIVIDES the HDP axis, so
    the documented `DP = hdp / cp` geometry always holds.  (The old
    next-power-of-two rule could exceed the largest pow2 divisor of a
    non-pow2 `hdp` — e.g. hdp=12 with a 8·capacity sequence gave cp=8,
    12/8 non-integral; for pow2 `hdp` the divisor rule is identical.)"""
    return uniform_cp_width(lengths, capacity, hdp)


def plan(lengths: Sequence[int], spec: PlanSpec) -> StepPlan:
    """Plan one global batch.  Dispatches on ``spec.strategy``, stamps the
    strategy into ``plan.stats`` and always validates before returning."""
    lengths = [int(ln) for ln in lengths]
    kw = dict(capacity=spec.capacity, hdp=spec.hdp, coeffs=spec.coeffs,
              num_layers=spec.num_layers, comm=spec.comm,
              quadratic=spec.quadratic, zigzag=spec.zigzag)
    if spec.strategy == "static":
        cp = spec.cp_degree or auto_cp_degree(lengths, spec.capacity,
                                              spec.hdp)
        p = static_cp_plan(lengths, cp_degree=cp, **kw)
        p.stats["cp_degree"] = cp
    elif spec.strategy == "naive":
        p = naive_hdp_plan(lengths, use_offload=spec.use_offload,
                           balance_d=spec.balance_d, **kw)
    elif spec.strategy == "balance":
        speed = None if spec.rank_speed is None \
            else np.asarray(spec.rank_speed, dtype=float)
        p = balance_plan(lengths, mode=spec.mode,
                         use_offload=spec.use_offload, rank_speed=speed,
                         n_buckets=spec.n_buckets, delta=spec.delta,
                         pp_width=spec.pp_width, num_stages=spec.num_stages,
                         n_periods=spec.n_periods,
                         snap_widths=spec.snap_widths, **kw)
    else:
        raise ValueError(
            f"unknown strategy {spec.strategy!r}; expected one of "
            f"{STRATEGIES}")
    p.stats["strategy"] = spec.strategy
    p.stats["num_stages"] = spec.num_stages
    validate_plan(p, lengths)
    return p


def plan_window(window_lengths: Sequence[Sequence[int]], spec: PlanSpec,
                **kw) -> "list[StepPlan]":
    """Jointly plan a lookahead window of K global batches (one length
    list per step) — the multi-batch entry point.  Per-step token cover
    and Eq. 2 denominators are identical to calling `plan` per step; the
    window planner only co-decides *layout*: shared composition templates
    (compile-cache reuse), cross-step rank leveling, one PP width and
    stage-tiling offload ratios for the whole window.  Implemented in
    `repro_torch.sched.lookahead`; every returned plan is validate_plan-checked.
    """
    from repro_torch.sched.lookahead import plan_window as _plan_window
    return _plan_window(window_lengths, spec, **kw)
