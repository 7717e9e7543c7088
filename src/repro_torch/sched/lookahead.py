"""Lookahead window planning: joint layout of K upcoming global batches.

ByteScale's balance scheduler sees a buffer of upcoming data (the remote
dataloader ships length metadata ahead of the tokens), so assignment can be
parallelism-aware *across* micro-batch steps, not one global batch at a
time.  This module reproduces that as a pure planning layer on top of the
per-step planner:

1. **Per-step plans stay per-step.**  Each step in the window is planned
   from exactly its own sequences (`core.planner.plan`), so the Eq. 2
   denominator and the token cover of every step are identical to per-step
   planning — no sequence moves across a step boundary (loss semantics and
   data order are untouchable; what the lookahead owns is *layout*).

2. **Template harmonization** collapses compile keys.  Two waves whose
   compositions are rank-permutations of each other — (2,1,1) vs (1,2,1) —
   are the same *work* but distinct jitted executables (the trainer's
   compile cache keys on the composition tuple, our analogue of the paper's
   NCCL-group cache).  The window planner registers one **template** tuple
   per (width-multiset, c_mult) class — the first composition seen for the
   class, or a warm key the trainer has already compiled — and permutes
   every later matching wave's groups onto it.  Since every template is
   itself one of the plans' own compositions, the set of distinct
   compositions after harmonization is a subset of the per-step set:
   the distinct-key count is provably ≤ per-step planning's, on any input.

3. **Cross-step balance.**  Same-width template positions are
   interchangeable, so each wave's groups are re-placed costliest-group →
   least-loaded-rank-window against per-rank load carried across the whole
   window (speed-weighted, like Alg. 2's lagging-rank targeting).  Per-step
   planning resets that accumulator every step and its deterministic scan
   bias parks the overshoot on the same low ranks step after step; carrying
   it makes step t+1 compensate step t, so the *window* makespan
   (max_r Σ_steps Σ_waves cost) drops on skewed mixes.

4. **PP co-planning.**  In PP-Balance mode the window shares ONE uniform
   CP width (sized for the longest sequence in the whole window, not per
   step) so every step's single round runs through the same pipelined
   executable, and offload ratios are quantized so stage-sharded offload
   windows tile the global window (`core.offload.quantize_stage_ratio`).

Offload ratios are additionally snapped up to an ⅛ grid (`OFFLOAD_QUANT`)
everywhere: rounding *up* keeps Eq. 3's memory bound satisfied (more
offload never needs more ranks) while collapsing the long tail of distinct
offload keys the exact ratios produce.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hdp import StepPlan, Wave, validate_plan

OFFLOAD_QUANT = 8                 # offload ratios snap UP to this grid


def wave_key(wave: Wave) -> Tuple:
    """The trainer's compile-cache key for a wave (train/trainer.py
    `_wave_fn`): one jitted executable per distinct value."""
    return (tuple(wave.composition), wave.c_mult,
            round(wave.offload_ratio, 2))


def quantize_ratio(r: float, quant: int = OFFLOAD_QUANT) -> float:
    """Snap an offload ratio UP to the 1/quant grid (0 stays 0).  Rounding
    up only ever offloads *more*, so Eq. 3's D(s) stays feasible."""
    if r <= 0.0:
        return 0.0
    return min(1.0, math.ceil(r * quant - 1e-9) / quant)


@dataclass
class _Group:
    """One composition entry of a wave: width-g contiguous rank block that
    moves as a unit (a sharded sequence, a packed bin, or an idle rank)."""
    width: int
    slots: List[List]               # per member rank
    costs: List[float]

    @property
    def cost(self) -> float:
        return max(self.costs) if self.costs else 0.0


def _wave_groups(wave: Wave) -> List[_Group]:
    out, r = [], 0
    for g in wave.composition:
        out.append(_Group(width=g, slots=[wave.slots[r + j] for j in range(g)],
                          costs=[wave.costs[r + j] for j in range(g)]))
        r += g
    return out


def _template_positions(comp: Tuple[int, ...]) -> Dict[int, List[int]]:
    """width -> start ranks of that width's blocks in the template."""
    pos: Dict[int, List[int]] = {}
    r = 0
    for g in comp:
        pos.setdefault(g, []).append(r)
        r += g
    return pos


def template_class(composition, c_mult: int) -> Tuple:
    """Template-class key: waves with the same width multiset and buffer
    size can share one composition tuple (groups are position-free).  The
    single definition both harmonization and the service's warm-key
    seeding key the registry with."""
    return (tuple(sorted(composition, reverse=True)), c_mult)


def _class_key(wave: Wave) -> Tuple:
    return template_class(wave.composition, wave.c_mult)


def harmonize_window(plans: Sequence[StepPlan], hdp: int, *,
                     templates: Optional[Dict[Tuple, Tuple]] = None,
                     load: Optional[np.ndarray] = None,
                     rank_speed: Optional[np.ndarray] = None,
                     offload_quant: int = OFFLOAD_QUANT) -> Dict[Tuple, Tuple]:
    """In-place: permute every wave's groups onto its class template with
    load-aware placement; quantize offload ratios.  ``templates`` persists
    across windows (the service passes its registry, pre-seeded with the
    trainer's warm compile keys); ``load`` likewise carries per-rank
    accumulated time across windows."""
    templates = {} if templates is None else templates
    load = np.zeros(hdp) if load is None else load
    speed = np.ones(hdp) if rank_speed is None \
        else np.maximum(np.asarray(rank_speed, float), 1e-3)
    for plan in plans:
        # PP plans carry a stage-tiling co-planned ratio
        # (quantize_stage_ratio) — re-snapping it onto the 1/quant grid
        # would reintroduce the per-stage drift it was built to avoid
        pp_plan = plan.stats.get("pp_width") is not None
        for wave in plan.waves:
            if not pp_plan:
                wave.offload_ratio = quantize_ratio(wave.offload_ratio,
                                                    offload_quant)
            ck = _class_key(wave)
            template = templates.setdefault(ck, tuple(wave.composition))
            groups = _wave_groups(wave)
            positions = _template_positions(template)
            new_slots: List[List] = [[] for _ in range(hdp)]
            new_costs = [0.0] * hdp
            by_width: Dict[int, List[_Group]] = {}
            for grp in groups:
                by_width.setdefault(grp.width, []).append(grp)
            for width, grps in sorted(by_width.items(), reverse=True):
                starts = list(positions[width])
                # costliest group claims the least-loaded rank window
                # (Alg. 2's lagging-rank targeting, carried across steps)
                for grp in sorted(grps, key=lambda g: -g.cost):
                    s = min(starts,
                            key=lambda st: float(load[st:st + width].sum()))
                    starts.remove(s)
                    for j in range(width):
                        new_slots[s + j] = grp.slots[j]
                        new_costs[s + j] = grp.costs[j]
                        load[s + j] += grp.costs[j] / speed[s + j]
            wave.slots = new_slots
            wave.costs = new_costs
            wave.composition = template
        # layout changed: refresh the derived per-rank stats in place
        from repro_torch.core.hdp import plan_stats
        plan.stats.update(plan_stats(plan))
    return templates


def plan_window(window_lengths: Sequence[Sequence[int]], spec, *,
                templates: Optional[Dict[Tuple, Tuple]] = None,
                load: Optional[np.ndarray] = None,
                snap_widths: bool = True,
                offload_quant: int = OFFLOAD_QUANT) -> List[StepPlan]:
    """Jointly plan a window of K global batches (one length list per
    step).  Returns one validated StepPlan per step; step boundaries,
    token cover and Eq. 2 denominators are identical to per-step planning.

    ``spec`` is a `core.planner.PlanSpec`; in PP-Balance mode the whole
    window is forced onto one uniform CP width so every step shares one
    pipelined executable; in DP-Balance mode ``snap_widths`` (default on)
    snaps long-sequence group widths onto the HDP divisor grid so widths —
    and with them compositions — repeat across steps.  With
    ``snap_widths=False`` the per-step plans are exactly `plan()`'s, and
    harmonization alone guarantees distinct-composition count ≤ per-step
    planning's (templates are drawn from the plans' own compositions)."""
    from repro_torch.core import planner as PL
    from repro_torch.core.hdp import uniform_cp_width

    spec_step = spec
    if spec.strategy == "balance" and spec.mode == "pp":
        every = [ln for step in window_lengths for ln in step]
        if every:
            spec_step = spec.replace(pp_width=uniform_cp_width(
                every, spec.capacity, spec.hdp))
    elif spec.strategy == "balance" and snap_widths:
        spec_step = spec.replace(snap_widths=True)
    plans = [PL.plan(list(lengths), spec_step)
             for lengths in window_lengths]
    harmonize_window(plans, spec.hdp, templates=templates, load=load,
                     rank_speed=spec.rank_speed, offload_quant=offload_quant)
    for p, lengths in zip(plans, window_lengths):
        validate_plan(p, [int(x) for x in lengths])
        p.stats["lookahead"] = len(window_lengths)
    return plans


def window_stats(plans: Sequence[StepPlan]) -> Dict:
    """Window-level quality metrics: the async-dispatch window makespan
    (max_r of per-rank time summed over every step's waves), the lockstep
    bound, and the compile-cache footprint (distinct trainer keys /
    composition tuples across the window)."""
    waves = [w for p in plans for w in p.waves]
    if not waves:
        return {"window_makespan": 0.0, "window_lockstep": 0.0,
                "ideal": 0.0, "bubble_frac": 0.0, "n_waves": 0,
                "distinct_keys": 0, "distinct_compositions": 0}
    hdp = len(waves[0].costs)
    per_rank = np.zeros(hdp)
    for w in waves:
        per_rank += np.asarray(w.costs)
    makespan = float(per_rank.max())
    ideal = float(per_rank.mean())
    return {
        "window_makespan": makespan,
        "window_lockstep": float(sum(max(w.costs) for w in waves)),
        "ideal": ideal,
        "bubble_frac": 1.0 - ideal / makespan if makespan > 0 else 0.0,
        "n_waves": len(waves),
        "distinct_keys": len({wave_key(w) for w in waves}),
        "distinct_compositions": len({tuple(w.composition) for w in waves}),
    }
