"""ByteScale Alg. 2: the balance scheduler (DP-Balance / PP-Balance).

Faithful structure: sort the global batch by length descending, divide into
buckets of ≈equal total FLOPs, then repeatedly top up the ranks whose
accumulated execution time lags behind by more than δ — each *wave* is
level-uniform (Insight 2: only per-time-step balance matters without PP).

PP-Balance (Insight 1, SPMD adaptation): with pipeline parallelism each
wave is a pipeline *microbatch*, and the executor (parallel/pipeline.py)
compiles one schedule per (composition, c_mult) "round", paying a
(S-1)-slot fill/drain bubble per round.  The pipelined critical path
``[Σ_w max_r cost + (S-1)·peak] / S`` is order-independent, so what the
paper's "uniform micro-batches" requirement buys in a static-shape SPMD
world is *stream homogeneity*: PP-Balance builds EVERY unit at one uniform
CP width g* (the smallest divisor of the HDP axis covering the longest
sequence — `uniform_cp_width`), so the whole step is a single
composition-uniform round: one executable, one pipeline flush, and waves
that stay level because the draw is still longest-bucket-first.  DP-Balance
keeps each sequence's individually-optimal Eq. 3 width (cheaper without
PP, but a heterogeneous stream that fragments a pipelined executor into
many short flush-dominated rounds).

SPMD adaptation of the paper's line 10-17 loop: "assign more micro-batches
to faster ranks" becomes placement into a (rank × wave) grid — a group
unit occupies the same wave slot on `g` contiguous ranks; singleton units
top up whichever lagging rank the loop selects.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import offload as OF
from repro_torch.core.hdp import (Piece, StepPlan, Unit, Wave, build_units,
                            plan_stats, uniform_cp_width)


def bucketize(units: List[Unit], n_buckets: int) -> List[List[Unit]]:
    """Units sorted by cost desc -> buckets of ≈ equal total FLOPs
    (Alg. 2 lines 3-5: long buckets hold fewer items)."""
    units = sorted(units, key=lambda u: -u.cost_per_rank)
    total = sum(u.cost_per_rank * u.ranks for u in units)
    target = total / max(n_buckets, 1)
    buckets: List[List[Unit]] = [[]]
    acc = 0.0
    for u in units:
        if acc >= target and len(buckets) < n_buckets:
            buckets.append([])
            acc = 0.0
        buckets[-1].append(u)
        acc += u.cost_per_rank * u.ranks
    return buckets


def balance_plan(lengths: Sequence[int], *, capacity: int, hdp: int,
                 coeffs: OF.CostCoeffs, num_layers: int,
                 mode: str = "dp", delta: Optional[float] = None,
                 n_buckets: int = 8, use_offload: bool = True,
                 quadratic: bool = True, zigzag: bool = True,
                 comm=None, rank_speed=None,
                 pp_width: Optional[int] = None,
                 num_stages: int = 1,
                 n_periods: Optional[int] = None,
                 snap_widths: bool = False) -> StepPlan:
    """ByteScale Alg. 2.  mode: "dp" (DP-Balance) | "pp" (PP-Balance).

    ``rank_speed`` [hdp]: relative throughput per rank (straggler
    mitigation — slower ranks accumulate virtual time faster and receive
    proportionally less work).

    ``pp_width``: force PP-Balance's uniform CP width instead of deriving
    it from this batch alone — the lookahead scheduler (sched/lookahead.py)
    sizes one width for a whole window of steps so every step shares one
    pipelined executable."""
    pp_offload_r = 0.0
    if mode != "pp":
        pp_width = None                # the knob only exists for PP-Balance
    if mode == "pp":
        # uniform stream (see module docstring): one CP width for every
        # unit, so all waves share one composition and the pipelined
        # executor runs the step as a single round.
        pp_width = pp_width or uniform_cp_width(lengths, capacity, hdp)
        if use_offload and lengths:
            # PP × offload co-plan: the width is fixed by stream
            # uniformity, so offload's remaining job is making that width
            # activation-feasible for the longest sequence (Eq. 3
            # inverted at D = pp_width), with the ratio quantized so the
            # stage-sharded offload windows tile the global window
            # exactly (core/offload.quantize_stage_ratio).
            longest = max(lengths)
            if longest > capacity * pp_width:
                r_need = OF.ratio_for_d(coeffs, longest, capacity,
                                        num_layers, pp_width,
                                        quadratic=quadratic)
                if r_need is None:
                    # the uniform width is memory-infeasible even at full
                    # offload (or the transfer can't hide): offload the
                    # most that still hides under compute rather than
                    # silently planning zero offload — buffer memory is
                    # already covered by c_mult spill, this relieves
                    # activation pressure as far as Eq. 3 allows
                    r_need = OF.max_overlap_ratio(coeffs, longest,
                                                  OF.OffloadHW())
                if n_periods:
                    pp_offload_r = OF.quantize_stage_ratio(
                        r_need or 0.0, n_periods, max(num_stages, 1))
                else:
                    # no period grid known (caller bypassed
                    # PlanSpec.for_config): use the raw ratio — wrong-grid
                    # quantization would silently void the exact
                    # stage-tiling guarantee instead of approximating it
                    pp_offload_r = min(1.0, r_need or 0.0)
        units = build_units(lengths, capacity, hdp, coeffs,
                            num_layers=num_layers, use_offload=False,
                            quadratic=quadratic, zigzag=zigzag, comm=comm,
                            static_cp=pp_width)
    else:
        units = build_units(lengths, capacity, hdp, coeffs,
                            num_layers=num_layers, use_offload=use_offload,
                            quadratic=quadratic, zigzag=zigzag, comm=comm,
                            balance_d=True, snap_widths=snap_widths)
    buckets = bucketize(units, n_buckets)
    if delta is None:
        costs = [u.cost_per_rank for u in units] or [0.0]
        delta = 0.25 * float(np.median(costs))

    exec_times = np.zeros(hdp)
    speed = np.ones(hdp) if rank_speed is None else np.asarray(rank_speed)
    # (rank, wave) occupancy grid, grown on demand
    waves: List[Wave] = []
    wave_free: List[np.ndarray] = []          # bool per rank

    wave_cmult: List[int] = []

    def ensure_wave(w: int, c_mult: int = 1):
        while len(waves) <= w:
            waves.append(Wave(composition=(), slots=[[] for _ in range(hdp)],
                              costs=[0.0] * hdp, c_mult=c_mult))
            wave_free.append(np.ones(hdp, bool))
            wave_cmult.append(c_mult)

    def place(u: Unit, ranks: List[int], w: int):
        ensure_wave(w, u.c_mult)
        for j, r in enumerate(ranks):
            waves[w].slots[r] = list(u.pieces_per_rank[j])
            waves[w].costs[r] = u.cost_per_rank
            wave_free[w][r] = False
            exec_times[r] += u.cost_per_rank / speed[r]
        waves[w].offload_ratio = max(waves[w].offload_ratio, u.offload_ratio)

    def find_slot(g: int, prefer: np.ndarray,
                  c_mult: int) -> Tuple[List[int], int]:
        """Pick the contiguous width-g rank window with the least
        accumulated (speed-weighted) time — paper lines 8-9's lagging-rank
        targeting — then its first free wave of matching buffer size.
        Ranks run their wave queues asynchronously (plan_stats), so sparse
        waves cost nothing; what matters is per-rank totals.  pp mode
        additionally aligns windows to width-g tiles so every wave keeps
        the one uniform composition ``(g*,) * (hdp // g*)``."""
        step = g if mode == "pp" else 1
        best = None
        for s in range(0, hdp - g + 1, step):
            score = prefer[s:s + g].sum()
            if best is None or score < best[0]:
                best = (score, s)
        s = best[1]
        ranks = list(range(s, s + g))
        w = 0
        while True:
            ensure_wave(w, c_mult)
            if wave_cmult[w] == c_mult and wave_free[w][s:s + g].all():
                return ranks, w
            w += 1

    def next_unit() -> Optional[Unit]:
        # first (longest) non-empty bucket: each wave fills with
        # similar-cost units, keeping it level-uniform.  In pp mode the
        # units are additionally width-uniform, so the leveled waves also
        # share one composition (the stream-homogeneity Insight 1 needs).
        for b in buckets:
            if b:
                return b.pop(0)
        return None

    # Step 2-3 loop: keep topping up the laggards until all units placed
    while True:
        u = next_unit()
        if u is None:
            break
        ranks, w = find_slot(u.ranks, exec_times, u.c_mult)
        place(u, ranks, w)

    if pp_width is not None:
        # uniform stream: every wave carries the same tiled composition;
        # unoccupied tiles are all-padding groups (block skipping turns
        # their ring steps into no-ops), so one executable covers the step.
        # The co-planned offload ratio is wave-uniform too — one
        # (composition, c_mult, offload) key for the whole step.
        for wave in waves:
            wave.composition = (pp_width,) * (hdp // pp_width)
            wave.offload_ratio = max(wave.offload_ratio, pp_offload_r)
        denom = int(sum(lengths))
        plan = StepPlan(waves=waves, denom=denom, capacity=capacity)
        plan.stats = plan_stats(plan)
        plan.stats["mode"] = mode
        plan.stats["delta"] = delta
        plan.stats["pp_width"] = pp_width
        plan.stats["pp_offload_ratio"] = pp_offload_r
        plan.stats["use_offload"] = bool(use_offload and pp_offload_r > 0)
        return plan

    for w, wave in enumerate(waves):
        comp: List[int] = []
        r = 0
        while r < hdp:
            if not wave_free[w][r] and wave.slots[r]:
                # group width = run of ranks sharing the same unit: detect
                # by walking matching costs & pieces ownership
                g = 1
                sid = wave.slots[r][0].seq_id if wave.slots[r] else -1
                while (r + g < hdp and not wave_free[w][r + g]
                       and wave.slots[r + g]
                       and wave.slots[r + g][0].seq_id == sid
                       and len(wave.slots[r + g][0:1]) > 0
                       and wave.costs[r + g] == wave.costs[r]
                       and _same_unit(wave.slots[r], wave.slots[r + g])):
                    g += 1
                comp.extend([g] if g > 1 else [1])
                r += g
            else:
                comp.append(1)
                r += 1
        wave.composition = tuple(comp)

    denom = int(sum(lengths))
    plan = StepPlan(waves=waves, denom=denom, capacity=capacity)
    plan.stats = plan_stats(plan)
    plan.stats["mode"] = mode
    plan.stats["delta"] = delta
    return plan


def _same_unit(slot_a: List[Piece], slot_b: List[Piece]) -> bool:
    """Adjacent ranks belong to one sharded unit iff they hold disjoint
    chunks of the same single sequence.  (Only the dp path reconstructs
    compositions from slots — pp mode assigns its uniform tiling directly
    — and dp's multi-rank units are always single long sequences.)"""
    if len(slot_a) == 0 or len(slot_b) == 0:
        return False
    sids_a = {p.seq_id for p in slot_a}
    sids_b = {p.seq_id for p in slot_b}
    if sids_a != sids_b or len(sids_a) != 1:
        return False
    spans_a = {(p.start, p.end) for p in slot_a}
    spans_b = {(p.start, p.end) for p in slot_b}
    return not (spans_a & spans_b)
