"""HDP planning: ByteScale Alg. 1 (naive) — sequences → waves of per-rank
token buffers with ring compositions.

SPMD adaptation (DESIGN.md §2): GPUs let ranks run different micro-batch
counts; XLA runs one program everywhere.  A *wave* is one micro-batch call
in which every rank holds exactly `capacity` tokens; "rank r gets more
micro-batches" becomes "every wave keeps rank r busy".  The plan is
mathematically equivalent (token-level loss, Eq. 1–2) and the makespan
objective is identical: minimize Σ_w max_r time(r, w).

Plans are pure host-side Python (the single-controller scheduler); the
device side only ever sees (buffer arrays, static composition).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import offload as OF
from repro_torch.data.packing import best_fit_decreasing, zigzag_chunks


# ---------------------------------------------------------------------------
# plan types
# ---------------------------------------------------------------------------

@dataclass
class Piece:
    """A contiguous token range of one sequence placed on one rank."""
    seq_id: int
    start: int
    end: int

    @property
    def length(self) -> int:
        return self.end - self.start


@dataclass
class Unit:
    """One schedulable work item: a packed bin (g=1) or a sharded long
    sequence (g ranks, zigzag or contiguous layout)."""
    ranks: int                      # group size g
    cost_per_rank: float            # model FLOPs-time per rank
    pieces_per_rank: List[List[Piece]]   # len == ranks
    offload_ratio: float = 0.0
    seq_ids: Tuple[int, ...] = ()
    c_mult: int = 1                 # per-rank buffer = c_mult × capacity
                                    # (>1 only for offloaded long sequences)


@dataclass
class Wave:
    composition: Tuple[int, ...]
    slots: List[List[Piece]]        # per rank
    costs: List[float]              # per rank cost estimate
    offload_ratio: float = 0.0
    c_mult: int = 1                 # SPMD buffer size multiplier for the wave

    def bubble_fraction(self) -> float:
        mx = max(self.costs)
        return float(1.0 - (sum(self.costs) / (len(self.costs) * mx))) \
            if mx > 0 else 0.0


@dataclass
class StepPlan:
    waves: List[Wave]
    denom: int                      # total valid tokens (token-level loss)
    capacity: int
    stats: Dict = field(default_factory=dict)

    def total_cost(self) -> float:
        return sum(max(w.costs) for w in self.waves)


# ---------------------------------------------------------------------------
# cost model hooks
# ---------------------------------------------------------------------------

def seq_flops_time(length: int, coeffs: OF.CostCoeffs, layers: int = 1) -> float:
    """Per-sequence compute-time estimate (paper T(s), Alg. 2's FLOPs)."""
    return layers * OF.layer_time(coeffs, length)


@dataclass(frozen=True)
class CommModel:
    """Ring dist-attn traffic model: each ring step ships a rank's local KV
    (k+v, or the MLA latent) to its neighbour; backward rings roughly
    triple it (fwd kv + bwd kv + bwd dkv)."""
    kv_bytes_per_token: float = 4096.0
    ici_bw: float = 50e9
    bwd_factor: float = 3.0

    def ring_time(self, group: int, tokens_per_rank: float,
                  layers: int) -> float:
        if group <= 1:
            return 0.0
        return (layers * (group - 1) * tokens_per_rank
                * self.kv_bytes_per_token * self.bwd_factor / self.ici_bw)


def kv_bytes_per_token(cfg) -> float:
    """Per-token ring payload for a config (bf16)."""
    if getattr(cfg, "mla", None) is not None:
        return 2.0 * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim)
    if cfg.attention_free:
        return 0.0            # state relay is O(1), not per-token
    attn_frac = sum(1 for c in cfg.layer_pattern if c in "gl") \
        / len(cfg.layer_pattern)
    return 2.0 * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * attn_frac


def unit_time(compute: float, comm: float) -> float:
    """Per-rank wall time under compute/comm overlap: whichever dominates
    (ByteScale Fig. 18a — comm-bound micro-batches run at ring speed)."""
    return max(compute, comm)


def uniform_cp_width(lengths: Sequence[int], capacity: int, hdp: int) -> int:
    """The smallest CP width that (a) covers the longest sequence at
    `capacity` tokens/rank and (b) divides the HDP axis, so `DP = hdp / cp`
    stays integral (the documented static-baseline geometry) and a
    composition ``(g,) * (hdp // g)`` tiles the axis exactly.  Falls back to
    the full axis when even that is too narrow (per-rank buffers then grow
    via c_mult instead).  Shared by the static baseline's auto CP degree and
    PP-Balance's uniform stream width."""
    need = max(1, -(-max(lengths, default=0) // capacity))
    return snap_width(need, hdp)


def snap_width(g: int, hdp: int) -> int:
    """Round a group width UP to the smallest divisor of the HDP axis ≥ g
    (full axis if none).  Always feasible (more ranks never hurt memory);
    the lookahead scheduler snaps balance widths onto this grid so long
    sequences of different lengths land on a handful of compositions
    instead of one per width — compile-reuse-aware group sizing."""
    for w in range(min(max(g, 1), hdp), hdp + 1):
        if hdp % w == 0:
            return w
    return hdp


# ---------------------------------------------------------------------------
# unit construction (shared by Alg. 1 and Alg. 2)
# ---------------------------------------------------------------------------

def _c_mult(pieces: "List[List[Piece]]", capacity: int) -> int:
    worst = max((sum(p.length for p in slot) for slot in pieces), default=0)
    return max(1, math.ceil(worst / capacity))


def build_units(lengths: Sequence[int], capacity: int, hdp: int,
                coeffs: OF.CostCoeffs, *, num_layers: int,
                use_offload: bool = True, quadratic: bool = True,
                zigzag: bool = True, comm: Optional[CommModel] = None,
                static_cp: Optional[int] = None,
                balance_d: bool = False,
                snap_widths: bool = False) -> List[Unit]:
    """``static_cp``: force every unit onto `static_cp` ranks — the
    paper's baseline (fixed CP degree sized for the longest sequence).

    ``balance_d``: pick each long sequence's group size between Eq. 3's
    floor (min ranks, max offload) and ceil(len/C) so that its per-rank
    compute stays near the batch-average load — the balance scheduler's
    view of C2+C3 together; Alg. 1 (naive) keeps the Eq. 3 minimum and
    exhibits the Fig. 18(b) imbalance.

    ``snap_widths``: round long-sequence group sizes UP onto the divisor
    grid of the HDP axis (`snap_width`) — compile-reuse-aware sizing for
    the lookahead scheduler: a few canonical widths instead of one per
    length, at the cost of slightly more ranks per long sequence."""
    total_t = sum(seq_flops_time(ln, coeffs, num_layers) for ln in lengths)
    target = total_t / max(hdp, 1)
    units: List[Unit] = []
    pack_ids, pack_lens = [], []
    for sid, ln in enumerate(lengths):
        g_forced = static_cp
        if g_forced is None and ln <= capacity:
            pack_ids.append(sid)
            pack_lens.append(ln)
            continue
        if g_forced is not None:
            g, r = g_forced, 0.0
            if ln <= capacity * g_forced:
                pack_ids.append(sid)
                pack_lens.append(ln)
                continue
        elif use_offload and not balance_d:
            r, g = OF.solve_eq3(coeffs, ln, capacity, num_layers,
                                quadratic=quadratic)
        elif balance_d:
            g_nat = math.ceil(ln / capacity)
            if use_offload:
                _, g_min = OF.solve_eq3(coeffs, ln, capacity, num_layers,
                                        quadratic=quadratic)
            else:
                g_min = g_nat
            t_seq = seq_flops_time(ln, coeffs, num_layers)
            g_bal = math.ceil(t_seq / max(target, 1e-12))
            g = min(g_nat, max(g_min, g_bal), hdp)
            r = 0.0
            if g < g_nat and use_offload:
                r_need = OF.ratio_for_d(coeffs, ln, capacity, num_layers, g,
                                        quadratic=quadratic)
                while r_need is None and g < min(g_nat, hdp):
                    g += 1
                    r_need = OF.ratio_for_d(coeffs, ln, capacity, num_layers,
                                            g, quadratic=quadratic)
                r = r_need or 0.0
        else:
            r, g = 0.0, math.ceil(ln / capacity)
        g = min(max(g, 1), hdp)
        if snap_widths and g_forced is None:
            g_snap = snap_width(g, hdp)
            if g_snap != g:
                g = g_snap
                # more ranks than Eq. 3 asked for: the offload ratio the
                # narrower width needed is wasted transfer at this one —
                # recompute the minimum for the snapped width
                r = (OF.ratio_for_d(coeffs, ln, capacity, num_layers, g,
                                    quadratic=quadratic) or 0.0) \
                    if (use_offload and r > 0) else 0.0
        pieces: List[List[Piece]] = [[] for _ in range(g)]
        if zigzag and quadratic:
            for j, lo, hi in zigzag_chunks(ln, g):
                pieces[j].append(Piece(sid, lo[0], lo[1]))
                pieces[j].append(Piece(sid, hi[0], hi[1]))
        else:                        # contiguous (SSM state relay)
            per = math.ceil(ln / g)
            for j in range(g):
                s, e = j * per, min((j + 1) * per, ln)
                if s < e:
                    pieces[j].append(Piece(sid, s, e))
        cost = seq_flops_time(ln, coeffs, num_layers) / g
        if comm is not None:
            cost = unit_time(cost, comm.ring_time(g, ln / g, num_layers))
        units.append(Unit(ranks=g, cost_per_rank=cost,
                          pieces_per_rank=pieces, offload_ratio=r,
                          seq_ids=(sid,), c_mult=_c_mult(pieces, capacity)))

    # short sequences: pack to capacity (Alg. 1 lines 7-9).  Sharded bins
    # (static_cp > 1) pack by the zigzag *footprint* 2g·ceil(len/2g), not
    # the raw length: every rank receives 2 ceil-rounded chunks per
    # sequence, and packing raw lengths to the full g·capacity could push
    # a rank a few tokens over capacity, silently doubling the wave's
    # buffer (c_mult = 2) for nothing.
    cap = capacity * (static_cp or 1)
    if pack_ids:
        g_pack = static_cp or 1
        if g_pack > 1:
            eff = [2 * g_pack * -(-ln // (2 * g_pack)) for ln in pack_lens]
        else:
            eff = pack_lens
        bins = best_fit_decreasing(eff, cap, ids=pack_ids)
        real_len = dict(zip(pack_ids, pack_lens))
        bins = [[(sid, real_len[sid]) for sid, _ in b] for b in bins]
        for b in bins:
            g = static_cp or 1
            pieces = [[] for _ in range(g)]
            if g == 1:
                pieces[0] = [Piece(sid, 0, ln) for sid, ln in b]
            else:                   # baseline: packed bin sharded over CP
                for sid, ln in b:
                    for j, lo, hi in zigzag_chunks(ln, g):
                        pieces[j].append(Piece(sid, lo[0], lo[1]))
                        pieces[j].append(Piece(sid, hi[0], hi[1]))
            cost = sum(seq_flops_time(ln, coeffs, num_layers) for _, ln in b) / g
            if comm is not None:
                tok = sum(ln for _, ln in b)
                cost = unit_time(cost, comm.ring_time(g, tok / g, num_layers))
            units.append(Unit(ranks=g, cost_per_rank=cost,
                              pieces_per_rank=pieces,
                              seq_ids=tuple(sid for sid, _ in b),
                              c_mult=_c_mult(pieces, capacity)))
    return units


# ---------------------------------------------------------------------------
# Alg. 1: naive HDP (first-fit waves, no balancing)
# ---------------------------------------------------------------------------

def waves_first_fit(units: List[Unit], hdp: int) -> List[Wave]:
    """Place units into waves in arrival order (naive): each wave is a
    contiguous rank allocator; a unit opens a new wave when it doesn't fit.
    Waves are homogeneous in buffer size (c_mult): offloaded long sequences
    (bigger per-rank buffers) get their own waves — one SPMD shape each."""
    waves: List[Wave] = []
    cursors: List[int] = []         # next free rank per wave
    comp_builder: List[List[int]] = []

    def new_wave(c_mult: int) -> int:
        waves.append(Wave(composition=(), slots=[[] for _ in range(hdp)],
                          costs=[0.0] * hdp, c_mult=c_mult))
        cursors.append(0)
        comp_builder.append([])
        return len(waves) - 1

    def place(w: int, u: Unit):
        start = cursors[w]
        for j in range(u.ranks):
            waves[w].slots[start + j] = list(u.pieces_per_rank[j])
            waves[w].costs[start + j] = u.cost_per_rank
        cursors[w] += u.ranks
        comp_builder[w].append(u.ranks)
        waves[w].offload_ratio = max(waves[w].offload_ratio, u.offload_ratio)

    for u in units:
        placed = False
        for w in range(len(waves)):
            if waves[w].c_mult == u.c_mult and cursors[w] + u.ranks <= hdp:
                place(w, u)
                placed = True
                break
        if not placed:
            place(new_wave(u.c_mult), u)
    # pad compositions with singleton (idle/pad) ranks
    for w, wave in enumerate(waves):
        comp = comp_builder[w] + [1] * (hdp - cursors[w])
        wave.composition = tuple(comp)
    return waves


def naive_hdp_plan(lengths: Sequence[int], *, capacity: int, hdp: int,
                   coeffs: OF.CostCoeffs, num_layers: int,
                   use_offload: bool = True, quadratic: bool = True,
                   zigzag: bool = True, balance_d: bool = False,
                   comm: Optional[CommModel] = None) -> StepPlan:
    """ByteScale Alg. 1."""
    units = build_units(lengths, capacity, hdp, coeffs,
                        num_layers=num_layers, use_offload=use_offload,
                        quadratic=quadratic, zigzag=zigzag, comm=comm,
                        balance_d=balance_d)
    waves = waves_first_fit(units, hdp)
    denom = int(sum(lengths))
    plan = StepPlan(waves=waves, denom=denom, capacity=capacity)
    plan.stats = plan_stats(plan)
    return plan


def static_cp_plan(lengths: Sequence[int], *, capacity: int, hdp: int,
                   coeffs: OF.CostCoeffs, num_layers: int, cp_degree: int,
                   quadratic: bool = True, zigzag: bool = True,
                   comm: Optional[CommModel] = None) -> StepPlan:
    """The paper's baseline: every (packed) buffer sharded over a fixed CP
    degree sized for the longest sequence; DP = hdp / cp."""
    units = build_units(lengths, capacity, hdp, coeffs,
                        num_layers=num_layers, use_offload=False,
                        quadratic=quadratic, zigzag=zigzag,
                        static_cp=cp_degree, comm=comm)
    waves = waves_first_fit(units, hdp)
    denom = int(sum(lengths))
    plan = StepPlan(waves=waves, denom=denom, capacity=capacity)
    plan.stats = plan_stats(plan)
    return plan


def plan_stats(plan: StepPlan) -> Dict:
    """Async-dispatch model: devices run their own wave queues; ring
    collectives couple only group members; the global barrier is the
    gradient sync (paper §6.1).  Per-rank time = Σ_w cost[r, w];
    makespan(DP) = max_r; the wave-lockstep makespan (Σ_w max_r) is the
    PP-relevant pessimistic bound."""
    import numpy as _np
    hdp = len(plan.waves[0].costs) if plan.waves else 1
    per_rank = _np.zeros(hdp)
    for w in plan.waves:
        per_rank += _np.asarray(w.costs)
    makespan = float(per_rank.max()) if plan.waves else 0.0
    work = float(per_rank.mean()) if plan.waves else 0.0
    lockstep = sum(max(w.costs) for w in plan.waves)
    return {
        "n_waves": len(plan.waves),
        "makespan": makespan,
        "makespan_lockstep": lockstep,
        "ideal": work,
        "bubble_frac": 1.0 - work / makespan if makespan > 0 else 0.0,
        "bubble_frac_lockstep": 1.0 - work / lockstep if lockstep > 0 else 0.0,
        "per_rank_times": per_rank.tolist(),
        "compositions": [tuple(sorted(set(w.composition))) for w in plan.waves],
    }


def validate_plan(plan: StepPlan, lengths: Sequence[int]) -> None:
    """Invariants: every token placed exactly once; capacity respected."""
    seen = {sid: np.zeros(ln, dtype=np.int32)
            for sid, ln in enumerate(lengths)}
    for w in plan.waves:
        for slot in w.slots:
            tok = sum(p.length for p in slot)
            assert tok <= plan.capacity * w.c_mult, \
                (tok, plan.capacity, w.c_mult)
            for p in slot:
                seen[p.seq_id][p.start:p.end] += 1
    for sid, marks in seen.items():
        assert (marks == 1).all(), f"seq {sid}: tokens covered {set(marks.tolist())}"
