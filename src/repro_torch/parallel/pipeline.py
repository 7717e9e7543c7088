"""Pipeline-parallel execution: PP-Balance plans run over stages × HDP
ranks.

Port of `repro/parallel/pipeline.py`.  The model's stacked layer periods
split into ``S = rt.num_stages`` contiguous windows, one a stage
(`stage_window`; `models/transformer.py::init_params` and
`bridge.params_from_flat` build a stage's window directly), and each HDP
*wave* becomes one pipeline *microbatch*.  Embed, head blocks, final norm
and LM head stay whole on every stage, as the reference keeps them
replicated over its stage axis.

The plan-side functions (`num_scan_periods`, `assert_pipeline_ready`,
`Round`, `round_key`, `pipeline_rounds`, `rounds_splitter`,
`pipeline_schedule_stats`) are copies of the reference's.  The executor
(`pipeline_grad_step`) stands for its ``pipeline_hidden``,
``pipeline_loss_fn`` and ``make_pipeline_grad_step``: each stage is a
process (one per card), and the residual moves between stages by
point-to-point sends over the stage group (``rt.stage_comm``), where the
reference rolls a stage-sharded buffer that XLA lowers to a
CollectivePermute.

Schedule: the reference's lockstep wavefront without its padding.  At
forward tick ``t = 0 … M+S−2`` stage s computes microbatch ``t − s`` when
it exists (stage 0 also runs the embed frontend, the last stage the final
norm and the token-level loss), then every stage joins one
``stage_comm.ppermute`` over the pairs ``(a, a+1)`` whose stage a computed
a microbatch this tick: the ``[C·c_mult, d]`` residual.  The backward runs
the ticks in reverse: ``torch.autograd.grad`` of the microbatch's kept
output against its kept input and the stage's weights, and a ppermute of
the input's gradient over ``(a, a−1)``.  Every rank makes the same
sequence of collectives, so the HDP rings inside a stage and the stage
transfers cannot interleave differently on different ranks.  seg, pos
and labels never travel: every rank materializes the round from the same
plan.  Each stage keeps one microbatch's input residual (and its remat
period inputs) from its forward to its backward for all M microbatches
of the round, the reference's memory shape and the reason
``max_round_waves`` exists.

Every microbatch divides by the step's global ``denom`` (Eq. 1–2), so a
round's loss is the sum of its waves' losses and the pipelined step's
gradients are the non-pipelined step's.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hdp import StepPlan
from repro_torch.core.loss import token_ce_loss
from repro_torch.models import layers as L
from repro_torch.models.transformer import (apply_periods, embed_frontend,
                                            head_layer_count, stage_periods)
from repro_torch.obs import ledger
from repro_torch.parallel.sharding import Runtime
from repro_torch.parallel.zero1 import gather_dim_to_host
from repro_torch.tree import leaves, tree_map

# ---------------------------------------------------------------------------
# stage partitioning
# ---------------------------------------------------------------------------

def num_scan_periods(cfg: ModelConfig) -> int:
    return (cfg.num_layers - head_layer_count(cfg)) // len(cfg.layer_pattern)


def assert_pipeline_ready(cfg: ModelConfig, rt: Runtime) -> None:
    s = rt.num_stages
    if s <= 1:
        raise ValueError("pipeline execution needs a stage axis with "
                         "num_stages > 1 (Runtime.stage_comm)")
    n = num_scan_periods(cfg)
    if n % s != 0:
        raise ValueError(
            f"{cfg.name}: {n} scan periods do not split into {s} equal "
            f"pipeline stages (choose num_stages dividing {n})")


def stage_window(blocks, s: int, num_stages: int):
    """Stacked block params [n_periods, ...] -> stage s's contiguous
    window [n_periods/S, ...] (views): the reference's ``stage_stacked``
    row s."""
    def cut(a):
        w = stage_periods(a.shape[0], (s, num_stages))
        return a[w.start:w.stop]
    return tree_map(cut, blocks)


# ---------------------------------------------------------------------------
# the pipelined round
# ---------------------------------------------------------------------------

def pipeline_grad_step(params, grad_accum, cfg: ModelConfig, rt: Runtime,
                       batches: List[Dict[str, torch.Tensor]], denom,
                       busy: Optional[list] = None):
    """One round of ``M = len(batches)`` like waves through the stages
    (see the module docstring): adds this stage's gradients into the fp32
    ``grad_accum`` in place -> (grad_accum, losses [M] fp32: on the last
    stage this rank's share of each microbatch's loss, zeros elsewhere).

    ``params`` is this stage's tree (its window of ``blocks``);
    ``batches[m]`` this rank's rows of microbatch m ({"tokens", "seg",
    "pos", "labels"}), ``denom`` the step's global token count.  With the
    bytes ledger's capture open, the forward's stage sends count as
    ``pp`` (`obs/ledger.py`); the backward is paused.  ``busy`` (a list)
    receives a span per microbatch's forward and backward: the stage's
    compute between its transfers (`busy_seconds` adds them up).

    The stage transfers and every collective inside a stage are made in
    the same order on every rank."""
    S, s = rt.num_stages, rt.stage_rank
    comm = rt.stage_comm
    M = len(batches)
    first, last = s == 0, s == S - 1
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    weights = leaves(live)
    rows = batches[0]["seg"].shape[0]
    idle = torch.empty((rows, cfg.d_model), dtype=L.activation_dtype(cfg),
                       device=rt.device)      # what a stage with nothing
    store = rt.offload_store                  # to send passes
    kept: List[Optional[Tuple]] = [None] * M
    losses = torch.zeros(M, dtype=torch.float32, device=rt.device)
    recv = idle
    for t in range(M + S - 1):
        m = t - s
        out = idle
        if 0 <= m < M:
            b = batches[m]
            if store is not None:
                store.slot = m
            with _span(busy, rt.device), torch.enable_grad():
                if first:
                    x_in, x = None, embed_frontend(live, cfg, rt, b)
                else:
                    x_in = x = recv.requires_grad_(True)
                y = apply_periods(live["blocks"], cfg, rt, x, b["seg"],
                                  b["pos"])
                if last:
                    h = L.rmsnorm(live["final_norm"], y, cfg.norm_eps)
                    y, _ = token_ce_loss(live, cfg, rt, h, b["labels"],
                                         b["seg"], denom)
                    losses[m] = y.detach()
                else:
                    out = y.detach()
            kept[m] = (x_in, y)
        if out is not idle and ledger.tally_active():
            ledger.record_comm("pp", ledger.tensor_bytes(out))
        (recv,) = comm.ppermute(
            [out], [(a, a + 1) for a in range(S - 1) if 0 <= t - a < M])
    del recv
    grad_in = idle
    with ledger.paused():
        for t in reversed(range(M + S - 1)):
            m = t - s
            out = idle
            if 0 <= m < M:
                x_in, y = kept[m]
                kept[m] = None
                if store is not None:
                    store.slot = m
                inputs = weights if x_in is None else [x_in, *weights]
                with _span(busy, rt.device):
                    gs = torch.autograd.grad(y, inputs,
                                             None if last else grad_in,
                                             allow_unused=True)
                    if x_in is not None:
                        out, gs = gs[0], gs[1:]
                    with torch.no_grad():
                        for acc, g in zip(leaves(grad_accum), gs):
                            if g is not None:
                                acc.add_(g)
                del gs, x_in, y
            (grad_in,) = comm.ppermute(
                [out], [(a, a - 1) for a in range(1, S) if 0 <= t - a < M])
    if store is not None:
        store.slot = 0
    return grad_accum, losses


@contextlib.contextmanager
def _span(busy: Optional[list], device: torch.device):
    """Appends the enclosed compute's span to ``busy`` (None: nothing): a
    pair of CUDA events on the compute stream, or host seconds on the
    CPU."""
    if busy is None:
        yield
        return
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        busy.append((a, b))
        return
    t0 = time.perf_counter()
    yield
    busy.append(time.perf_counter() - t0)


def busy_seconds(busy: list) -> float:
    """The seconds of `pipeline_grad_step`'s ``busy`` spans (waits for
    the card)."""
    return float(sum(x if isinstance(x, float)
                     else x[0].elapsed_time(x[1]) / 1e3 for x in busy))


def stage_gather_to_host(x: np.ndarray, stage_comm) -> Optional[np.ndarray]:
    """Every stage's window ``x`` (a host array, the same shape on every
    stage) -> their concatenation along dim 0 on stage 0 (the global
    stacked leaf), None on the other stages.  Every rank of the stage
    group calls it; the windows move in ZeRO-1's blocks through the
    group's device (`zero1.gather_dim_to_host` on dim 0)."""
    full = (stage_comm.size * x.shape[0],) + tuple(x.shape[1:])
    return gather_dim_to_host(torch.from_numpy(np.ascontiguousarray(x)),
                              full, 0, stage_comm, stage_comm.device)


# ---------------------------------------------------------------------------
# plan -> rounds (the executor's view of a wave queue)
# ---------------------------------------------------------------------------

@dataclass
class Round:
    """A maximal group of like waves: one compiled pipelined schedule."""
    wave_ids: List[int]
    composition: Tuple[int, ...]
    c_mult: int
    offload_ratio: float


def round_key(wave) -> Tuple:
    return (tuple(wave.composition), wave.c_mult,
            round(wave.offload_ratio, 2))


def pipeline_rounds(plan: StepPlan, max_waves: int = 0) -> List[Round]:
    """Group a plan's wave queue by (composition, c_mult, offload) into
    pipelined rounds.  Grouping is global (not merely contiguous): waves
    commute under the token-level loss, so reordering the queue is free,
    and maximal rounds minimize pipeline flushes.  Round order follows
    first appearance, wave order within a round follows the stream.

    ``max_waves > 0`` caps the round length (ROADMAP PP follow-up): a
    round of M waves keeps M microbatches' activations in flight through
    the stage buffer, so very long rounds trade the flush they amortize
    for unbounded activation memory.  Capping splits each group into
    ceil(M / max_waves) chunks — each chunk pays its own S-1 fill/drain
    flush, bounding in-flight activations at ``max_waves`` microbatches.
    """
    order: List[Tuple] = []
    groups: Dict[Tuple, List[int]] = {}
    for i, w in enumerate(plan.waves):
        k = round_key(w)
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(i)
    out = []
    for k in order:
        ids = groups[k]
        w0 = plan.waves[ids[0]]
        chunk = max_waves if max_waves > 0 else len(ids)
        for a in range(0, len(ids), chunk):
            sub = ids[a:a + chunk]
            out.append(Round(wave_ids=sub,
                             composition=tuple(w0.composition),
                             c_mult=w0.c_mult,
                             offload_ratio=max(plan.waves[i].offload_ratio
                                               for i in sub)))
    return out


def rounds_splitter(max_waves: int = 0):
    """``plan -> rounds`` callable with a fixed cap — the ONE round-split
    contract shared by the pipelined executor and materialize-ahead
    (SchedulerService.attach_materializer's ``rounds_fn``): pre-built
    stacked buffers desynchronize silently if the two ever disagree."""
    return lambda plan: pipeline_rounds(plan, max_waves)


def pipeline_schedule_stats(plan: StepPlan, num_stages: int,
                            max_round_waves: int = 0) -> Dict:
    """Analytic lockstep schedule of the pipelined executor.

    Within a round of M waves the wavefront advances one microbatch per
    slot: slot t runs wave t-s on stage s, and the SPMD barrier makes the
    slot cost max over in-flight waves of (wave max-rank cost / S).  Each
    round spans M + S - 1 slots (S-1 fill + S-1 drain).  ``ideal`` is the
    mean per-device busy time (Σ_w mean_r cost / S); the bubble fraction
    folds together within-wave imbalance, cross-wave heterogeneity inside
    a round's window, and per-round flushes — the quantity PP-Balance's
    uniform stream minimizes (paper Insight 1)."""
    S = max(1, num_stages)
    rounds = pipeline_rounds(plan, max_round_waves)
    makespan = 0.0
    peak = 0.0
    for rd in rounds:
        costs = [max(plan.waves[i].costs) for i in rd.wave_ids]
        m = len(costs)
        peak = max(peak, max(costs))
        for t in range(m + S - 1):
            window = costs[max(0, t - S + 1):t + 1]
            makespan += max(window) / S
    hdp = len(plan.waves[0].costs) if plan.waves else 1
    per_rank = np.zeros(hdp)
    for w in plan.waves:
        per_rank += np.asarray(w.costs)
    ideal = float(per_rank.mean()) / S
    return {
        "num_stages": S,
        "n_rounds": len(rounds),
        "round_sizes": [len(rd.wave_ids) for rd in rounds],
        "makespan_pipeline": makespan,
        "ideal_per_device": ideal,
        "bubble_frac_pipeline": 1.0 - ideal / makespan if makespan > 0
        else 0.0,
        "peak_wave_cost": peak,
    }
