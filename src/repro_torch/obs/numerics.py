"""Numerics sentinels and the plan fingerprint.

Port of part of `repro/obs/numerics.py`: the health sentinels fused into
the optimizer apply (per-group grad/param/update norms and a non-finite
element count, as torch scalars on the device — the trainer fetches the
whole summary at once; over several HDP ranks the gradient sentinels are
summed from ZeRO-1 shards by one all-reduce) and `plan_fingerprint`, a
copy.  The online `NumericsMonitor`, `StepProvenance` and the replay
helpers come with the rest of `obs` (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.optim.adamw import global_norm, sq_norm
from repro_torch.tree import leaves


# ---------------------------------------------------------------------------
# sentinels
# ---------------------------------------------------------------------------

def group_norms(tree, prefix: str,
                counted: Optional[Sequence[bool]] = None) -> Dict[str, Any]:
    """Per-top-level-group global norms (embed / blocks / head_blocks /
    final_norm / lm_head); leafless groups have no norm.  ``counted`` (per
    leaf, default all): the leaves the norms add, the others count 0."""
    if counted is not None:
        it = iter(counted)
        tree = {k: [x if next(it) else torch.zeros_like(x[..., :0])
                    for x in leaves(v)] for k, v in tree.items()}
    if not isinstance(tree, dict):
        return {prefix: global_norm(tree)}
    return {f"{prefix}/{k}": global_norm(v) for k, v in tree.items()
            if leaves(v)}


def grad_sentinels(grads, comm=None,
                   counted: Optional[Sequence[bool]] = None,
                   stage_comm=None, tp_comm=None):
    """-> (global grad norm, {"gnorm/<group>": norm, "grad_nonfinite":
    count}) of a step's gradients, as device scalars.

    Over several ranks (``comm``) ``grads`` holds this rank's ZeRO-1
    shards: ``counted[i]`` says whether leaf i's Σg² and non-finite count
    are this rank's to add (a replicated leaf, whole on every rank, is
    counted on rank 0 only).  The partial sums go through one
    ``all_reduce``, so every rank sees the same numbers and takes the same
    guard decision.  Under pipeline parallelism a second ``all_reduce``
    over ``stage_comm`` adds the stages' sums; the caller then counts a
    stage-owned leaf on every stage and a replicated one on stage 0 only,
    so each is added once over the world.  Under tensor parallelism a
    third ``all_reduce`` over ``tp_comm`` adds the model group's sums (a
    split leaf counted on every model rank, a replicated one on one)."""
    ls = leaves(grads)
    if counted is None:
        counted = [True] * len(ls)
    zero = torch.zeros((), dtype=torch.float32, device=ls[0].device)
    sq = torch.stack([sq_norm(x) if c else zero
                      for x, c in zip(ls, counted)])
    bad = [torch.isfinite(x).logical_not_().sum()
           for x, c in zip(ls, counted) if c and x.is_floating_point()]
    bad = torch.stack(bad).sum() if bad \
        else torch.zeros((), dtype=torch.int64, device=zero.device)
    comms = [c for c in (comm, stage_comm, tp_comm)
             if c is not None and c.size > 1]
    if comms:
        vec = torch.cat([sq.double(), bad.double()[None]])
        for c in comms:
            c.all_reduce(vec)
        sq, bad = vec[:-1].float(), vec[-1].long()
    out: Dict[str, Any] = {}
    groups = grads.items() if isinstance(grads, dict) else [(None, grads)]
    start = 0
    for key, sub in groups:
        n = len(leaves(sub))
        if n:
            name = "gnorm" if key is None else f"gnorm/{key}"
            out[name] = sq[start:start + n].sum().sqrt()
        start += n
    out["grad_nonfinite"] = bad
    return sq.sum().sqrt(), out


# ---------------------------------------------------------------------------
# plan fingerprint
# ---------------------------------------------------------------------------

def plan_fingerprint(plan) -> str:
    """sha256 over the executable content of a StepPlan: capacity, denom
    and per wave (composition, c_mult, offload_ratio, per-rank slot
    pieces).  Everything that determines the dispatched batches and jit
    keys; nothing advisory (stats / cost estimates are excluded)."""
    doc = {
        "capacity": int(plan.capacity),
        "denom": int(plan.denom),
        "waves": [
            {
                "comp": [int(g) for g in w.composition],
                "c_mult": int(w.c_mult),
                "off": float(w.offload_ratio),
                "slots": [[[int(p.seq_id), int(p.start), int(p.end)]
                           for p in rank] for rank in w.slots],
            }
            for w in plan.waves
        ],
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def fingerprints_by_rank(gather, plan, device) -> list:
    """Every rank's plan fingerprint prefix (15 hex digits), in rank
    order; ``gather`` maps this rank's tensor to [ranks, ...] (a comm's
    ``all_gather``, or the Trainer's gather over the whole PP world), and
    every rank it spans calls it with its own plan.  Ranks that run
    different plans would wait in different collectives, so the callers
    raise on every rank when these differ."""
    mine = int(plan_fingerprint(plan)[:15], 16)
    got = gather(torch.tensor([mine], dtype=torch.int64,
                              device=device)).flatten()
    return [f"{x:015x}" for x in got.tolist()]
