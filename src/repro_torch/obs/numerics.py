"""Numerics sentinels and the plan fingerprint.

Port of part of `repro/obs/numerics.py`: the health sentinels fused into
the optimizer apply (per-group grad/param/update norms and a non-finite
element count, as torch scalars on the device — the trainer fetches the
whole summary at once) and `plan_fingerprint`, a copy.  The online
`NumericsMonitor`, `StepProvenance` and the replay helpers come with the
rest of `obs` (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict

import torch

from repro_torch.optim.adamw import global_norm
from repro_torch.tree import leaves, tree_map


# ---------------------------------------------------------------------------
# sentinels
# ---------------------------------------------------------------------------

def count_nonfinite(tree) -> torch.Tensor:
    """Total non-finite elements across every floating leaf (int64
    scalar)."""
    counts = [torch.isfinite(x).logical_not_().sum() for x in leaves(tree)
              if x.is_floating_point()]
    return torch.stack(counts).sum() if counts \
        else torch.zeros((), dtype=torch.int64)


def group_norms(tree, prefix: str) -> Dict[str, Any]:
    """Per-top-level-group global norms (embed / blocks / head_blocks /
    final_norm / lm_head); leafless groups have no norm."""
    if not isinstance(tree, dict):
        return {prefix: global_norm(tree)}
    return {f"{prefix}/{k}": global_norm(v) for k, v in tree.items()
            if leaves(v)}


def sentinel_summary(grads, params=None, new_params=None) -> Dict[str, Any]:
    """Per-group grad norms + non-finite count, and — when the applied
    params are supplied — per-group param and update norms."""
    out: Dict[str, Any] = {}
    out.update(group_norms(grads, "gnorm"))
    out["grad_nonfinite"] = count_nonfinite(grads)
    if new_params is not None:
        out.update(group_norms(new_params, "pnorm"))
        if params is not None:
            diff = tree_map(lambda n, o: n.float() - o.float(), new_params,
                            params)
            out.update(group_norms(diff, "unorm"))
    return out


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
