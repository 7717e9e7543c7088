"""AdamW with fp32 master weights, global-norm clipping and LR schedules.

Port of `repro/optim/adamw.py`.  The state (step, fp32 master, m, v)
mirrors the parameter tree.  Unlike the reference's pure function,
`apply_updates` updates params and state IN PLACE, one leaf at a time and
in chunks of each leaf, so the step never holds a second copy of the
optimiser state (38.6 GB for llama3.2-3b) and its temporaries stay a few
hundred MB.  Scalars (lr, bias corrections, clip scale) are float32
tensors computed as the reference computes them.

Over several HDP ranks the state is sharded by ZeRO-1
(`parallel/zero1.py`): a leaf `zero1_dim` shards keeps only this rank's
shard of master, m and v, its gradient arrives as this rank's shard of the
reduced sum, and the updated bf16 shard is all-gathered into the full
parameter; a replicated leaf is updated whole on every rank.  Under
pipeline parallelism ``taken`` (`parallel/zero1.py::stage_taken`) keeps
ZeRO-1 off a stage-owned leaf's dim 0, as the reference's stage spec does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.parallel.zero1 import gather_leaf, shard, zero1_dim
from repro_torch.tree import leaves, tree_map

_CHUNK = 1 << 24      # elements per in-place update chunk (64 MB in fp32)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"          # cosine | linear | constant


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
            * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = torch.ones_like(step)
    return cfg.lr * warm * decay


def init_state(params, comm=None, taken=None) -> dict:
    """{"step": int32 0, "master": fp32 copy of params, "m", "v": fp32
    zeros}, on the params' device.  With ``comm`` (the HDP ranks) a leaf
    that `zero1_dim` shards holds only this rank's shard (contiguous) of
    master, m and v; ``taken``: per leaf, the dimensions it skips."""
    first = leaves(params)[0]
    hdp, rank = (1, 0) if comm is None else (comm.size, comm.rank)
    taken = iter(taken if taken is not None
                 else [()] * len(leaves(params)))

    def master(p):
        dim = zero1_dim(p.shape, hdp, next(taken))
        x = p if dim is None else shard(p, dim, rank, hdp)
        return x.detach().to(torch.float32, copy=True).contiguous()

    state_master = tree_map(master, params)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "master": state_master,
        "m": tree_map(torch.zeros_like, state_master),
        "v": tree_map(torch.zeros_like, state_master),
    }


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in fp32 without an fp32 copy of ``x``."""
    return torch.linalg.vector_norm(x, dtype=torch.float32).square()


def global_norm(tree) -> torch.Tensor:
    return torch.stack([sq_norm(x) for x in leaves(tree)]).sum().sqrt()


def _chunks(x: torch.Tensor):
    return torch.split(x.view(-1), _CHUNK)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, gnorm=None, *,
                  update_sq: Optional[Dict[str, torch.Tensor]] = None,
                  comm=None, taken=None, counted=None):
    """One AdamW step, in place: params, state["master"/"m"/"v"] are
    updated where they lie and state["step"] is replaced.  Returns (params,
    state, {"grad_norm", "lr"}).  ``gnorm`` lets a caller that already
    reduced the global grad norm pass it in (with ``comm`` it must).
    ``update_sq``, when given, is filled with Σ (new - old)² of the params
    per top-level group (the sentinels' update norms, which an in-place
    update cannot recompute afterwards).  ``grads`` may be the caller's
    fp32 accumulator: it is read, never written.  With ``comm`` (state
    from ``init_state(params, comm)``) a sharded leaf's gradient is this
    rank's shard of the reduced sum and its new bf16 values are
    all-gathered into the parameter; ``taken`` as in `init_state`.
    ``counted`` (per leaf, default all): the leaves ``update_sq`` adds (a
    leaf replicated over a model group counts on one of its ranks)."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0) \
        if cfg.grad_clip else torch.ones_like(gnorm)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bias1 = 1 - torch.full_like(stepf, b1) ** stepf
    bias2 = 1 - torch.full_like(stepf, b2) ** stepf
    hdp = 1 if comm is None else comm.size
    taken = iter(taken if taken is not None
                 else [()] * len(leaves(params)))
    counted = iter(counted if counted is not None
                   else [True] * len(leaves(params)))

    def update(g, m, v, master, p, du: bool):
        """Writes the new params into ``p``; returns Σ (new p - old p)² of
        this chunk in fp32 if ``du``."""
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        delta = (m / bias1) / (torch.sqrt(v / bias2) + cfg.eps) \
            + cfg.weight_decay * master
        master.sub_(lr * delta)
        new = master.to(p.dtype)
        sq = sq_norm(new.to(torch.float32) - p.to(torch.float32)) \
            if du else None
        p.copy_(new)
        return sq

    groups = params.items() if isinstance(params, dict) \
        else [(None, params)]
    for key, sub in groups:
        sel = (lambda t: t[key]) if key is not None else (lambda t: t)
        acc = []
        for tensors in zip(leaves(sub), leaves(sel(grads)),
                           leaves(sel(state["m"])), leaves(sel(state["v"])),
                           leaves(sel(state["master"]))):
            p, g, m, v, master = tensors
            dim = zero1_dim(p.shape, hdp, next(taken))
            sq = update_sq is not None and next(counted)
            out = p if dim is None else torch.empty(
                master.shape, dtype=p.dtype, device=p.device)
            for pc, gc, mc, vc, wc in zip(*(_chunks(x) for x in
                                            (out, g, m, v, master))):
                du = update(gc, mc, vc, wc, pc, sq and dim is None)
                if du is not None:
                    acc.append(du)
            if dim is not None:
                du = gather_leaf(p, out, dim, comm, sq=sq)
                if du is not None:
                    acc.append(du)
        if update_sq is not None and leaves(sub):
            update_sq[key] = torch.stack(acc).sum() if acc \
                else torch.zeros((), dtype=torch.float32, device=gnorm.device)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
