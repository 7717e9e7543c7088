"""Gradient-accumulation steps over HDP waves.

Port of `repro/train/train_step.py` (`loss_fn`, `make_accum_steps`).  A
*wave* is one packed micro-batch; every wave divides its loss by the same
global ``denom`` (total valid tokens of the step, paper Eq. 1–2), so
accumulating grads over heterogeneous waves equals one plain-DP batch.

The reference's steps are pure jitted functions; here ``grad_step`` adds
one wave's gradient into the caller's fp32 accumulator in place and
``apply_step`` updates params and optimiser state in place (see
`optim/adamw.py`), one leaf at a time.  Over several HDP ranks
(``rt.comm``) each rank accumulates the gradients of its own slices, and
``apply_step`` is the ZeRO-1 update (`parallel/zero1.py`): `reduce_grads`
(reduce-scatter over the ranks), then `apply_reduced` (the guarded apply
to this rank's shard of the optimiser state, and the all-gather of the
bf16 parameters).  Where the reference's jit sums the grads across the
mesh, these two are the explicit collectives.

Under pipeline parallelism (``rt.stage_comm``; the rounds' grad step is
`parallel/pipeline.py::pipeline_grad_step`) each stage holds its window
of the stacked blocks and the whole replicated leaves (embed, head
blocks, final norm, LM head), whose gradients are partial: a tied embed
gets its lookup gradient on stage 0 and its logits gradient on the last.
`reduce_grads` first sums them over the stage group, so every stage
applies the same update to them; the norms and the non-finite count add
each stage-owned leaf over the stages and each replicated leaf once
(`obs/numerics.py::grad_sentinels`), so the guard's decision and the
clip factor are the same on all ranks.

Under tensor parallelism (``rt.tp_comm``) each rank holds its slices of
the split leaves (`parallel/sharding.py::tp_splits`) and the whole
replicated ones, whose gradients are already whole on every rank of the
model group (the layers sum them there, `parallel/tensor.py`: the
replicated ``w_kv`` of an unsharded KV layout goes through
`copy_to_model`).  ZeRO-1 shards a split leaf over the HDP group of its
model rank on the dimension the reference's `zero1_spec` picks, its model
dimension taken (`parallel/zero1.py::with_splits`); the norms and the
non-finite count add a split leaf on every model rank and a replicated
one on model rank 0 only, through one more all-reduce over the model
group, so every rank of the grid takes the same guard decision and clip
factor.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.loss import token_ce_loss
from repro_torch.models.transformer import forward_hidden
from repro_torch.obs import ledger
from repro_torch.obs import numerics as NU
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import Runtime, tp_splits
from repro_torch.parallel.zero1 import (reduce_grad, stage_owned,
                                        stage_taken, with_splits, zero1_dim)
from repro_torch.tree import leaves, tree_map


def loss_fn(params, cfg: ModelConfig, rt: Runtime, batch):
    hidden = forward_hidden(params, cfg, rt, batch)
    return token_ce_loss(params, cfg, rt, hidden, batch["labels"],
                         batch["seg"], batch["denom"])


def zeros_accum(params):
    """The fp32 gradient accumulator of a step, zeroed."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def reduce_grads(grad_accum, comm=None, stage_comm=None, splits=None):
    """The step's gradients summed over the HDP ranks ``comm``: per leaf
    this rank's ZeRO-1 shard (a reduce-scatter), or a replicated leaf's
    whole sum (an all-reduce, in place).  With ``stage_comm`` the leaves
    replicated over the stages are first summed over it, in place.
    ``splits``: per leaf its model split dimension (`tp_splits`), which
    ZeRO-1 leaves alone.  At one rank ``grad_accum`` itself."""
    with torch.no_grad():
        if stage_comm is not None:
            for g, owned in zip(leaves(grad_accum),
                                stage_owned(grad_accum)):
                if not owned:
                    stage_comm.all_reduce(g)
        if comm is None or comm.size == 1:
            return grad_accum
        taken = iter(with_splits(stage_taken(
            grad_accum, 1 if stage_comm is None else stage_comm.size),
            splits))
        return tree_map(lambda g: reduce_grad(g, comm, next(taken)),
                        grad_accum)


def apply_reduced(params, opt_state, grads, opt_cfg: adamw.AdamWConfig, *,
                  comm=None, numerics: bool = True, guard: bool = False,
                  stage_comm=None, tp_comm=None, splits=None):
    """The guarded AdamW apply of reduced gradients (`reduce_grads`) ->
    (params, opt_state, om); see `make_accum_steps`.  Every decision comes
    from all-reduced values, so every rank applies or skips alike.
    ``tp_comm``, ``splits``: the model group and each leaf's split
    dimension (`tp_splits`)."""
    with torch.no_grad():
        hdp = 1 if comm is None else comm.size
        stages = 1 if stage_comm is None else stage_comm.size
        first = stage_comm is None or stage_comm.rank == 0
        taken = with_splits(stage_taken(params, stages), splits)
        # a leaf replicated over the model group counts on its rank 0
        mine = [tp_comm is None or tp_comm.rank == 0 or s is not None
                for s in (splits or [None] * len(taken))]
        counted = [(comm is None or comm.rank == 0
                    or zero1_dim(p.shape, hdp, t) is not None)
                   and (owned or first) and own
                   for p, t, owned, own in zip(leaves(params), taken,
                                               stage_owned(params), mine)]
        gnorm, sent = NU.grad_sentinels(grads, comm, counted, stage_comm,
                                        tp_comm)
        om: Dict[str, torch.Tensor] = sent if numerics or guard else {}
        ok = not guard or int(sent["grad_nonfinite"]) == 0
        update_sq: Dict[str, torch.Tensor] = {}
        if ok:
            _, _, opt_om = adamw.apply_updates(
                params, grads, opt_state, opt_cfg, gnorm=gnorm,
                update_sq=update_sq if numerics or guard else None,
                comm=comm, taken=taken, counted=mine)
        else:
            opt_om = {"grad_norm": gnorm,
                      "lr": adamw.schedule_lr(opt_cfg,
                                              opt_state["step"] + 1)}
        om = {**opt_om, **om}
        if numerics or guard:
            om.update(NU.group_norms(params, "pnorm", mine))
            om.update({f"unorm/{k}": (update_sq[k].sqrt() if ok
                                      else torch.zeros_like(gnorm))
                       for k, v in params.items() if leaves(v)})
            om["applied"] = torch.tensor(int(ok))
            if stages > 1:
                _sum_norms(om, stage_comm, ("pnorm/blocks", "unorm/blocks"))
            if tp_comm is not None:
                _sum_norms(om, tp_comm, [k for k in om if k.startswith(
                    ("pnorm/", "unorm/"))])
    return params, opt_state, om


def _sum_norms(om, comm, keys) -> None:
    """The norms ``keys`` of ``om``, each rank's part so far, made the
    norms over the ranks of ``comm``: the stage-owned group's over every
    stage's window, or every group's over the model group's slices."""
    keys = [k for k in keys if k in om]
    vec = torch.stack([om[k].double().square() for k in keys])
    comm.all_reduce(vec)
    for k, v in zip(keys, vec.sqrt().float()):
        om[k] = v


def make_accum_steps(cfg: ModelConfig, rt: Runtime,
                     opt_cfg: adamw.AdamWConfig, *,
                     numerics: bool = True, guard: bool = False):
    """(grad_step, apply_step) for multi-wave gradient accumulation.

    ``grad_step(params, grad_accum, batch, rt_wave)`` runs one wave's
    forward and backward under ``rt_wave`` and adds its grads into
    ``grad_accum``; it returns (grad_accum, {"loss", "nll_sum", "tokens"}).
    Over several ranks ``batch`` is this rank's slice of the wave and the
    loss its share.

    ``apply_step(params, opt_state, grad_accum)`` reduces the grads over
    ``rt.comm``'s ranks (`reduce_grads`), computes the global grad norm
    once, applies AdamW in place and returns (params, opt_state, om).
    ``numerics`` fills om with the sentinels (per-group grad/param/update
    norms, non-finite count).  ``guard`` decides from the grads, BEFORE
    anything is written, whether any element is non-finite; if so params,
    state and the step counter stay unchanged bit for bit and
    ``om["applied"]`` is 0 (the reference's ``where`` select).  A skipped
    apply reports the kept params' norms and zero update norms.  om values
    are device scalars, for one fetch by the caller.
    """
    comm = None if rt is None else rt.comm
    stage_comm = None if rt is None else rt.stage_comm
    tp_comm = None if rt is None else rt.tp_comm

    def grad_step(params, grad_accum, batch, rt_wave: Runtime):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, cfg, rt_wave, batch)
            with ledger.paused():     # the bytes ledger counts the forward
                grads = torch.autograd.grad(loss, leaves(live))
        with torch.no_grad():
            for acc, g in zip(leaves(grad_accum), grads):
                acc.add_(g)
        del grads
        return grad_accum, {"loss": loss.detach(),
                            **{k: v.detach() for k, v in metrics.items()}}

    def apply_step(params, opt_state, grad_accum):
        splits = None if tp_comm is None else tp_splits(
            params, rt.layout(cfg).kv_sharded, rt.tp)
        return apply_reduced(params, opt_state,
                             reduce_grads(grad_accum, comm, stage_comm,
                                          splits),
                             opt_cfg, comm=comm, numerics=numerics,
                             guard=guard, stage_comm=stage_comm,
                             tp_comm=tp_comm, splits=splits)

    return grad_step, apply_step
