"""Differentiable wrappers around the kernels (`torch.autograd.Function`s).

Port of `repro/kernels/ops.py`'s ring-flash and fused cross-entropy
custom VJPs.  Neither differentiates through a kernel: each forward saves
the residuals its backward kernels take, and the backward calls them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import fused_ce as CE
from repro_torch.kernels import ring_flash as RF


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, comm, q, kv, q_seg, k_seg, q_pos, k_pos, kgi):
        out, res = RF.ring_flash_fwd(cfg, q, kv, q_seg, k_seg, q_pos, k_pos,
                                     kgi, comm)
        ctx.cfg, ctx.comm = cfg, comm
        ctx.save_for_backward(*res)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dkv = RF.ring_flash_bwd(ctx.cfg, ctx.saved_tensors, do, ctx.comm)
        return None, None, dq, dkv, None, None, None, None, None


@functools.lru_cache(maxsize=None)
def make_ring_flash(cfg: RF.RingConfig):
    """The differentiable ring-flash call for one static ring
    configuration: ``fn(q [C, hpl, D], kv [C, G, Dk(+Dv)], q_seg, k_seg,
    q_pos, k_pos, kgi, comm=None) -> out [C, hpl, Dv]``.  ``comm`` (the HDP
    ranks, `parallel.comm.HdpComm`) travels beside the hashable config, not
    in the cache key.  The backward runs `ring_flash_bwd` (the reverse ring
    of the flash backward kernels) on the saved (out, lse) residuals."""

    def ring_flash(q, kv, q_seg, k_seg, q_pos, k_pos, kgi, comm=None):
        return _RingFlash.apply(cfg, comm, q, kv, q_seg, k_seg, q_pos, k_pos,
                                kgi)

    return ring_flash


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, plain, logits, labels):
        fwd = CE.fused_ce_fwd_plain if plain else CE.fused_ce_fwd
        if comm is not None:
            labels = (labels - comm.rank * logits.shape[1]).to(torch.int32)
        nll, lse, tgt = fwd(logits, labels)
        if comm is not None:
            got = comm.all_gather(torch.stack([lse, tgt]))   # [tp, 2, T]
            lse = torch.logsumexp(got[:, 0], dim=0)
            nll = lse - got[:, 1].amax(dim=0)
        ctx.plain = plain
        ctx.save_for_backward(logits, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        bwd = CE.fused_ce_bwd_plain if ctx.plain else CE.fused_ce_bwd
        return None, None, bwd(logits, labels, lse,
                               g.float().contiguous()), None


def fused_softmax_xent(logits, labels, comm=None, *, plain=False):
    """logits [T, V], labels [T] int32 -> nll [T] fp32 (differentiable in
    the logits).

    With ``comm`` (the model group) the logits are this rank's vocabulary
    columns [T, V/tp] and the labels global ids: the forward runs on the
    labels shifted by the shard's first column (a label outside the shard
    finds no target, ``tgt = -1e30``), one all-gather of every rank's lse
    and tgt gives the global lse and the owner's tgt, the same nll on
    every rank, and the backward runs from the global lse.  ``plain`` runs
    the kernels' plain versions on any device."""
    return _FusedXent.apply(comm, plain, logits, labels)
