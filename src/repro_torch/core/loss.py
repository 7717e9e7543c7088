"""Token-level cross-entropy (ByteScale §5.1 + §7).

Port of `repro/core/loss.py`.  Token-level loss: every token in the
*global batch* contributes 1/denom, where denom = total valid tokens across
all waves of the step.  This is what makes HDP's heterogeneous gradient
accumulation equivalent to plain DP (paper Eq. 1–2): the trainer passes the
same global ``denom`` into every wave's loss.

The plain path computes the log-sum-exp in fp32 over the logits; with
``rt.attn_impl == "flash"`` (the reference keys it on ``"pallas"``) the
fused cross-entropy kernels (`kernels/fused_ce.py`, behind
`kernels/ops.fused_softmax_xent`) compute it and its gradient instead.

Under tensor parallelism each model rank holds its vocabulary columns of
the logits (the reference's vocab-sharded logits, whose log-sum-exp XLA
reduces across the model axis), and the fused CE, given the model group,
combines the ranks' lse and target logits (`kernels/ops.fused_softmax_xent`);
``impl="ref"`` runs it with the kernels' plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import logits_head
from repro_torch.parallel.sharding import Runtime


def token_ce_from_logits(logits, labels, valid, denom, *, impl: str = "ref",
                         tp_comm=None):
    """logits [T, V] (any float dtype), labels [T] int32, valid [T] bool.
    With ``tp_comm`` the logits are this model rank's columns [T, V/tp]
    (`kernels/ops.fused_softmax_xent` over the model group).

    Returns (loss, metrics).  loss = Σ_valid nll / denom.
    """
    if impl == "flash" or tp_comm is not None:
        from repro_torch.kernels import ops as kernel_ops
        nll = kernel_ops.fused_softmax_xent(logits, labels, tp_comm,
                                            plain=impl != "flash")
    else:
        lg = logits.float()
        m = lg.amax(dim=-1, keepdim=True)
        lse = m + torch.log(torch.exp(lg - m).sum(dim=-1, keepdim=True))
        tgt = lg.gather(-1, labels.long()[:, None])
        nll = (lse - tgt)[:, 0]
    nll = torch.where(valid, nll, 0.0)
    nll_sum = nll.sum()
    n_tok = valid.float().sum()
    return nll_sum / denom, {"nll_sum": nll_sum, "tokens": n_tok}


def token_ce_loss(params, cfg: ModelConfig, rt: Runtime, hidden, labels, seg,
                  denom):
    logits = logits_head(params, cfg, hidden, rt.tp_comm)
    return token_ce_from_logits(logits, labels, seg > 0, denom,
                                impl="flash" if rt.attn_impl == "flash"
                                else "ref", tp_comm=rt.tp_comm)
