"""Dense PyTorch oracles for the kernels (tests only)."""
from __future__ import annotations

import torch

from repro_torch.core.attention import attention_dense_oracle


def flash_attention_ref(q, k, v, q_seg, k_seg, q_pos, k_pos, *, scale,
                        causal=True, window=0, softcap=0.0):
    """q [G, Hg, T, Dk], k/v [G, S, D*] -> out [G, Hg, T, Dv] (kernel layout).
    Delegates to the core dense oracle in its [T, G, Hg, D] layout."""
    out = attention_dense_oracle(
        q.permute(2, 0, 1, 3), k.permute(1, 0, 2), v.permute(1, 0, 2),
        q_seg, k_seg, q_pos, k_pos, scale=scale, causal=causal,
        window=window, softcap=softcap)
    return out.permute(1, 2, 0, 3)


def fused_ce_ref(logits, labels):
    """-> (nll [T], lse [T]) in fp32."""
    lg = logits.float()
    m = lg.amax(dim=-1)
    lse = m + torch.log(torch.exp(lg - m[:, None]).sum(dim=-1))
    tgt = lg.gather(-1, labels.long()[:, None])[:, 0]
    return lse - tgt, lse


def fused_ce_grad_ref(logits, labels, g):
    """dlogits for loss = sum(nll * g)."""
    lg = logits.float()
    p = torch.softmax(lg, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(),
                                         lg.shape[-1]).float()
    return ((p - onehot) * g[:, None]).to(logits.dtype)
