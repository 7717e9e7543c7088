"""Segment-aware blockwise attention: the plain PyTorch oracle.

Port of `repro/core/attention.py`.  Everything operates on packed token
buffers: each token carries a ``segment_id`` (0 = padding) and an absolute
``position`` within its own sequence, and the mask is derived from those
alone (segment equality, causality, sliding window), with optional
Gemma-style soft-capping of the scores.

Canonical shapes (G = kv groups, Hg = q heads per group):
    q   [T, G, Hg, Dk]
    k   [S, G, Dk]
    v   [S, G, Dv]
online-softmax stats:
    acc [T, G, Hg, Dv]   (unnormalized numerator, fp32)
    m   [T, G, Hg]       (running max, fp32)
    l   [T, G, Hg]       (running denominator, fp32)

This backs ``attn_impl="ref"`` and is the oracle the flash kernel's tests
hold it to.  Masked scores use the finite sentinel ``NEG_INF`` and masked
probabilities are zeroed after the exponential, so fully masked rows keep
``m = NEG_INF, l = 0`` and never produce NaN.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1.0e30


def attention_mask(q_seg, k_seg, q_pos, k_pos, *, causal: bool = True,
                   window: int = 0) -> torch.Tensor:
    """[T, S] boolean mask. segment 0 is padding and never attends/attended."""
    mask = ((q_seg[:, None] == k_seg[None, :])
            & (q_seg[:, None] > 0) & (k_seg[None, :] > 0))
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def block_attention_stats(q, k, v, q_seg, k_seg, q_pos, k_pos, *,
                          scale: float, causal: bool = True, window: int = 0,
                          softcap: float = 0.0):
    """Attention stats of one q block against one kv block (no chunking)."""
    s = torch.einsum("tghd,sgd->gtsh", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(q_seg, k_seg, q_pos, k_pos, causal=causal,
                          window=window)[None, :, :, None]   # [1,T,S,1]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=2)                                        # [G,T,Hg]
    p = torch.exp(s - m[:, :, None, :])
    p = torch.where(mask, p, 0.0)                            # kill exp(0)=1 rows
    l = p.sum(dim=2)                                         # [G,T,Hg]
    acc = torch.einsum("gtsh,sgd->gthd", p, v.float())       # [G,T,Hg,Dv]
    return (acc.permute(1, 0, 2, 3), m.permute(1, 0, 2), l.permute(1, 0, 2))


def merge_stats(a: Tuple, b: Tuple) -> Tuple:
    """Combine two online-softmax partial results."""
    acc_a, m_a, l_a = a
    acc_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m)
    wb = torch.exp(m_b - m)
    acc = acc_a * wa[..., None] + acc_b * wb[..., None]
    l = l_a * wa + l_b * wb
    return acc, m, l


def zero_stats(t: int, g: int, hg: int, dv: int, device=None):
    return (torch.zeros((t, g, hg, dv), dtype=torch.float32, device=device),
            torch.full((t, g, hg), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((t, g, hg), dtype=torch.float32, device=device))


def finalize_stats(acc, m, l, dtype) -> torch.Tensor:
    """Normalize; fully-masked rows (padding) return zeros."""
    del m
    live = l > 0.0
    safe_l = torch.where(live, l, 1.0)
    out = torch.where(live[..., None], acc / safe_l[..., None], 0.0)
    return out.to(dtype)


def block_chunked_stats(q, k, v, q_seg, k_seg, q_pos, k_pos, *, scale: float,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, kv_chunk: int = 1024):
    """Online-softmax stats of q against one KV block, chunking the block's
    sequence dim so the score tensor stays [G, T, kv_chunk, Hg]."""
    t, g, hg, _ = q.shape
    s_len = k.shape[0]
    kv_chunk = min(kv_chunk, s_len)
    if s_len % kv_chunk != 0 or s_len == kv_chunk:
        return block_attention_stats(
            q, k, v, q_seg, k_seg, q_pos, k_pos, scale=scale, causal=causal,
            window=window, softcap=softcap)
    stats = zero_stats(t, g, hg, v.shape[-1], q.device)
    for a in range(0, s_len, kv_chunk):
        b = a + kv_chunk
        part = block_attention_stats(
            q, k[a:b], v[a:b], q_seg, k_seg[a:b], q_pos, k_pos[a:b],
            scale=scale, causal=causal, window=window, softcap=softcap)
        stats = merge_stats(stats, part)
    return stats


def attention_dense_oracle(q, k, v, q_seg, k_seg, q_pos, k_pos, *, scale,
                           causal=True, window=0, softcap=0.0):
    """Dense softmax with -inf masking (tests only — materializes [T, S])."""
    s = torch.einsum("tghd,sgd->gtsh", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(q_seg, k_seg, q_pos, k_pos, causal=causal,
                          window=window)[None, :, :, None]
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=2)
    p = torch.nan_to_num(p, nan=0.0)                         # fully masked rows
    out = torch.einsum("gtsh,sgd->tghd", p, v.float())
    return out.to(q.dtype)
