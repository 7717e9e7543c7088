"""HDP dist-attention on one device: singleton compositions and decode.

Port of `repro/core/ring.py` for the serving slice.  A composition
``(1, ..., 1)`` means every rank attends locally with zero collective
traffic; on one device the composition is ``(1,)``.  Rings over groups
larger than one come with the ``torch.distributed`` slice and raise
`NotImplementedError` here.

`_block_meta` and `_block_relevant` are copies of the reference's ring
block predicate (can any query of one block see any key of another, from
their segment and position ranges); the flash kernels apply the same rule
per 64-row tile (`kernels/csrc/flash_tiles.cuh`), and `tile_liveness`
states it per tile in Python.

``attn_impl`` selects the compute backend: ``"ref"`` runs the plain
oracle (`core/attention.py`'s chunked stats, differentiated by autograd);
``"flash"`` runs the ring-flash engine (`kernels/ring_flash.py` behind
`kernels/ops.make_ring_flash`), whose carry kernel is the CUDA flash
kernel on a CUDA device and its plain version on the CPU, and whose
gradient runs the flash backward kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import attention as att

ATTN_IMPLS = ("ref", "flash")


def _check_composition(composition: Tuple[int, ...]) -> None:
    if max(composition) > 1:
        raise NotImplementedError(
            f"composition {tuple(composition)}: ring groups larger than one "
            f"need the torch.distributed ring, a later slice of the port")


# ---------------------------------------------------------------------------
# block metadata for ring-step and tile skipping
# ---------------------------------------------------------------------------

def _block_meta(seg, pos):
    """O(1) scalars describing a KV block: position/segment ranges over
    non-padding tokens."""
    valid = seg > 0
    big = torch.tensor(2**30, dtype=torch.int32, device=seg.device)
    none = torch.tensor(-1, dtype=torch.int32, device=seg.device)
    pos_min = torch.where(valid, pos, big).min()
    pos_max = torch.where(valid, pos, none).max()
    seg_min = torch.where(valid, seg, big).min()
    seg_max = torch.where(valid, seg, none).max()
    return torch.stack([pos_min, pos_max, seg_min, seg_max])


def _block_relevant(q_meta, k_meta, *, causal: bool,
                    window: int) -> torch.Tensor:
    """Can ANY local query attend to ANY token of this KV block?"""
    q_pos_min, q_pos_max, q_seg_min, q_seg_max = (q_meta[i] for i in range(4))
    k_pos_min, k_pos_max, k_seg_min, k_seg_max = (k_meta[i] for i in range(4))
    ok = (k_seg_min <= q_seg_max) & (q_seg_min <= k_seg_max)   # segment ranges overlap
    ok &= k_seg_max >= 0                                       # block not all padding
    ok &= q_seg_max >= 0
    if causal:
        ok &= k_pos_min <= q_pos_max                           # not entirely in the future
    if window:
        ok &= k_pos_max > q_pos_min - window                   # not entirely out of window
    return ok


def tile_liveness(q_seg, k_seg, q_pos, k_pos, *, causal: bool = True,
                  window: int = 0, tile: int = 64) -> torch.Tensor:
    """[ceil(T/tile), ceil(S/tile)] bool: `_block_relevant` of every pair of
    ``tile``-row q and KV tiles (a ragged last tile holds its real rows
    only) — the tiles the flash kernels visit."""
    def metas(seg, pos):
        return torch.stack([_block_meta(seg[a:a + tile], pos[a:a + tile])
                            for a in range(0, seg.shape[0], tile)], dim=1)
    return _block_relevant(metas(q_seg, q_pos)[:, :, None],
                           metas(k_seg, k_pos)[:, None, :], causal=causal,
                           window=window)


def ring_attention(q, k, v, q_seg, k_seg, q_pos, k_pos, *,
                   composition: Tuple[int, ...], kv_sharded: bool,
                   kv_group_of_head=None, scale: float, causal: bool = True,
                   window: int = 0, softcap: float = 0.0,
                   kv_chunk: int = 1024, block_skip: bool = True,
                   attn_impl: str = "flash",
                   v_in_k: Optional[Tuple[int, int]] = None,
                   block_q: int = 64, block_k: int = 64):
    """q [T, h, D]; k [T, G, Dk], v [T, G, Dv]; metadata [T] int32
    -> out [T, h, Dv].

    ``kv_group_of_head`` (replicated KV) gathers the kv head of each q
    head; otherwise q heads group as [G, h/G].  ``v_in_k=(offset, dv)``
    declares v a slice of k.  ``block_skip`` prunes visiting ring blocks
    and has nothing to prune with a singleton composition.
    """
    del block_skip
    _check_composition(composition)
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    use_group_gather = (not kv_sharded) and (kv_group_of_head is not None)
    if v_in_k is not None:
        v_off, dv = v_in_k
        kv = k
        kv_split = (k.shape[-1], v_off, dv)
    else:
        kv = torch.cat([k, v], dim=-1)
        kv_split = (k.shape[-1], k.shape[-1], v.shape[-1])
    dk, v_off, dv = kv_split

    if attn_impl == "flash":
        # lazy import: the kernel modules import this package's attention
        from repro_torch.kernels import ops as kernel_ops
        from repro_torch.kernels.ring_flash import RingConfig
        cfg = RingConfig(composition=tuple(composition), kv_split=kv_split,
                         gather=use_group_gather, scale=scale, causal=causal,
                         window=window, softcap=softcap, block_q=block_q,
                         block_k=block_k)
        kgi = kv_group_of_head if use_group_gather else None
        return kernel_ops.make_ring_flash(cfg)(q, kv, q_seg, k_seg, q_pos,
                                               k_pos, kgi)

    c = q.shape[0]
    k_blk, v_blk = kv[..., :dk], kv[..., v_off:v_off + dv]
    if use_group_gather:
        kq = q[:, :, None, :]                                # [C, h, 1, D]
        k_blk = k_blk.index_select(1, kv_group_of_head)
        v_blk = v_blk.index_select(1, kv_group_of_head)
    else:
        g = kv.shape[1]
        kq = q.reshape(c, g, q.shape[1] // g, q.shape[2])    # [C, G, Hg, D]
    stats = att.block_chunked_stats(
        kq, k_blk, v_blk, q_seg, k_seg, q_pos, k_pos, scale=scale,
        causal=causal, window=window, softcap=softcap, kv_chunk=kv_chunk)
    return att.finalize_stats(*stats, q.dtype).reshape(c, -1, dv)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale: float,
                     softcap: float = 0.0, window: int = 0):
    """One-token attention against a KV cache, in fp32.

    q [B, G, Hg, D]; k_cache [B, S, G, D]; v_cache [B, S, G, Dv];
    cache_len [B] valid prefix length per row -> [B, G, Hg, Dv] in q's
    dtype.  Rows with no valid entry return zeros.  (The single-device
    body of the reference's ``decode_attention_sharded``.)
    """
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None, :] < cache_len[:, None]                # [B, S]
    if window:
        valid &= pos[None, :] >= (cache_len[:, None] - window)
    valid = valid[:, None, None, :]
    s = torch.einsum("bghd,bsgd->bghs", q.float(), k_cache.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid, s, att.NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bghs,bsgd->bghd", p, v_cache.float())
    live = (l > 0)[..., None]
    out = torch.where(live, acc / torch.where(live, l[..., None], 1.0), 0.0)
    return out.to(q.dtype)
