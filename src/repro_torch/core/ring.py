"""HDP dist-attention: subgroup ring attention over the ranks of a
process group, and decode against a KV cache, whole or split over them.

Port of `repro/core/ring.py`.  A composition ``(g1, g2, ...)`` summing to
the HDP size describes disjoint contiguous rank groups; each group of size
g runs a g-step ring in which the KV blocks of its ranks visit every rank
of the group, and singleton groups attend locally with zero collective
traffic.  The ranks are a `repro_torch.parallel.comm.HdpComm` (the
reference's ``(mesh, hdp_axes)`` with ``ppermute``); ``comm=None`` is one
rank, where every composition is ``(1,)``.

`_block_meta` and `_block_relevant` are copies of the reference's ring
block predicate (can any query of one block see any key of another, from
their segment and position ranges).  The reference gates each ring step
with it under ``lax.cond`` on the carried metadata; here `ring_liveness`
all-gathers every rank's metadata once per ring call and decides every
rank's steps on the host, so no step waits on the device.  The flash
kernels apply the same rule per 64-row tile (`kernels/csrc/flash_tiles.cuh`),
and `tile_liveness` states it per tile in Python.

``attn_impl`` selects the compute backend: ``"ref"`` runs the plain
oracle ring (`core/attention.py`'s chunked stats merged step by step,
differentiated by autograd through `_RingShift`); ``"flash"`` runs the
ring-flash engine (`kernels/ring_flash.py` behind
`kernels/ops.make_ring_flash`), whose carry kernel is the CUDA flash
kernel on a CUDA device and its plain version on the CPU, and whose
gradient runs the flash backward kernels in a reverse ring.

An attention-free (RWKV) layer needs no ring: a sequence sharded over a
group passes its last token to the next rank (`shift_from_prev_rank`)
and composes the ranks' recurrent states (`distributed_state_scan`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import attention as att
from repro_torch.obs import ledger

ATTN_IMPLS = ("ref", "flash")


# ---------------------------------------------------------------------------
# compositions
# ---------------------------------------------------------------------------

def uniform_composition(hdp_size: int, group: int) -> Tuple[int, ...]:
    assert hdp_size % group == 0, (hdp_size, group)
    return (group,) * (hdp_size // group)


def composition_tables(composition: Sequence[int]):
    """Per-rank (group_size, group_start) arrays for a composition."""
    sizes, starts = [], []
    start = 0
    for g in composition:
        sizes += [g] * g
        starts += [start] * g
        start += g
    return (torch.tensor(sizes, dtype=torch.int32),
            torch.tensor(starts, dtype=torch.int32))


def ring_perm(composition: Sequence[int]) -> list:
    """Union of intra-group rings; singleton groups send nothing."""
    perm = []
    start = 0
    for g in composition:
        if g > 1:
            for j in range(g):
                perm.append((start + j, start + (j + 1) % g))
        start += g
    return perm


def check_composition(composition: Sequence[int], size: int) -> None:
    """A composition must cover the HDP ranks exactly."""
    if not composition or min(composition) < 1 or sum(composition) != size:
        raise ValueError(f"composition {tuple(composition)} does not sum to "
                         f"the {size} HDP rank(s)")


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


def ring_liveness(comm, composition: Sequence[int], q_seg, q_pos, k_seg,
                  k_pos, *, causal: bool, window: int,
                  block_skip: bool = True) -> torch.Tensor:
    """[size, steps + 1] bool on the host: whether rank r computes ring
    step s.  At step s rank r (j-th of a group of g starting at rank
    ``start``) holds the KV block of rank ``start + (j - s) mod g``; the
    step is live when s < g and, under ``block_skip``, `_block_relevant`
    holds for r's queries and that block — the reference's ``lax.cond``
    gate, identical in the forward and the backward.  Step 0 (the local
    block) is always live.  One ``all_gather`` of the eight metadata ints
    of every rank and one host fetch per call; none when there is no
    visiting block to judge.  Each attention layer calls it with its own
    ``window`` (0 for a global layer, the config's for a local one), so
    one wave's global and local layers get the reference's gate each: a
    visiting block further back than a local layer's window is dead for
    that layer only."""
    size = sum(composition)
    steps = max(composition) - 1
    sizes, starts = (x.tolist() for x in composition_tables(composition))
    metas = None
    if steps and block_skip:
        meta = torch.cat([_block_meta(q_seg, q_pos),
                          _block_meta(k_seg, k_pos)])
        metas = (meta[None] if comm is None
                 else comm.all_gather(meta)).tolist()
    live = torch.zeros((size, steps + 1), dtype=torch.bool)
    for r in range(size):
        g, start = sizes[r], starts[r]
        live[r, 0] = True
        for s in range(1, g):
            owner = start + (r - start - s) % g
            live[r, s] = metas is None or bool(_block_relevant(
                metas[r][:4], metas[owner][4:], causal=causal,
                window=window))
    return live


class _RingShift(torch.autograd.Function):
    """One rotation of the oracle ring's carried block, differentiable:
    ``ppermute``'s transpose (the inverse permutation) carries the block's
    gradient back.  The running stats pass through unchanged so that every
    rank's backward reaches every rotation in the same order, whether or
    not the rank used the block it received (a rank whose step is dead
    would otherwise skip a collective the other ranks wait in)."""

    @staticmethod
    def forward(ctx, comm, perm, acc, m, l, kv, seg, pos):
        ctx.comm, ctx.perm = comm, perm
        if ledger.tally_active():
            # bytes ledger: the block this rank sends, if it sends one
            ledger.record_comm("ring", ledger.tensor_bytes(kv, seg, pos)
                               * sum(a == comm.rank for a, _ in perm))
        kv_b, seg_b, pos_b = comm.ppermute([kv, seg, pos], perm)
        ctx.mark_non_differentiable(seg_b, pos_b)
        return acc, m, l, kv_b, seg_b, pos_b

    @staticmethod
    def backward(ctx, d_acc, d_m, d_l, d_kv, d_seg, d_pos):
        inverse = [(b, a) for a, b in ctx.perm]
        (d_kv,) = ctx.comm.ppermute([d_kv], inverse)
        return None, None, d_acc, d_m, d_l, d_kv, None, None


def _ring_attention_local(q, kv, q_seg, k_seg, q_pos, k_pos, *, comm,
                          composition: Tuple[int, ...],
                          kv_split: Tuple[int, int, int],    # (dk, v_off, dv)
                          kv_group_index,       # [hpl] int64 or None
                          scale: float, causal: bool, window: int,
                          softcap: float, kv_chunk: int, block_skip: bool):
    """Per-rank oracle ring.  Local shapes: q [C, hpl, D]; kv [C, G, Dk+Dv]
    fused (or [C, G, Dk] when v is a slice of k)."""
    dk, v_off, dv = kv_split
    c = q.shape[0]
    if kv_group_index is not None:
        # replicated KV: gather the kv head for each local q head -> Hg=1
        kq = q[:, :, None, :]                                # [C, hpl, 1, D]
        gather = lambda a: a.index_select(1, kv_group_index)  # noqa: E731
    else:
        g_local = kv.shape[1]
        kq = q.reshape(c, g_local, q.shape[1] // g_local, q.shape[2])
        gather = lambda a: a                                  # noqa: E731

    def compute_block(kv_blk, seg_blk, pos_blk):
        k_blk, v_blk = kv_blk[..., :dk], kv_blk[..., v_off:v_off + dv]
        return att.block_chunked_stats(
            kq, gather(k_blk), gather(v_blk), q_seg, seg_blk, q_pos, pos_blk,
            scale=scale, causal=causal, window=window, softcap=softcap,
            kv_chunk=kv_chunk)

    # step 0: the local block (always relevant: it holds our own diagonal)
    stats = compute_block(kv, k_seg, k_pos)
    steps = max(composition) - 1
    if steps:
        live = ring_liveness(comm, composition, q_seg, q_pos, k_seg, k_pos,
                             causal=causal, window=window,
                             block_skip=block_skip)[comm.rank]
        perm = ring_perm(composition)
        blk = (kv, k_seg, k_pos)
        for s in range(1, steps + 1):
            *stats, kv_b, seg_b, pos_b = _RingShift.apply(comm, perm, *stats,
                                                         *blk)
            blk = (kv_b, seg_b, pos_b)
            if live[s]:
                stats = att.merge_stats(stats, compute_block(*blk))
    return att.finalize_stats(*stats, q.dtype).reshape(c, -1, dv)


def ring_attention(q, k, v, q_seg, k_seg, q_pos, k_pos, *,
                   composition: Tuple[int, ...], kv_sharded: bool,
                   kv_group_of_head=None, scale: float, causal: bool = True,
                   window: int = 0, softcap: float = 0.0,
                   kv_chunk: int = 1024, block_skip: bool = True,
                   attn_impl: str = "flash",
                   v_in_k: Optional[Tuple[int, int]] = None,
                   block_q: int = 64, block_k: int = 64, comm=None):
    """This rank's slice: q [C, h, D]; k [C, G, Dk], v [C, G, Dv]; metadata
    [C] int32 -> out [C, h, Dv].  Under tensor parallelism h and G are the
    model rank's (its heads, and its KV groups or the replicated KV with
    its heads' slice of ``kv_group_of_head``); the ring runs over the HDP
    group ``comm`` alone.

    ``comm`` holds the HDP ranks (`parallel.comm.HdpComm`; None is one
    rank) and ``composition`` must sum to its size; every rank calls with
    the same composition and shapes.  ``kv_group_of_head`` (replicated KV)
    gathers the kv head of each q head; otherwise q heads group as
    [G, h/G].  ``v_in_k=(offset, dv)`` declares v a slice of k, and the
    ring then carries only k.  ``block_skip`` prunes visiting ring blocks
    that no local query can see.
    """
    check_composition(composition, 1 if comm is None else comm.size)
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
    kgi = kv_group_of_head if use_group_gather else None

    if attn_impl == "flash":
        # lazy import: the kernel modules import this package's attention
        from repro_torch.kernels import ops as kernel_ops
        from repro_torch.kernels.ring_flash import RingConfig
        cfg = RingConfig(composition=tuple(composition), kv_split=kv_split,
                         gather=use_group_gather, scale=scale, causal=causal,
                         window=window, softcap=softcap, block_q=block_q,
                         block_k=block_k, block_skip=block_skip)
        return kernel_ops.make_ring_flash(cfg)(q, kv, q_seg, k_seg, q_pos,
                                               k_pos, kgi, comm)
    return _ring_attention_local(
        q, kv, q_seg, k_seg, q_pos, k_pos, comm=comm,
        composition=tuple(composition), kv_split=kv_split,
        kv_group_index=kgi, scale=scale, causal=causal, window=window,
        softcap=softcap, kv_chunk=kv_chunk, block_skip=block_skip)


# ---------------------------------------------------------------------------
# cross-rank token shift and state scan (RWKV under HDP)
# ---------------------------------------------------------------------------

def shift_perm(composition: Sequence[int]) -> list:
    """Each rank to its successor within its group; the last rank of a
    group sends nothing and the first receives zeros (not cyclic, unlike
    `ring_perm`)."""
    perm = []
    start = 0
    for g in composition:
        perm += [(start + j, start + j + 1) for j in range(g - 1)]
        start += g
    return perm


class _Shift(torch.autograd.Function):
    """``ppermute`` along `shift_perm`, differentiable: the gradient of
    what a rank received goes back to its sender (the inverse
    permutation), as `_RingShift` carries the ring's."""

    @staticmethod
    def forward(ctx, comm, perm, x, seg):
        ctx.comm, ctx.perm = comm, perm
        x_b, seg_b = comm.ppermute([x, seg], perm)
        ctx.mark_non_differentiable(seg_b)
        return x_b, seg_b

    @staticmethod
    def backward(ctx, d_x, d_seg):
        (d_x,) = ctx.comm.ppermute([d_x.contiguous()],
                                   [(b, a) for a, b in ctx.perm])
        return None, None, d_x, None


def shift_from_prev_rank(x, seg, *, comm, composition: Sequence[int]):
    """Bring each rank the (row x [d], segment id seg []) of its
    predecessor within its group; the first rank of every group receives
    zeros.  Every rank calls it, those of groups of one too.  Not counted
    as ``"ring"`` bytes: the reference's byte model leaves the SSM relay
    out."""
    x_b, seg_b = _Shift.apply(comm, shift_perm(composition), x,
                              seg.reshape(1))
    return x_b, seg_b[0]


class _AllGather(torch.autograd.Function):
    """``HdpComm.all_gather``, differentiable: JAX's transpose of
    ``all_gather``, a psum-scatter: every rank's gradient of the gathered
    rows summed, this rank's row kept."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.all_gather(x.contiguous())

    @staticmethod
    def backward(ctx, d_all):
        return None, ctx.comm.reduce_scatter(d_all.contiguous())[0]


def distributed_state_scan(a_local, b_local, *, comm,
                           composition: Sequence[int]):
    """Exclusive prefix of the ranks' linear-recurrence summaries.

    Each rank reduces its local sweep to ``h_out = a_local ⊙ h_in +
    b_local`` (a [H, N, 1] broadcast over b [H, N, N]).  One all-gather
    brings every rank's (a, b); each rank then composes, in rank order,
    those of the ranks of its group before it.  Every rank of the HDP
    group calls it; each composition step is a select over all ranks, as
    the reference's masked scan, so every rank's result depends on the
    gathered rows and every rank joins the gradient's reduce-scatter."""
    n = b_local.shape[-1]
    both = _AllGather.apply(comm, torch.cat(
        [a_local.expand(*b_local.shape[:-1], 1), b_local], dim=-1))
    a_all, b_all = both[..., :1], both[..., 1:1 + n]
    start = int(composition_tables(composition)[1][comm.rank])
    h = torch.zeros_like(b_local)
    for i in range(comm.size):
        take = torch.tensor(start <= i < comm.rank, device=h.device)
        h = torch.where(take, a_all[i] * h + b_all[i], h)
    return h


def _decode_partial(q, k, v, cache_len, *, base: int, scale: float,
                    softcap: float, window: int):
    """fp32 online-softmax stats (m, l, acc) of one token per row against
    cache positions ``base + arange(S)``; masked entries weigh 0."""
    pos = base + torch.arange(k.shape[1], device=q.device)
    valid = pos[None, :] < cache_len[:, None]                # [B, S]
    if window:
        valid &= pos[None, :] >= (cache_len[:, None] - window)
    valid = valid[:, None, None, :]
    s = torch.einsum("bghd,bsgd->bghs", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid, s, att.NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bghs,bsgd->bghd", p, v.float())


def _decode_finish(l, acc, dtype):
    live = (l > 0)[..., None]
    out = torch.where(live, acc / torch.where(live, l[..., None], 1.0), 0.0)
    return out.to(dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale: float,
                     softcap: float = 0.0, window: int = 0):
    """One-token attention against a KV cache, in fp32.

    q [B, G, Hg, D]; k_cache [B, S, G, D]; v_cache [B, S, G, Dv];
    cache_len [B] valid prefix length per row -> [B, G, Hg, Dv] in q's
    dtype.  Rows with no valid entry return zeros.  (The single-device
    body of `decode_attention_sharded`.)
    """
    _, l, acc = _decode_partial(q, k_cache, v_cache, cache_len, base=0,
                                scale=scale, softcap=softcap, window=window)
    return _decode_finish(l, acc, q.dtype)


def decode_attention_sharded(q, k_shard, v_shard, cache_len, *, comm,
                             base: int, scale: float, softcap: float = 0.0,
                             window: int = 0):
    """One-token attention against a KV cache whose sequence dim is split
    over the ranks of ``comm``: the flash-decoding combine (port of the
    reference's ``decode_attention_sharded`` with its cache sequence over
    the HDP axes).

    q [B, G, Hg, D] (the same on every rank); k_shard [B, S_local, G, D],
    v_shard [B, S_local, G, Dv]: this rank's cache positions ``base +
    arange(S_local)``; cache_len [B] -> [B, G, Hg, Dv] in q's dtype.  Each
    rank computes the fp32 partial (m, l, acc) of its shard; one
    ``all_gather`` brings every rank's partial in rank order, and every
    rank merges them the same way, so the output is bit-identical on every
    rank.  Rows with no valid entry on any rank return zeros.  With
    ``comm=None`` one rank holds the whole cache (``base`` 0):
    `decode_attention`.
    """
    if comm is None:
        return decode_attention(q, k_shard, v_shard, cache_len, scale=scale,
                                softcap=softcap, window=window)
    m, l, acc = _decode_partial(q, k_shard, v_shard, cache_len, base=base,
                                scale=scale, softcap=softcap, window=window)
    parts = comm.all_gather(torch.cat([m[..., None], l[..., None], acc],
                                      dim=-1))       # [ranks, B, G, Hg, 2+Dv]
    m_r, l_r, acc_r = parts[..., 0], parts[..., 1], parts[..., 2:]
    w = torch.exp(m_r - m_r.amax(dim=0))
    return _decode_finish((l_r * w).sum(dim=0),
                          (acc_r * w[..., None]).sum(dim=0), q.dtype)
