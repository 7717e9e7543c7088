"""Ring-flash attention engine, forward and backward, over the ranks of
an `HdpComm`.

Port of `repro/kernels/ring_flash.py`.  Each of the g ring steps folds one
visiting KV block into carried online-softmax state with the
state-carrying flash kernel, and the state is finalised once after the
last step.

Forward ring (per rank): step 0 runs the local block from zero stats; the
``ppermute`` that fetches block s+1 is issued before step s's kernel and
waited on only before that block is used (over NCCL the wait orders the
stream, so the transfer overlaps the kernel); the last step is peeled, so
no dead rotation is sent; a dead step (s beyond the rank's group, or a
block no local query can see) launches no kernel.  Liveness comes from
`core.ring.ring_liveness`: one all-gather of every rank's block metadata
per call, no host sync per step, and the same table in the backward.

Backward ("reverse") ring: the KV blocks take the same tour.  At step s
the rank holds the block of rank (r - s) in its group; the flash backward
kernels give that step's dq, summed in fp32 over the steps, and dk/dv of
the visiting block, which `_pack_dkv` folds into the carried layout and
one reverse ``ppermute`` hop (rank j -> j - s in the group) returns home,
where the steps' dkv are summed in fp32 and cast once.  dq and dkv at
every step use the ring's final (out, lse), so delta = rowsum(do·out) is
the same at every step.

Both head modes run: sharded KV (q heads reshaped to [G, Hg]) and the
replicated-KV gather (one KV row per q head under ``kv_group_of_head``),
including the MLA ``v_in_k`` latent, where the ring carries only k.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core.ring import check_composition, ring_liveness, ring_perm
from repro_torch.kernels import flash_attention as FA
from repro_torch.obs import ledger


@dataclass(frozen=True)
class RingConfig:
    """Static configuration of one ring-flash call (composition, head
    mode, mask configuration, tile shape); hashable, so it keys
    `kernels.ops.make_ring_flash`."""

    composition: Tuple[int, ...]
    kv_split: Tuple[int, int, int]            # (dk, v_off, dv)
    gather: bool
    scale: float
    causal: bool = True
    window: int = 0
    softcap: float = 0.0
    block_q: int = FA.BLOCK_Q
    block_k: int = FA.BLOCK_K
    block_skip: bool = True

    @property
    def steps(self) -> int:
        return max(self.composition) - 1

    @property
    def perm(self):
        return ring_perm(self.composition)

    @property
    def kernel_kw(self) -> dict:
        return dict(scale=self.scale, causal=self.causal, window=self.window,
                    softcap=self.softcap, block_q=self.block_q,
                    block_k=self.block_k)


def _reverse_perm(cfg: RingConfig, s: int):
    """One-hop "send the visiting block's dkv home" permutation for step s:
    within a group of size g, rank j -> j - s (mod g).  Groups whose shift
    is a no-op at this step (singletons; s % g == 0) are omitted — unlisted
    destinations receive zeros, matching their zero contribution."""
    perm = []
    start = 0
    for g in cfg.composition:
        if g > 1 and s % g != 0:
            for j in range(g):
                perm.append((start + j, start + (j - s) % g))
        start += g
    return perm


def _rank(comm) -> int:
    return 0 if comm is None else comm.rank


def _liveness(cfg: RingConfig, comm, q_seg, q_pos, k_seg, k_pos):
    """[size, steps + 1] bool (host) of every rank's live steps."""
    check_composition(cfg.composition, 1 if comm is None else comm.size)
    return ring_liveness(comm, cfg.composition, q_seg, q_pos, k_seg, k_pos,
                         causal=cfg.causal, window=cfg.window,
                         block_skip=cfg.block_skip)


def _to_kernel_q(cfg: RingConfig, x, g_kv: int):
    """[C, hpl, D] -> kernel layout [G, Hg, C, D], contiguous (sharded-KV
    mode groups heads; gather mode runs one KV row per q head)."""
    c, hpl, d = x.shape
    if cfg.gather:
        return x.permute(1, 0, 2)[:, None].contiguous()      # [hpl, 1, C, D]
    if hpl % g_kv:
        raise ValueError(f"{hpl} q heads do not group over {g_kv} kv heads")
    return x.reshape(c, g_kv, hpl // g_kv, d).permute(1, 2, 0, 3).contiguous()


def _from_kernel_out(x):
    """[G, Hg, C, Dv] -> [C, hpl, Dv] (both head modes)."""
    g, hg, c, dv = x.shape
    return x.permute(2, 0, 1, 3).reshape(c, g * hg, dv)


def _split_kv(cfg: RingConfig, kv_blk, kgi):
    """Carried block [C, G_kv, Dk(+Dv)] -> kernel k [G, C, Dk], v [G, C, Dv],
    contiguous (per-head gather applied in gather mode)."""
    dk, v_off, dv = cfg.kv_split
    k_blk = kv_blk[..., :dk]
    v_blk = kv_blk[..., v_off:v_off + dv]
    if cfg.gather:
        k_blk = k_blk.index_select(1, kgi)
        v_blk = v_blk.index_select(1, kgi)
    return (k_blk.permute(1, 0, 2).contiguous(),
            v_blk.permute(1, 0, 2).contiguous())


def _pack_dkv(cfg: RingConfig, dk_s, dv_s, kgi, g_kv: int):
    """Kernel-layout (dk [G, C, Dk], dv [G, C, Dv]) -> carried-block layout
    [C, G_kv, Dk(+Dv)] f32, un-gathering per-head contributions back onto
    their KV group and folding dv into the fused (or v_in_k overlapped)
    column range."""
    dk, v_off, dv = cfg.kv_split
    dk_c = dk_s.permute(1, 0, 2).float()                 # [C, G|hpl, Dk]
    dv_c = dv_s.permute(1, 0, 2).float()
    c = dk_c.shape[0]
    dev = dk_c.device
    if cfg.gather:                       # scatter-add heads -> KV groups
        dk_c = torch.zeros((c, g_kv, dk), dtype=torch.float32,
                           device=dev).index_add_(1, kgi, dk_c)
        dv_c = torch.zeros((c, g_kv, dv), dtype=torch.float32,
                           device=dev).index_add_(1, kgi, dv_c)
    out = torch.zeros((c, g_kv, max(dk, v_off + dv)), dtype=torch.float32,
                      device=dev)
    out[..., :dk] += dk_c
    out[..., v_off:v_off + dv] += dv_c
    return out


def ring_flash_fwd(cfg: RingConfig, q, kv, q_seg, k_seg, q_pos, k_pos, kgi,
                   comm=None):
    """Forward ring over ``comm`` (None: one rank).  Shapes: q [C, hpl, D];
    kv [C, G_kv, Dk(+Dv)]; metadata [C] int32.  Returns (out [C, hpl, Dv],
    residuals), the residuals being the reference's (qt, kv, q_seg, k_seg,
    q_pos, k_pos, kgi, out_t, lse) and the liveness table that
    `ring_flash_bwd` takes."""
    dv = cfg.kv_split[2]
    live = _liveness(cfg, comm, q_seg, q_pos, k_seg, k_pos)
    mine = live[_rank(comm)].tolist()
    qt = _to_kernel_q(cfg, q, kv.shape[1])                   # [G, Hg, C, D]
    g_dim, hg, c = qt.shape[:3]
    state = FA.zero_state(g_dim, hg, c, dv, q.device)

    def step_kernel(kv_b, seg_b, pos_b):           # updates state in place
        kb, vb = _split_kv(cfg, kv_b, kgi)
        FA.flash_attention_fwd_carry(qt, kb, vb, q_seg, seg_b, q_pos, pos_b,
                                     *state, **cfg.kernel_kw)

    blk = [kv, k_seg, k_pos]
    if cfg.steps and ledger.tally_active():
        # bytes ledger: the forward's `steps` rotations of this rank's
        # block, if it sends one (the reverse ring in `ring_flash_bwd` is
        # not counted: forward traffic only, obs/ledger.py)
        ledger.record_comm("ring", cfg.steps * ledger.tensor_bytes(*blk)
                           * sum(a == _rank(comm) for a, _ in cfg.perm))
    # the rotation fetching step 1's block goes out before step 0's kernel
    nxt = comm.ppermute_async(blk, cfg.perm) if cfg.steps else None
    step_kernel(*blk)                  # step 0: the local block
    for s in range(1, cfg.steps + 1):
        blk = nxt.wait()
        if s < cfg.steps:              # the last step is peeled: no rotation
            nxt = comm.ppermute_async(blk, cfg.perm)
        if mine[s]:
            step_kernel(*blk)
    out_t, lse = FA.finalize(*state, q.dtype)              # [G, Hg, C, Dv]
    return _from_kernel_out(out_t), (qt, kv, q_seg, k_seg, q_pos, k_pos, kgi,
                                     out_t, lse, live)


def ring_flash_bwd(cfg: RingConfig, res, do, comm=None):
    """Reverse ring -> (dq [C, hpl, D] in q's dtype, dkv [C, G_kv,
    Dk(+Dv)] in kv's).  Per-step dq folds into an fp32 sum; the visiting
    block's dkv returns home in one reverse-``ppermute`` hop, sent only by
    ranks whose step was live (every rank knows every rank's table)."""
    qt, kv, q_seg, k_seg, q_pos, k_pos, kgi, out_t, lse, live = res
    g_kv = kv.shape[1]
    do_t = _to_kernel_q(cfg, do.to(qt.dtype), g_kv)          # [G, Hg, C, Dv]
    mine = live[_rank(comm)].tolist()
    dq_t = dkv = None
    hops = []                          # (issued reverse hop, received here)
    blk = [kv, k_seg, k_pos]
    for s in range(cfg.steps + 1):
        nxt = comm.ppermute_async(blk, cfg.perm) if s < cfg.steps else None
        dkv_s = None
        if mine[s]:
            kb, vb = _split_kv(cfg, blk[0], kgi)
            dq_s, dk_s, dv_s = FA.flash_attention_bwd(
                qt, kb, vb, q_seg, blk[1], q_pos, blk[2], out_t, lse, do_t,
                **cfg.kernel_kw)
            # fp32 sum over the steps (one rank: the kernel's dq as it is)
            dq_t = dq_s if s == 0 else dq_t.float().add_(dq_s.float())
            dkv_s = _pack_dkv(cfg, dk_s, dv_s, kgi, g_kv)
        if s == 0:
            dkv = dkv_s                # the local block is always live
        else:
            pairs = [(a, b) for a, b in _reverse_perm(cfg, s) if live[a, s]]
            if pairs:
                if dkv_s is None:      # sends nothing; shapes the receive
                    dkv_s = torch.empty(kv.shape, dtype=torch.float32,
                                        device=kv.device)
                hops.append((comm.ppermute_async([dkv_s], pairs),
                             any(b == _rank(comm) for _, b in pairs)))
        if nxt is not None:
            blk = nxt.wait()
    for hop, received in hops:         # in step order, as the reference sums
        got = hop.wait()[0]
        if received:
            dkv = dkv + got
    return _from_kernel_out(dq_t).to(qt.dtype), dkv.to(kv.dtype)
