"""Ring-flash attention engine, forward, for singleton compositions.

Port of `repro/kernels/ring_flash.py`.  In the reference, each of the
g ring steps folds one visiting KV block into carried online-softmax
state with the state-carrying flash kernel, and the state is finalised
once after the last step.  This slice serves on one device, where every
composition is ``(1,)`` and the ring has zero steps: the forward is one
carry-kernel call over the local block from zero stats, then
finalisation to (out, lse).  Groups larger than one need the ring on
``torch.distributed`` and raise `NotImplementedError` until that slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.kernels import flash_attention as FA


@dataclass(frozen=True)
class RingConfig:
    """Static configuration of one ring-flash call (composition, head
    mode, mask configuration, tile shape)."""

    composition: Tuple[int, ...]
    kv_split: Tuple[int, int, int]            # (dk, v_off, dv)
    gather: bool
    scale: float
    causal: bool = True
    window: int = 0
    softcap: float = 0.0
    block_q: int = FA.BLOCK_Q
    block_k: int = FA.BLOCK_K

    @property
    def steps(self) -> int:
        return max(self.composition) - 1


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


def _zero_stats(g, hg, c, dv, device):
    return FA.zero_state(g, hg, c, dv, device)


def ring_flash_fwd(cfg: RingConfig, q, kv, q_seg, k_seg, q_pos, k_pos, kgi):
    """Forward ring.  Shapes: q [C, hpl, D]; kv [C, G_kv, Dk(+Dv)];
    metadata [C] int32.  Returns (out [C, hpl, Dv], lse [G, Hg, C])."""
    if cfg.steps:
        raise NotImplementedError(
            f"composition {cfg.composition}: ring groups larger than one "
            f"need the torch.distributed ring, a later slice of the port")
    dk, v_off, dv = cfg.kv_split
    qt = _to_kernel_q(cfg, q, kv.shape[1])                   # [G, Hg, C, D]
    g_dim, hg, c = qt.shape[:3]
    kb, vb = _split_kv(cfg, kv, kgi)
    # step 0: the local block, from zero stats (updated in place)
    acc, m, l = FA.flash_attention_fwd_carry(
        qt, kb, vb, q_seg, k_seg, q_pos, k_pos,
        *_zero_stats(g_dim, hg, c, dv, q.device), scale=cfg.scale,
        causal=cfg.causal, window=cfg.window, softcap=cfg.softcap,
        block_q=cfg.block_q, block_k=cfg.block_k)
    out_t, lse = FA.finalize(acc, m, l, q.dtype)            # [G, Hg, C, Dv]
    return _from_kernel_out(out_t), lse
