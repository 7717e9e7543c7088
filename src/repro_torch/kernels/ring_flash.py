"""Ring-flash attention engine for singleton compositions, forward and
backward.

Port of `repro/kernels/ring_flash.py`.  In the reference, each of the
g ring steps folds one visiting KV block into carried online-softmax
state with the state-carrying flash kernel, the state is finalised once
after the last step, and the backward ("reverse") ring runs the flash
backward kernels on each visiting block and sends its dk/dv home.  On one
device every composition is ``(1,)`` and the ring has zero steps: the
forward is one carry-kernel call over the local block from zero stats,
then finalisation to (out, lse); the backward is one `flash_attention_bwd`
over the local block, then `_pack_dkv`.  Groups larger than one need the
ring on ``torch.distributed`` and raise `NotImplementedError` until that
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import flash_attention as FA


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

    @property
    def steps(self) -> int:
        return max(self.composition) - 1

    @property
    def kernel_kw(self) -> dict:
        return dict(scale=self.scale, causal=self.causal, window=self.window,
                    softcap=self.softcap, block_q=self.block_q,
                    block_k=self.block_k)


def _check_steps(cfg: RingConfig) -> None:
    if cfg.steps:
        raise NotImplementedError(
            f"composition {cfg.composition}: ring groups larger than one "
            f"need the torch.distributed ring, a later slice of the port")


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


def ring_flash_fwd(cfg: RingConfig, q, kv, q_seg, k_seg, q_pos, k_pos, kgi):
    """Forward ring.  Shapes: q [C, hpl, D]; kv [C, G_kv, Dk(+Dv)];
    metadata [C] int32.  Returns (out [C, hpl, Dv], residuals), the
    residuals being the reference's (qt, kv, q_seg, k_seg, q_pos, k_pos,
    kgi, out_t, lse) that `ring_flash_bwd` takes."""
    _check_steps(cfg)
    dv = cfg.kv_split[2]
    qt = _to_kernel_q(cfg, q, kv.shape[1])                   # [G, Hg, C, D]
    g_dim, hg, c = qt.shape[:3]
    kb, vb = _split_kv(cfg, kv, kgi)
    # step 0: the local block, from zero stats (updated in place)
    acc, m, l = FA.flash_attention_fwd_carry(
        qt, kb, vb, q_seg, k_seg, q_pos, k_pos,
        *FA.zero_state(g_dim, hg, c, dv, q.device), **cfg.kernel_kw)
    out_t, lse = FA.finalize(acc, m, l, q.dtype)            # [G, Hg, C, Dv]
    return _from_kernel_out(out_t), (qt, kv, q_seg, k_seg, q_pos, k_pos, kgi,
                                     out_t, lse)


def ring_flash_bwd(cfg: RingConfig, res, do):
    """Backward ring at zero steps: the flash backward over the local block
    -> (dq [C, hpl, D] in q's dtype, dkv [C, G_kv, Dk(+Dv)] in kv's)."""
    _check_steps(cfg)
    qt, kv, q_seg, k_seg, q_pos, k_pos, kgi, out_t, lse = res
    g_kv = kv.shape[1]
    do_t = _to_kernel_q(cfg, do.to(qt.dtype), g_kv)          # [G, Hg, C, Dv]
    kb, vb = _split_kv(cfg, kv, kgi)
    dq_t, dk_s, dv_s = FA.flash_attention_bwd(
        qt, kb, vb, q_seg, k_seg, q_pos, k_pos, out_t, lse, do_t,
        **cfg.kernel_kw)
    dkv = _pack_dkv(cfg, dk_s, dv_s, kgi, g_kv)
    return _from_kernel_out(dq_t), dkv.to(kv.dtype)
