"""DeepSeek-V2 Multi-head Latent Attention in the absorbed-latent form.

Port of `repro/models/mla.py`.  Absorption (the standard MLA decode trick,
used for training too):

    k_nope^h = c_kv @ W_uk^h  =>  q·k_nope = (q_nope @ W_uk^hᵀ) · c_kv
    out^h    = (attn @ c_kv) @ W_uv^h

so attention runs against one latent shared by every head, kv_lora_rank +
qk_rope_dim = 576 columns for DeepSeek-V2, whose values are its first
kv_lora_rank columns (``ring_attention(..., v_in_k=(0, kv_lora_rank))``):
the HDP ring ships 576 values a token, and the decode cache stores the
latent alone.  Parameters keep the reference's leaves and layouts, so the
bridge copies them as they are:

    w_q [d, H·(nope+rope)]; w_dkv [d, kv_lora+rope]; latent_norm {scale
    [kv_lora] f32}; w_uk [H, nope, kv_lora]; w_uv [H, kv_lora, v];
    w_o [H·v, d].

Under tensor parallelism model rank m holds heads [m·H/tp, (m+1)·H/tp):
its columns of ``w_q``, its heads of ``w_uk`` and ``w_uv`` and its rows
of ``w_o``; the latent (``w_dkv``, ``latent_norm``) is whole on every
rank.  `mla_qkv` and `mla_output` run the heads the leaves hold.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def mla_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    """Random MLA parameters: dense N(0,1)/sqrt(in) as the reference
    draws them (the draws differ from ``jax.random``)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    return {
        "w_q": L.dense_init(gen, d, h * qd, dtype, device),
        "w_dkv": L.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim, dtype,
                              device),
        "latent_norm": L.rmsnorm_init(m.kv_lora_rank, device),
        "w_uk": L.normal(gen, (h, m.qk_nope_dim, m.kv_lora_rank),
                         1.0 / math.sqrt(m.qk_nope_dim), dtype, device),
        "w_uv": L.normal(gen, (h, m.kv_lora_rank, m.v_head_dim),
                         1.0 / math.sqrt(m.kv_lora_rank), dtype, device),
        "w_o": L.dense_init(gen, h * m.v_head_dim, d, dtype, device),
    }


def mla_scale(cfg: ModelConfig) -> float:
    """1/sqrt(nope + rope): the scores of the expanded heads, which the
    absorbed product reproduces (not 1/sqrt of the latent's width)."""
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)


def mla_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """x [T, d], positions [T] -> (absorbed q [T, H, kv_lora+rope], the
    latent kv [T, 1, kv_lora+rope]).  RoPE rotates each head's q_rope and
    the one shared k_rope; the latent is RMS-normed; q_abs = q_nope @
    W_uk.  H: the heads ``params`` holds (``w_uk``'s first dim)."""
    m = cfg.mla
    h = params["w_uk"].shape[0]
    t = x.shape[0]
    q = (x @ params["w_q"]).reshape(t, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    ckv = x @ params["w_dkv"]                                # [T, lora+rope]
    c_kv = L.rmsnorm(params["latent_norm"], ckv[..., :m.kv_lora_rank],
                     cfg.norm_eps)
    k_rope = ckv[..., m.kv_lora_rank:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = L.apply_rope(k_rope[:, None, :], positions, cfg.rope_theta)[:, 0]
    q_abs = torch.einsum("thn,hnc->thc", q_nope, params["w_uk"])
    q_eff = torch.cat([q_abs, q_rope], dim=-1)               # [T, H, 576]
    kv_eff = torch.cat([c_kv, k_rope], dim=-1)[:, None, :]   # [T, 1, 576]
    return q_eff, kv_eff


def mla_output(params: dict, cfg: ModelConfig, attn_lat: torch.Tensor):
    """attn_lat [T, H, kv_lora] (attention over the latent values) ->
    [T, d] through the absorbed W_uv, then the output projection."""
    o = torch.einsum("thc,hcv->thv", attn_lat, params["w_uv"])
    return o.reshape(o.shape[0], -1) @ params["w_o"]
