"""Serving steps: prefill over packed buffers, decode against a KV slab.

Port of `repro/train/serve_step.py` for dense attention models on one
device.  The decode cache keeps the reference's layout,
``{"head_layers": [...], "blocks": [{"k", "v"} per pattern position]}``
with block leaves stacked ``[n_periods, B, S, G, Dk]``, and the port
UPDATES IT IN PLACE: each decode step writes its new K/V rows into the
slab tensors with an indexed assignment and returns the same dict.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ring as R
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_ffn_block, _index,
                                            apply_periods, check_supported,
                                            embed_frontend, embed_tokens,
                                            forward_hidden, head_layer_count,
                                            logits_head)
from repro_torch.parallel.sharding import Runtime


def _layer_cache_len(cfg: ModelConfig, layer_idx: int, seq_len: int) -> int:
    code = cfg.layer_code(layer_idx)
    if code == "l" and cfg.window:
        return min(cfg.window, seq_len)
    return seq_len


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, rt: Runtime, layer_idx: int, batch: int,
                 seq_len: int, lead=()) -> dict:
    s = _layer_cache_len(cfg, layer_idx, seq_len)
    shape = (*lead, batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = L.activation_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=rt.device),
            "v": torch.zeros(shape, dtype=dt, device=rt.device)}


def init_decode_cache(cfg: ModelConfig, rt: Runtime, batch: int,
                      seq_len: int) -> dict:
    check_supported(cfg)
    head_n = head_layer_count(cfg)
    period = len(cfg.layer_pattern)
    n_periods = (cfg.num_layers - head_n) // period
    return {
        "head_layers": [_layer_cache(cfg, rt, i, batch, seq_len)
                        for i in range(head_n)],
        "blocks": [_layer_cache(cfg, rt, head_n + j, batch, seq_len,
                                lead=(n_periods,))
                   for j in range(period)],
    }


# ---------------------------------------------------------------------------
# decode blocks
# ---------------------------------------------------------------------------

def _decode_attention(bp, cache, cfg: ModelConfig, rt: Runtime, x, pos,
                      layer_idx: int, seq_len: int):
    """``pos`` [B]: each slot decodes at its own depth; its new K/V row
    lands at ``pos % s_l`` of that slot, written into ``cache`` in place."""
    b = x.shape[0]
    s_l = _layer_cache_len(cfg, layer_idx, seq_len)
    slot = pos % s_l                                         # [B]
    filled = torch.clamp(pos + 1, max=s_l)                   # [B]
    rows = torch.arange(b, device=x.device)

    layout = rt.layout(cfg)
    dk = cfg.resolved_head_dim
    g = cfg.num_kv_heads
    q = (x @ bp["w_q"]).reshape(b, layout.h_pad, dk)
    kv = torch.einsum("bd,dsgk->bsgk", x, bp["w_kv"])
    k_new, v_new = kv[:, 0], kv[:, 1]
    q, k_new = L.positional_rotate(cfg, q, k_new, pos, pos)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[rows, slot] = k_new.to(k_cache.dtype)
    v_cache[rows, slot] = v_new.to(v_cache.dtype)
    qg = q.reshape(b, g, layout.hpg_pad, dk)
    out = R.decode_attention(qg, k_cache, v_cache, filled, scale=dk ** -0.5,
                             softcap=cfg.attn_softcap)
    out = out.reshape(b, layout.h_pad, dk)
    if layout.pad_heads:
        out = out * layout.head_mask(x.device)[None, :, None].to(out.dtype)
    return out.reshape(b, -1) @ bp["w_o"]


def _decode_block(bp, cache, cfg: ModelConfig, rt: Runtime, x, pos,
                  layer_idx: int, seq_len: int):
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    h = _decode_attention(bp["attn"], cache, cfg, rt, h, pos, layer_idx,
                          seq_len)
    x = x + h.to(x.dtype)
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    h = _ffn_block(bp["mlp"], cfg, h)
    return x + h.to(x.dtype)


def make_decode_step(cfg: ModelConfig, rt: Runtime, batch: int,
                     seq_len: int):
    check_supported(cfg)
    head_n = head_layer_count(cfg)
    period = len(cfg.layer_pattern)

    def decode_step(params, cache, tokens, pos):
        """tokens [B] int; pos: an int OR per-slot [B] positions (a
        continuously batched pool decodes every slot at its own depth).
        Returns (logits [B, V], cache) — the cache updated in place."""
        x = embed_tokens(params, cfg, tokens)
        b = x.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
        pos_b = pos.expand(b) if pos.dim() == 0 else pos
        for i, bp in enumerate(params["head_blocks"]):
            x = _decode_block(bp, cache["head_layers"][i], cfg, rt, x, pos_b,
                              i, seq_len)
        n_periods = params["blocks"][0]["norm1"]["scale"].shape[0]
        for i in range(n_periods):
            for j in range(period):
                # the period's cache views alias the stacked slab
                x = _decode_block(_index(params["blocks"][j], i),
                                  _index(cache["blocks"][j], i), cfg, rt, x,
                                  pos_b, head_n + j, seq_len)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return logits_head(params, cfg, x), cache

    return decode_step


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, rt: Runtime):
    def prefill_step(params, batch):
        """Packed-buffer forward; returns logits at each sequence's last
        token (batch["last_idx"] [B])."""
        h = forward_hidden(params, cfg, rt, batch)
        return logits_head(params, cfg, h.index_select(0, batch["last_idx"]))

    return prefill_step


def make_prefill_kv_step(cfg: ModelConfig, rt: Runtime):
    """Packed-buffer prefill that also returns the per-layer KV rows, so
    the serving engine can scatter them into the decode slab.

    Returns ``prefill_kv(params, batch) -> (hidden [T,d], head_kv,
    block_kv)``: ``head_kv`` a list (per head block) of {"k", "v"}
    [T, G, Dk] rows and ``block_kv`` a tuple (per pattern position) of the
    same stacked [n_periods, T, G, Dk] — the `init_decode_cache` layout
    minus the batch dim."""
    check_supported(cfg)
    period = len(cfg.layer_pattern)

    def prefill_kv(params, batch):
        head_kv: list = []
        x = embed_frontend(params, cfg, rt, batch, collect=head_kv)
        per_period: list = []
        x = apply_periods(params["blocks"], cfg, rt, x, batch["seg"],
                          batch["pos"], collect=per_period)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        block_kv = tuple(
            {name: torch.stack([kvs[j][name] for kvs in per_period])
             for name in ("k", "v")}
            for j in range(period))
        return x, head_kv, block_kv

    return prefill_kv
