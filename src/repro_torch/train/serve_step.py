"""Serving steps: prefill over packed buffers, decode against a KV slab.

Port of `repro/train/serve_step.py` for global-attention models, dense or
MoE.  The decode cache keeps the reference's layout, ``{"head_layers": [...],
"blocks": [{"k", "v"} per pattern position]}`` with block leaves stacked
``[n_periods, B, S, G, Dk]``, and the port UPDATES IT IN PLACE: each
decode step writes its new K/V rows into the slab tensors with an indexed
assignment and returns the same dict.

Over several HDP ranks (``rt.comm``) each rank holds one shard of the
slab, by the reference's `decode_axes` rule (`decode_layout`): the slots
split over the ranks when they tile them (``"batch"``), otherwise every
rank holds every slot's share of the cache positions (``"seq"``) and
attention merges the ranks' partials (`core/ring.py::
decode_attention_sharded`).  Every layer caches all ``seq_len``
positions: `check_supported` rejects windowed (ring-buffer) layers, so
neither layout meets one.

An MoE layer routes the whole slab as one group in decode, as the
reference does (its ``moe_forward`` on the global ``[B, d]``): every slot
in slot order, free slots and the tokens the engine feeds them included.
Under ``"seq"`` every rank runs every slot, so it routes the slab itself;
under ``"batch"`` a rank holds its slots' rows only, and
`models/moe.py::moe_forward_sharded` all-gathers the ranks' top-k
indices, one small collective a layer, so every rank takes the slab's
capacity decisions for its rows.  (A prefill wave routes each rank's
rows apart, as training does.)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ring as R
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.transformer import (_ffn_block, _index,
                                            apply_periods, check_supported,
                                            embed_frontend, embed_tokens,
                                            forward_hidden, head_layer_count,
                                            logits_head)
from repro_torch.parallel.sharding import Runtime


# ---------------------------------------------------------------------------
# the slab's layout over the HDP ranks
# ---------------------------------------------------------------------------

def decode_layout(batch: int, hdp: int) -> str:
    """The reference's `decode_axes` as a rule on (batch, hdp):
    ``"batch"`` (each rank holds batch/hdp whole slots) when the batch
    tiles the ranks, else ``"seq"`` (each rank holds every slot's
    seq_len/hdp cache positions).  A live pool is any size, so an uneven
    batch shards the sequence instead."""
    if batch >= hdp and batch % hdp == 0:
        return "batch"
    return "seq"


@dataclass(frozen=True)
class SlabShard:
    """One rank's shard of a ``[batch, seq_len]`` decode slab: slots
    ``[slot0, slot0 + slots)`` at cache positions ``[base, base +
    positions)``.  One rank holds the whole slab."""
    layout: str
    slots: int
    slot0: int
    positions: int
    base: int

    def owns(self, slot, pos):
        """Whether (global) ``slot`` and cache position ``pos`` lie in this
        shard; numpy or torch, elementwise."""
        return ((slot >= self.slot0) & (slot < self.slot0 + self.slots)
                & (pos >= self.base) & (pos < self.base + self.positions))


def slab_shard(rt: Runtime, batch: int, seq_len: int) -> SlabShard:
    hdp = rt.hdp_size
    rank = 0 if rt.comm is None else rt.comm.rank
    layout = decode_layout(batch, hdp)
    if layout == "batch":
        n = batch // hdp
        return SlabShard(layout, n, rank * n, seq_len, 0)
    if seq_len % hdp:
        raise ValueError(
            f"{batch} slots do not tile {hdp} HDP ranks, so the decode slab "
            f"splits its {seq_len} cache positions over them, which needs "
            f"seq_len % hdp == 0")
    n = seq_len // hdp
    return SlabShard(layout, batch, 0, n, rank * n)


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, rt: Runtime, sh: SlabShard,
                 lead=()) -> dict:
    shape = (*lead, sh.slots, sh.positions, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = L.activation_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=rt.device),
            "v": torch.zeros(shape, dtype=dt, device=rt.device)}


def init_decode_cache(cfg: ModelConfig, rt: Runtime, batch: int,
                      seq_len: int) -> dict:
    """This rank's shard (`slab_shard`) of a ``batch``-slot slab of
    ``seq_len`` positions: the whole slab on one rank."""
    check_supported(cfg)
    sh = slab_shard(rt, batch, seq_len)
    head_n = head_layer_count(cfg)
    period = len(cfg.layer_pattern)
    n_periods = (cfg.num_layers - head_n) // period
    return {
        "head_layers": [_layer_cache(cfg, rt, sh) for _ in range(head_n)],
        "blocks": [_layer_cache(cfg, rt, sh, lead=(n_periods,))
                   for _ in range(period)],
    }


def cache_bytes(cache: dict) -> int:
    return sum(buf.numel() * buf.element_size()
               for layer in cache["head_layers"] + cache["blocks"]
               for buf in layer.values())


# ---------------------------------------------------------------------------
# decode blocks
# ---------------------------------------------------------------------------

def _decode_attention(bp, cache, cfg: ModelConfig, rt: Runtime, x, pos,
                      sh: SlabShard):
    """``pos`` [B]: each slot decodes at its own depth; its new K/V row
    lands at position ``pos`` of that slot, written into ``cache`` in place
    by the rank whose shard holds it.  As in the reference, a position past
    the slab (a free slot whose last request filled its context) wraps
    round it and attends to at most ``seq_len`` positions."""
    b = x.shape[0]
    rows = torch.arange(b, device=x.device)
    layout = rt.layout(cfg)
    dk = cfg.resolved_head_dim
    g = cfg.num_kv_heads
    q = (x @ bp["w_q"]).reshape(b, layout.h_pad, dk)
    kv = torch.einsum("bd,dsgk->bsgk", x, bp["w_kv"])
    k_new, v_new = kv[:, 0], kv[:, 1]
    q, k_new = L.positional_rotate(cfg, q, k_new, pos, pos)
    k_cache, v_cache = cache["k"], cache["v"]
    k_new, v_new = k_new.to(k_cache.dtype), v_new.to(v_cache.dtype)
    seq_len = sh.positions * (rt.hdp_size if sh.layout == "seq" else 1)
    local = pos % seq_len
    if sh.layout == "seq":
        # every rank runs every slot; only the one holding ``pos`` changes
        # its row (the others write back what they hold)
        local = local - sh.base
        own = ((local >= 0) & (local < sh.positions))[:, None, None]
        local = local.clamp(0, sh.positions - 1)
        k_new = torch.where(own, k_new, k_cache[rows, local])
        v_new = torch.where(own, v_new, v_cache[rows, local])
    k_cache[rows, local] = k_new
    v_cache[rows, local] = v_new
    qg = q.reshape(b, g, layout.hpg_pad, dk)
    out = R.decode_attention_sharded(
        qg, k_cache, v_cache, (pos + 1).clamp(max=seq_len),
        comm=rt.comm if sh.layout == "seq" else None, base=sh.base,
        scale=dk ** -0.5, softcap=cfg.attn_softcap)
    out = out.reshape(b, layout.h_pad, dk)
    if layout.pad_heads:
        out = out * layout.head_mask(x.device)[None, :, None].to(out.dtype)
    return out.reshape(b, -1) @ bp["w_o"]


def _decode_block(bp, cache, cfg: ModelConfig, rt: Runtime, x, pos,
                  sh: SlabShard):
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    h = _decode_attention(bp["attn"], cache, cfg, rt, h, pos, sh)
    x = x + h.to(x.dtype)
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    if "moe" in bp:
        h = _decode_moe(bp["moe"], cfg, rt, h, sh)
    else:
        h = _ffn_block(bp["mlp"], cfg, h)
    return x + h.to(x.dtype)


def _decode_moe(bp, cfg: ModelConfig, rt: Runtime, x, sh: SlabShard):
    """The MoE of one decode layer, the whole slab routed as one group:
    ``x`` is this rank's slots' rows ([B/hdp, d] under ``"batch"``, all B
    otherwise)."""
    if sh.layout == "batch" and rt.hdp_size > 1:
        return MOE.moe_forward_sharded(bp, cfg, x, rt.comm)
    return MOE.moe_forward(bp, cfg, x)


def make_decode_step(cfg: ModelConfig, rt: Runtime, batch: int,
                     seq_len: int):
    """The decode step of this rank's `slab_shard`.  Under ``"batch"`` it
    runs this rank's slots only (the caller gathers the ranks' rows);
    under ``"seq"`` every rank runs every slot and attention merges the
    ranks' partials, so every rank returns the same logits."""
    check_supported(cfg)
    sh = slab_shard(rt, batch, seq_len)
    period = len(cfg.layer_pattern)
    mine = slice(sh.slot0, sh.slot0 + sh.slots)

    def decode_step(params, cache, tokens, pos):
        """tokens [B] int; pos: an int OR per-slot [B] positions (a
        continuously batched pool decodes every slot at its own depth),
        both for the whole slab.  Returns (logits [slots, V] of this rank's
        slots, cache) — the cache updated in place."""
        pos = torch.as_tensor(pos, dtype=torch.int64, device=tokens.device)
        pos = pos.expand(batch) if pos.dim() == 0 else pos
        tokens, pos = tokens[mine], pos[mine]
        x = embed_tokens(params, cfg, tokens)
        for i, bp in enumerate(params["head_blocks"]):
            x = _decode_block(bp, cache["head_layers"][i], cfg, rt, x, pos,
                              sh)
        n_periods = params["blocks"][0]["norm1"]["scale"].shape[0]
        for i in range(n_periods):
            for j in range(period):
                # the period's cache views alias the stacked slab
                x = _decode_block(_index(params["blocks"][j], i),
                                  _index(cache["blocks"][j], i), cfg, rt, x,
                                  pos, sh)
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
