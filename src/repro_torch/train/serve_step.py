"""Serving steps: prefill over packed buffers, decode against a KV slab.

Port of `repro/train/serve_step.py` for attention models, dense or MoE,
GQA or MLA, with global and sliding-window local layers.  The decode cache
keeps the reference's layout, ``{"head_layers": [...], "blocks": [{"k",
"v"} per pattern position]}`` with block leaves stacked ``[n_periods, B,
S_l, G, Dk]`` (an MLA layer caches its latent alone, ``{"kv_lat"}`` [...,
B, S_l, 1, kv_lora+rope]), and the port UPDATES IT IN PLACE: each decode
step writes its new K/V rows into the slab tensors with an indexed
assignment and returns the same dict.  A global layer caches ``S_l =
seq_len`` positions; a local (``l``) layer keeps a ring buffer of ``S_l =
min(window, seq_len)`` (`layer_cache_len`): position p lives at ``p %
S_l`` and attention reads the ``min(p + 1, S_l)`` filled entries, which
are exactly the window.

Over several HDP ranks (``rt.comm``) each rank holds one shard of the
slab, by the reference's `decode_axes` rule (`decode_layout`): the slots
split over the ranks when they tile them (``"batch"``), otherwise every
rank holds every slot's share of the cache positions (``"seq"``) and
attention merges the ranks' partials (`core/ring.py::
decode_attention_sharded`).  The layout is the slab's, so every layer has
the same one; under ``"seq"`` each layer splits its own ``S_l`` positions
(a local layer's ring buffer as well), so ``S_l % hdp == 0`` is needed.

An MoE layer routes the whole slab as one group in decode, as the
reference does (its ``moe_forward`` on the global ``[B, d]``): every slot
in slot order, free slots and the tokens the engine feeds them included.
Under ``"seq"`` every rank runs every slot, so it routes the slab itself;
under ``"batch"`` a rank holds its slots' rows only, and
`models/moe.py::moe_forward_sharded` all-gathers the ranks' top-k
indices, one small collective a layer, so every rank takes the slab's
capacity decisions for its rows.  (A prefill wave routes each rank's
rows apart, as training does.)

An RWKV-6 (``r``) layer caches O(1) state a slot instead of positions:
``{"s" [.., B, H, N, N] float32, "x_tm" [.., B, d], "x_cm" [.., B, d]}``
(the WKV state and the time and channel mixes' last inputs, in the
activation dtype), updated in place by `models/rwkv6.py`'s recurrent
step.  Under ``"batch"`` a rank holds its slots' states; under ``"seq"``
every rank holds every slot's whole state and computes the same update
(the reference's spec with no batch axes).  The packed forward does not
expose the state, so `make_prefill_kv_step` refuses an ``r`` pattern, as
the reference's does, and such a model decodes from an empty state.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ring as R
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as RW
from repro_torch.models.transformer import (_ffn_block, _index,
                                            apply_periods, check_supported,
                                            embed_frontend, embed_tokens,
                                            forward_hidden, head_layer_count,
                                            logits_head,
                                            require_attention_only)
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
    """One rank's shard of a ``[batch, length]`` decode slab: slots
    ``[slot0, slot0 + slots)`` at cache positions ``[base, base +
    positions)``.  One rank holds the whole slab."""
    layout: str
    slots: int
    slot0: int
    positions: int
    base: int
    length: int

    def owns(self, slot, pos):
        """Whether (global) ``slot`` and cache position ``pos`` lie in this
        shard; numpy or torch, elementwise."""
        return ((slot >= self.slot0) & (slot < self.slot0 + self.slots)
                & (pos >= self.base) & (pos < self.base + self.positions))


def layer_cache_len(cfg: ModelConfig, layer_idx: int, seq_len: int) -> int:
    """Cache positions of one layer: ``seq_len``, or a local layer's
    ring buffer of ``min(window, seq_len)`` (the reference's
    ``_layer_cache_len``)."""
    if cfg.layer_code(layer_idx) == "l" and cfg.window:
        return min(cfg.window, seq_len)
    return seq_len


def refuse_tensor_parallel(rt: Runtime) -> None:
    """Serving runs at tp = 1: tensor-parallel serving waits in ROADMAP
    queue 1 item 7b-iii."""
    if rt.tp > 1:
        raise NotImplementedError(
            f"serving at tp {rt.tp}: tensor-parallel serving waits in "
            f"ROADMAP queue 1 item 7b-iii (TP serving)")


def layer_shards(cfg: ModelConfig, rt: Runtime, batch: int,
                 seq_len: int) -> dict:
    """{"head_layers": [SlabShard per head layer], "blocks": [SlabShard
    per pattern position]}: this rank's shard of each layer's cache."""
    refuse_tensor_parallel(rt)
    head_n = head_layer_count(cfg)

    def shard(i):
        return slab_shard(rt, batch, layer_cache_len(cfg, i, seq_len))

    return {"head_layers": [shard(i) for i in range(head_n)],
            "blocks": [shard(head_n + j)
                       for j in range(len(cfg.layer_pattern))]}


def slab_shard(rt: Runtime, batch: int, seq_len: int) -> SlabShard:
    hdp = rt.hdp_size
    rank = 0 if rt.comm is None else rt.comm.rank
    layout = decode_layout(batch, hdp)
    if layout == "batch":
        n = batch // hdp
        return SlabShard(layout, n, rank * n, seq_len, 0, seq_len)
    if seq_len % hdp:
        raise ValueError(
            f"{batch} slots do not tile {hdp} HDP ranks, so the decode slab "
            f"splits its {seq_len} cache positions over them, which needs "
            f"seq_len % hdp == 0")
    n = seq_len // hdp
    return SlabShard(layout, batch, 0, n, rank * n, seq_len)


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, rt: Runtime, sh: SlabShard, code: str,
                 lead=()) -> dict:
    dt = L.activation_dtype(cfg)
    if code == "r":
        n = cfg.rwkv.head_size
        row = (*lead, sh.slots, cfg.d_model)
        return {"s": torch.zeros((*lead, sh.slots, cfg.d_model // n, n, n),
                                 dtype=torch.float32, device=rt.device),
                "x_tm": torch.zeros(row, dtype=dt, device=rt.device),
                "x_cm": torch.zeros(row, dtype=dt, device=rt.device)}
    if cfg.mla is not None:
        m = cfg.mla
        shape = (*lead, sh.slots, sh.positions, 1,
                 m.kv_lora_rank + m.qk_rope_dim)
        return {"kv_lat": torch.zeros(shape, dtype=dt, device=rt.device)}
    shape = (*lead, sh.slots, sh.positions, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=rt.device),
            "v": torch.zeros(shape, dtype=dt, device=rt.device)}


def init_decode_cache(cfg: ModelConfig, rt: Runtime, batch: int,
                      seq_len: int) -> dict:
    """This rank's shard (`layer_shards`) of a ``batch``-slot slab of
    ``seq_len`` positions: the whole slab on one rank."""
    check_supported(cfg)
    shards = layer_shards(cfg, rt, batch, seq_len)
    head_n = head_layer_count(cfg)
    n_periods = (cfg.num_layers - head_n) // len(cfg.layer_pattern)
    return {
        "head_layers": [_layer_cache(cfg, rt, sh, cfg.layer_code(i))
                        for i, sh in enumerate(shards["head_layers"])],
        "blocks": [_layer_cache(cfg, rt, sh, cfg.layer_code(head_n + j),
                                lead=(n_periods,))
                   for j, sh in enumerate(shards["blocks"])],
    }


def cache_bytes(cache: dict) -> int:
    return sum(buf.numel() * buf.element_size()
               for layer in cache["head_layers"] + cache["blocks"]
               for buf in layer.values())


# ---------------------------------------------------------------------------
# decode blocks
# ---------------------------------------------------------------------------

def _write_rows(bufs, news, pos, sh: SlabShard) -> None:
    """Write each slot's new row of every cache buffer of one layer at
    cache position ``pos % S_l``, in place.  Under ``"seq"`` every rank
    runs every slot and only the one holding the position changes its row
    (the others write back what they hold)."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    local = pos % sh.length
    if sh.layout == "seq":
        local = local - sh.base
        own = (local >= 0) & (local < sh.positions)
        local = local.clamp(0, sh.positions - 1)
    for buf, new in zip(bufs, news):
        new = new.to(buf.dtype)
        if sh.layout == "seq":
            new = torch.where(own.view(-1, *[1] * (new.dim() - 1)), new,
                              buf[rows, local])
        buf[rows, local] = new


def _decode_attention(bp, cache, cfg: ModelConfig, rt: Runtime, x, pos,
                      sh: SlabShard):
    """``pos`` [B]: each slot decodes at its own depth; its new K/V row
    lands at cache position ``pos % S_l`` of that slot (``sh`` is this
    rank's shard of the layer's ``S_l`` positions), written into ``cache``
    in place by the rank whose shard holds it, and attention reads the
    ``min(pos + 1, S_l)`` filled positions.  A local layer's ring buffer
    wraps there; as in the reference, so does a global layer at a position
    past the slab (a free slot whose last request filled its context).
    An MLA layer writes its latent row and attends every head to the
    cached latents, values their first kv_lora_rank columns."""
    b = x.shape[0]
    filled = (pos + 1).clamp(max=sh.length)
    comm = rt.comm if sh.layout == "seq" else None
    if cfg.mla is not None:
        q_eff, kv_eff = MLA.mla_qkv(bp, cfg, x, pos)   # [B,H,576], [B,1,576]
        kv_cache = cache["kv_lat"]
        _write_rows([kv_cache], [kv_eff], pos, sh)
        out = R.decode_attention_sharded(
            q_eff[:, None], kv_cache, kv_cache[..., :cfg.mla.kv_lora_rank],
            filled, comm=comm, base=sh.base, scale=MLA.mla_scale(cfg),
            softcap=cfg.attn_softcap)
        return MLA.mla_output(bp, cfg, out[:, 0])
    layout = rt.layout(cfg)
    dk = cfg.resolved_head_dim
    g = cfg.num_kv_heads
    q = (x @ bp["w_q"]).reshape(b, layout.h_pad, dk)
    kv = torch.einsum("bd,dsgk->bsgk", x, bp["w_kv"])
    k_new, v_new = kv[:, 0], kv[:, 1]
    if cfg.qk_norm:
        q = L.qk_head_norm(bp["q_norm"], q, cfg.norm_eps)
        k_new = L.qk_head_norm(bp["k_norm"], k_new, cfg.norm_eps)
    q, k_new = L.positional_rotate(cfg, q, k_new, pos, pos)
    k_cache, v_cache = cache["k"], cache["v"]
    _write_rows([k_cache, v_cache], [k_new, v_new], pos, sh)
    qg = q.reshape(b, g, layout.hpg_pad, dk)
    out = R.decode_attention_sharded(
        qg, k_cache, v_cache, filled, comm=comm, base=sh.base,
        scale=dk ** -0.5, softcap=cfg.attn_softcap)
    out = out.reshape(b, layout.h_pad, dk)
    if layout.pad_heads:
        out = out * layout.head_mask(x.device)[None, :, None].to(out.dtype)
    return out.reshape(b, -1) @ bp["w_o"]


def _decode_block(bp, cache, cfg: ModelConfig, rt: Runtime, x, pos,
                  sh: SlabShard):
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if "time_mix" in bp:
        h, st = RW.rwkv_decode_step(bp["time_mix"], cfg, h,
                                    {"s": cache["s"], "x_tm": cache["x_tm"]})
        cache["s"].copy_(st["s"])
        cache["x_tm"].copy_(st["x_tm"])
    else:
        h = _decode_attention(bp["attn"], cache, cfg, rt, h, pos, sh)
    if cfg.post_block_norm:
        h = L.rmsnorm(bp["postnorm1"], h, cfg.norm_eps)
    x = x + h.to(x.dtype)
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    if "channel_mix" in bp:
        hn = h
        h = RW.rwkv_decode_channel_mix(bp["channel_mix"], hn, cache["x_cm"])
        cache["x_cm"].copy_(hn)                  # the normed input, for t+1
    elif "moe" in bp:
        h = _decode_moe(bp["moe"], cfg, rt, h, sh)
    else:
        h = _ffn_block(bp["mlp"], cfg, h)
    if cfg.post_block_norm:
        h = L.rmsnorm(bp["postnorm2"], h, cfg.norm_eps)
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
    shards = layer_shards(cfg, rt, batch, seq_len)
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
                              shards["head_layers"][i])
        n_periods = params["blocks"][0]["norm1"]["scale"].shape[0]
        for i in range(n_periods):
            for j in range(period):
                # the period's cache views alias the stacked slab
                x = _decode_block(_index(params["blocks"][j], i),
                                  _index(cache["blocks"][j], i), cfg, rt, x,
                                  pos, shards["blocks"][j])
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return logits_head(params, cfg, x), cache

    return decode_step


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, rt: Runtime):
    refuse_tensor_parallel(rt)

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
    [T, G, Dk] rows (MLA: {"kv_lat"} [T, 1, kv_lora+rope]) and
    ``block_kv`` a tuple (per pattern position) of the same stacked
    [n_periods, T, ...] — the `init_decode_cache` layout minus the batch
    dim.  An RWKV pattern raises: the packed forward does not expose the
    recurrent state, as in the reference."""
    check_supported(cfg)
    require_attention_only(cfg, "prefill KV capture")
    refuse_tensor_parallel(rt)
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
             for name in per_period[0][j]}
            for j in range(period))
        return x, head_kv, block_kv

    return prefill_kv
