"""Decoder LM over packed token buffers: dense and Mixture-of-Experts.

Port of `repro/models/transformer.py` for the serving and training
slices: token frontend, RMSNorm, GQA attention with RoPE over packed
segments, a gated or plain MLP or a capacity-bounded MoE per layer
(`models/moe.py`), tied or untied logits.  Activations are flat packed
buffers [T, d]; every token carries (segment_id, position).  Parameters
keep the reference's tree and layouts, so a JAX parameter tree bridges by
a plain copy (`repro_torch.bridge`):

    embed [V, d]; head_blocks: one un-stacked block per leading dense
    layer (``moe.first_k_dense``); final_norm {scale [d] f32};
    blocks: one dict per layer-pattern position, every leaf stacked
    [n_periods, ...]: norm1/norm2 {scale}, attn {w_q [d, h*Dk],
    w_kv [d, 2, G, Dk], w_o [h*Dk, d]}, and mlp {w_in, w_gate, w_out}
    or moe {router [d, E] f32, w_in, w_gate [E, d, f], w_out [E, f, d],
    shared_*}.

Dense weights are [in, out] and used as ``x @ W``.  MLA, SSM mixers,
non-token frontends and the Gemma-style extras (window, softcaps,
post-block norms, embedding scale, q/k norms) are later slices and raise
`NotImplementedError`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ring as R
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.parallel.sharding import Runtime, resolve_device
from repro_torch.tree import leaves, tree_map


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    missing = []
    if set(cfg.layer_pattern) - {"g"}:
        missing.append(f"layer pattern {cfg.layer_pattern!r}")
    for name in ("mla", "rwkv", "mamba"):
        if getattr(cfg, name) is not None:
            missing.append(name)
    if cfg.frontend != "none":
        missing.append(f"frontend {cfg.frontend!r}")
    if cfg.pos_embed not in ("rope", "none"):
        missing.append(f"pos_embed {cfg.pos_embed!r}")
    for flag in ("window", "attn_softcap", "final_softcap", "qk_norm",
                 "embed_scale", "post_block_norm"):
        if getattr(cfg, flag):
            missing.append(flag)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port runs "
            f"global-attention decoders, dense or MoE, with a token "
            f"frontend)")


def head_layer_count(cfg: ModelConfig) -> int:
    """Leading layers kept outside the stacked periods (the dense head
    of an MoE model, ``moe.first_k_dense``); zero for a dense model."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_init(gen, cfg: ModelConfig, layout, dtype, device) -> dict:
    d = cfg.d_model
    dk = cfg.resolved_head_dim
    g = cfg.num_kv_heads
    return {
        "w_q": L.dense_init(gen, d, layout.h_pad * dk, dtype, device),
        "w_kv": L.normal(gen, (d, 2, g, dk), 1.0 / math.sqrt(d), dtype,
                         device),
        "w_o": L.dense_init(gen, layout.h_pad * dk, d, dtype, device),
    }


def _mlp_init(gen, cfg: ModelConfig, d_ff: int, dtype, device) -> dict:
    p = {"w_in": L.dense_init(gen, cfg.d_model, d_ff, dtype, device),
         "w_out": L.dense_init(gen, d_ff, cfg.d_model, dtype, device)}
    if cfg.gated_mlp:
        p["w_gate"] = L.dense_init(gen, cfg.d_model, d_ff, dtype, device)
    return p


def _block_init(gen, cfg: ModelConfig, layer_idx: int, layout, dtype,
                device) -> dict:
    p = {"norm1": L.rmsnorm_init(cfg.d_model, device),
         "norm2": L.rmsnorm_init(cfg.d_model, device),
         "attn": _attn_init(gen, cfg, layout, dtype, device)}
    if cfg.is_moe_layer(layer_idx):
        p["moe"] = MOE.moe_init(gen, cfg, dtype, device)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.dense_d_ff:
            d_ff = cfg.moe.dense_d_ff
        p["mlp"] = _mlp_init(gen, cfg, d_ff, dtype, device)
    return p


def _stack_into(out, tree, i: int, n: int):
    """Copy ``tree`` into period ``i`` of the stacked ``out`` ([n, ...]
    leaves, allocated at i == 0) -> out."""
    if isinstance(tree, dict):
        out = {} if out is None else out
        for k, v in tree.items():
            out[k] = _stack_into(out.get(k), v, i, n)
        return out
    if out is None:
        out = tree.new_empty((n, *tree.shape))
    out[i].copy_(tree)
    return out


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (default ``cuda``; raises without one unless
    ``device="cpu"``).  Same tree, shapes and distributions as the
    reference: dense N(0,1)/sqrt(in), embeddings N(0,1)*0.02, norm scales
    zero (the (1 + scale) form).  The draws differ from ``jax.random``."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = L.activation_dtype(cfg)
    layout = L.gqa_layout(cfg.num_heads, cfg.num_kv_heads, 1)
    period = len(cfg.layer_pattern)
    head_n = head_layer_count(cfg)
    if (cfg.num_layers - head_n) % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers - head_n} stacked "
                         f"layers are no whole number of {period}-layer "
                         f"periods")
    n_periods = (cfg.num_layers - head_n) // period
    params: dict = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                              device),
        "head_blocks": [_block_init(gen, cfg, i, layout, dtype, device)
                        for i in range(head_n)],
    }
    blocks = []
    for j in range(period):
        # one period's block at a time into the stacked leaves, so the
        # init holds the stack and one block, never two stacks
        stacked = None
        for p in range(n_periods):
            stacked = _stack_into(
                stacked, _block_init(gen, cfg, head_n + p * period + j,
                                     layout, dtype, device), p, n_periods)
        blocks.append(stacked)
    params["blocks"] = blocks
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype, device)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attention_block(bp, cfg: ModelConfig, rt: Runtime, x, seg, pos,
                     window: int, collect: Optional[list] = None):
    """``collect`` (serving): a list the block appends its post-rotation
    per-token cache rows ``{"k", "v"}`` [T, G, Dk] to, in the layout the
    decode cache stores per position."""
    t = x.shape[0]
    pos_s = L.scalar_positions(cfg, pos)
    layout = rt.layout(cfg)
    dk = cfg.resolved_head_dim
    q = (x @ bp["w_q"]).reshape(t, layout.h_pad, dk)
    kv = torch.einsum("td,dsgk->tsgk", x, bp["w_kv"])       # [T, 2, G, Dk]
    k, v = kv[:, 0], kv[:, 1]
    q, k = L.positional_rotate(cfg, q, k, pos, pos)
    if collect is not None:
        collect.append({"k": k, "v": v})
    out = R.ring_attention(
        q, k, v, seg, seg, pos_s, pos_s,
        composition=rt.composition, kv_sharded=layout.kv_sharded,
        kv_group_of_head=(None if layout.kv_sharded
                          else layout.group_of_head(x.device)),
        scale=dk ** -0.5, window=window, softcap=cfg.attn_softcap,
        kv_chunk=rt.kv_chunk, block_skip=rt.block_skip,
        attn_impl=rt.attn_impl, block_q=rt.attn_block_q,
        block_k=rt.attn_block_k, comm=rt.comm)
    if layout.pad_heads:
        out = out * layout.head_mask(x.device)[None, :, None].to(out.dtype)
    return out.reshape(t, -1) @ bp["w_o"]


def _ffn_block(bp, cfg: ModelConfig, x):
    act = L.act_fn(cfg.act)
    h = x @ bp["w_in"]
    if cfg.gated_mlp:
        h = act(x @ bp["w_gate"]) * h
    else:
        h = act(h)
    return h @ bp["w_out"]


def _moe_block(bp, cfg: ModelConfig, rt: Runtime, x):
    """This rank's rows route as one group.  The reference reshapes the
    wave's [T, d] to [hdp, T/hdp, d] and routes each HDP rank's rows
    apart; rank r of the port holds rows [r·C, (r+1)·C) of the wave, so
    its rows are that group, padding rows included.  At tp = 1 the
    reference's expert-parallel route (``moe_impl="manual"``) holds every
    expert locally and computes the same."""
    return MOE.moe_forward(bp, cfg, x)


def block_forward(bp, cfg: ModelConfig, rt: Runtime, x, seg, pos,
                  layer_idx: int, collect: Optional[list] = None):
    code = cfg.layer_code(layer_idx)
    if code != "g":
        raise NotImplementedError(f"layer code {code!r} not ported yet")
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    h = _attention_block(bp["attn"], cfg, rt, h, seg, pos, 0,
                         collect=collect)
    x = x + h.to(x.dtype)
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    if "moe" in bp:
        h = _moe_block(bp["moe"], cfg, rt, h)
    else:
        h = _ffn_block(bp["mlp"], cfg, h)
    return x + h.to(x.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"].index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, cfg.d_model)


def embed_frontend(params, cfg: ModelConfig, rt: Runtime, batch,
                   collect: Optional[list] = None) -> torch.Tensor:
    """Token frontend + the un-stacked head blocks.  ``collect``:
    per-head-block KV capture for serving (see `_attention_block`)."""
    check_supported(cfg)
    seg, pos = batch["seg"], batch["pos"]
    x = embed_tokens(params, cfg, batch["tokens"])
    for i, bp in enumerate(params["head_blocks"]):
        x = block_forward(bp, cfg, rt, x, seg, pos, i, collect=collect)
    return x


def apply_periods(blocks, cfg: ModelConfig, rt: Runtime, x, seg, pos,
                  collect: Optional[list] = None):
    """Run the stacked layer periods over the residual stream, one Python
    iteration per period.  ``collect`` receives one list per period of the
    per-position KV rows.

    With ``rt.remat != "none"`` and grad enabled, each period is a
    `_Period` node (the reference's per-period ``jax.checkpoint``): only
    its input residual is kept and the backward recomputes the period.
    The stacked params are unbound once per call, so the backward stacks
    each leaf's per-period grads in one copy instead of scattering every
    period into a full-size zero tensor.

    With ``rt.remat == "offload"`` (the reference's offload branch) the
    first ``k = min(offload_periods, n_periods)`` periods keep that input
    in host memory (``rt.offload_store``, `parallel/host_offload.py`,
    which k > 0 needs); the rest keep it on the device, as ``"full"``
    does.  At ``offload_periods = 0`` the route is ``"full"``'s."""
    period = len(cfg.layer_pattern)
    head_n = head_layer_count(cfg)
    layers = [_unstack(b) for b in blocks]          # [position][period]
    n = len(layers[0])
    remat = (rt.remat != "none" and torch.is_grad_enabled()
             and collect is None)
    k = min(rt.offload_periods, n) if remat and rt.remat == "offload" else 0
    store = rt.offload_store
    if k:
        if store is None:
            raise ValueError(
                f"remat='offload' with offload_periods={k} needs "
                f"rt.offload_store (a parallel.host_offload.HostOffload)")
        store.begin()

    def period_body(x, ps, kvs):
        for j in range(period):
            x = block_forward(ps[j], cfg, rt, x, seg, pos, head_n + j,
                              collect=kvs)
        return x

    for i in range(n):
        ps = [layers[j][i] for j in range(period)]
        if remat:
            x = _Period.apply(period_body, ps, i, k, store, x, *leaves(ps))
            continue
        kvs = None if collect is None else []
        x = period_body(x, ps, kvs)
        if collect is not None:
            collect.append(kvs)
    return x


class _Period(torch.autograd.Function):
    """One layer period under remat: the forward runs it without a graph
    and keeps its input, in host memory for the first k periods
    (`HostOffload.save`, the copy overlapping the period) and on the
    device for the rest; the backward first starts bringing back the
    input of the period before it (one period ahead, FILO), then
    recomputes this period from its input under grad and differentiates
    it.  The weights are inputs of the node, so their grads flow on into
    the unbind of the stacked params."""

    @staticmethod
    def forward(ctx, body, ps, i, k, store, x, *weights):
        ctx.body, ctx.ps, ctx.i, ctx.k, ctx.store = body, ps, i, k, store
        if i >= k:
            ctx.save_for_backward(x, *weights)
            return body(x, ps, None)
        store.save(i, x)
        ctx.save_for_backward(*weights)
        y = body(x, ps, None)
        store.release(i)
        return y

    @staticmethod
    def backward(ctx, gy):
        i, k, store = ctx.i, ctx.k, ctx.store
        if i < k:              # started by period i + 1, unless i = n - 1
            store.prefetch(i)
        if 0 < i <= k:         # the next input the backward needs
            store.prefetch(i - 1)
        if i < k:
            x, weights = store.load(i), ctx.saved_tensors
        else:
            x, *weights = ctx.saved_tensors
        x = x.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in weights]
        it = iter(ws)
        ps = tree_map(lambda _: next(it), ctx.ps)
        with torch.enable_grad():
            y = ctx.body(x, ps, None)
        grads = torch.autograd.grad(y, [x, *ws], gy)
        return (None, None, None, None, None, *grads)


def _unstack(tree) -> list:
    """Stacked [n, ...] tree -> list of n per-period trees (views)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def forward_hidden(params, cfg: ModelConfig, rt: Runtime,
                   batch) -> torch.Tensor:
    """batch: {"tokens" [T], "seg" [T], "pos" [T]} (int32 tensors on the
    runtime's device) -> final hidden [T, d].  Over several HDP ranks
    (``rt.comm``) every rank calls it on its own slice of the wave, rows
    [r·C, (r+1)·C) of `data.loader.WaveMaterializer`'s buffers, and the
    attention rings exchange KV blocks within each group of
    ``rt.composition``."""
    x = embed_frontend(params, cfg, rt, batch)
    x = apply_periods(params["blocks"], cfg, rt, x, batch["seg"],
                      batch["pos"])
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def logits_head(params, cfg: ModelConfig, hidden):
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ w.to(hidden.dtype)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
