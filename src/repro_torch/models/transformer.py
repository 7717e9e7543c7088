"""Decoder LM over packed token buffers: dense and Mixture-of-Experts.

Port of `repro/models/transformer.py` for the serving and training
slices: token frontend, RMSNorm, GQA attention with RoPE over packed
segments, global (``g``) or sliding-window local (``l``) layers, a gated
or plain MLP or a capacity-bounded MoE per layer (`models/moe.py`), tied
or untied logits; and the Gemma-style flags: attention and final logit
softcaps, post-block norms, the sqrt(d_model) embedding scale and per-head
q/k norms; and DeepSeek-V2's Multi-head Latent Attention (``cfg.mla``,
`models/mla.py`) in place of GQA.  Activations are flat packed
buffers [T, d]; every token carries (segment_id, position).  Parameters
keep the reference's tree and layouts, so a JAX parameter tree bridges by
a plain copy (`repro_torch.bridge`):

    embed [V, d]; head_blocks: one un-stacked block per leading dense
    layer (``moe.first_k_dense``); final_norm {scale [d] f32};
    blocks: one dict per layer-pattern position, every leaf stacked
    [n_periods, ...]: norm1/norm2 {scale}, attn {w_q [d, h*Dk],
    w_kv [d, 2, G, Dk], w_o [h*Dk, d], and with ``qk_norm`` q_norm/k_norm
    [Dk] f32} (with ``mla``: w_q, w_dkv, latent_norm {scale}, w_uk, w_uv,
    w_o, `models/mla.py`), mlp {w_in, w_gate, w_out} or moe {router
    [d, E] f32, w_in, w_gate [E, d, f], w_out [E, f, d], shared_*}, and
    with ``post_block_norm`` postnorm1/postnorm2 {scale}.

An ``r`` layer is RWKV-6 (`models/rwkv6.py`): its blocks hold time_mix
and channel_mix (leaves listed there) in place of attn and mlp, and a
sequence sharded over HDP ranks is relayed across them by `_ssm_block`.

Dense weights are [in, out] and used as ``x @ W``.  Mamba, non-token
frontends and M-RoPE are later slices and raise `NotImplementedError`.

Under tensor parallelism (``rt.tp > 1``; every attention decoder, GQA or
MLA, dense or MoE, with the Gemma flags) each model rank holds its slice
of the split leaves (`parallel/sharding.py::tp_split_dim`) and runs its
h_pad/tp heads (MLA: H/tp heads over the whole latent), its columns of
the MLP, its experts (`models/moe.py`) and its rows of
the vocabulary: the column-parallel products take their input through
`parallel/tensor.py::copy_to_model`, the row-parallel ones and the
embedding lookup give theirs through ``reduce_from_model``, and
`logits_head` gives this rank's vocabulary columns (the loss combines
them, `core/loss.py`).  A replicated leaf that only this rank's heads use
(q/k norms; MLA's ``w_dkv`` and latent norm; a replicated ``w_kv``) goes
through `copy_to_model`, so its gradient sums the ranks' heads; one used
on the replicated stream (the block norms, post-block norms, final norm)
gets its whole gradient on every rank.  Local windows and both softcaps
act within a rank's heads or vocabulary columns and need no collective.
An RWKV-6 layer runs its H/tp WKV heads (`models/rwkv6.py`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ring as R
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as RW
from repro_torch.parallel.sharding import (TP_LATER, Runtime,
                                           check_tp_divides, resolve_device,
                                           shard_param, tp_split_dim)
from repro_torch.parallel.tensor import copy_to_model, reduce_from_model
from repro_torch.tree import leaf_paths, leaves, tree_map


def check_supported(cfg: ModelConfig, tp: int = 1) -> None:
    """Raise NotImplementedError for what the port does not run yet; at
    ``tp > 1`` also for Mamba and the non-token frontends
    (`_check_tensor_parallel`)."""
    if tp > 1:
        _check_tensor_parallel(cfg, tp)
    missing = []
    if set(cfg.layer_pattern) - {"g", "l", "r"}:
        missing.append(f"layer pattern {cfg.layer_pattern!r} (the mamba "
                       f"mixer 'm' waits for ROADMAP queue 1 item 8)")
    if "r" in cfg.layer_pattern and cfg.rwkv is None:
        missing.append("an 'r' layer without an RWKVSpec")
    if cfg.mamba is not None:
        missing.append("mamba (queue 1 item 8)")
    if cfg.frontend != "none":
        missing.append(f"frontend {cfg.frontend!r} (the embeds frontends "
                       f"of queue 1 item 8)")
    if cfg.pos_embed not in ("rope", "none"):
        missing.append(f"pos_embed {cfg.pos_embed!r} (M-RoPE, queue 1 "
                       f"item 8)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port runs "
            f"attention decoders, GQA or MLA, with global and local layers, "
            f"dense or MoE, and RWKV-6, with a token frontend)")


def _check_tensor_parallel(cfg: ModelConfig, tp: int) -> None:
    """Tensor parallelism runs the attention decoders (GQA or MLA, dense or
    MoE, global and local layers, the Gemma flags) and RWKV-6: Mamba and
    the non-token frontends raise NotImplementedError naming the queue
    item that brings them, and a vocabulary, expert count, MLA or WKV head
    count or dense width that tp does not divide raises ValueError
    (`check_tp_divides`)."""
    flags = {"mamba": "m" in cfg.layer_pattern or cfg.mamba is not None,
             f"frontend {cfg.frontend!r}": cfg.frontend != "none"}
    missing = [k for k, v in flags.items() if v]
    if missing:
        raise NotImplementedError(
            f"{cfg.name} at tp {tp}: {', '.join(missing)} under tensor "
            f"parallelism come with {TP_LATER}")
    check_tp_divides(cfg, tp)


def require_attention_only(cfg: ModelConfig, what: str) -> None:
    """Raise NotImplementedError unless every layer attends: ``what``
    (serving, prefill KV capture) cannot capture a recurrent layer's
    state from the packed forward, as in the reference."""
    if not set(cfg.layer_pattern) <= {"g", "l"}:
        raise NotImplementedError(
            f"{what} needs an attention-only layer pattern, got "
            f"{cfg.layer_pattern!r}")


def head_layer_count(cfg: ModelConfig) -> int:
    """Leading layers kept outside the stacked periods (the dense head
    of an MoE model, ``moe.first_k_dense``); zero for a dense model."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_init(gen, cfg: ModelConfig, layout, dtype, device) -> dict:
    if cfg.mla is not None:
        return MLA.mla_init(gen, cfg, dtype, device)
    d = cfg.d_model
    dk = cfg.resolved_head_dim
    g = cfg.num_kv_heads
    p = {
        "w_q": L.dense_init(gen, d, layout.h_pad * dk, dtype, device),
        "w_kv": L.normal(gen, (d, 2, g, dk), 1.0 / math.sqrt(d), dtype,
                         device),
        "w_o": L.dense_init(gen, layout.h_pad * dk, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(dk, dtype=torch.float32, device=device)
        p["k_norm"] = torch.zeros(dk, dtype=torch.float32, device=device)
    return p


def _mlp_init(gen, cfg: ModelConfig, d_ff: int, dtype, device) -> dict:
    p = {"w_in": L.dense_init(gen, cfg.d_model, d_ff, dtype, device),
         "w_out": L.dense_init(gen, d_ff, cfg.d_model, dtype, device)}
    if cfg.gated_mlp:
        p["w_gate"] = L.dense_init(gen, cfg.d_model, d_ff, dtype, device)
    return p


def _block_init(gen, cfg: ModelConfig, layer_idx: int, layout, dtype,
                device) -> dict:
    p = {"norm1": L.rmsnorm_init(cfg.d_model, device),
         "norm2": L.rmsnorm_init(cfg.d_model, device)}
    if cfg.layer_code(layer_idx) == "r":
        p["time_mix"] = RW.rwkv_init(gen, cfg, dtype, device)
        p["channel_mix"] = RW.channel_mix_init(gen, cfg, dtype, device)
    else:
        p["attn"] = _attn_init(gen, cfg, layout, dtype, device)
        if cfg.is_moe_layer(layer_idx):
            p["moe"] = MOE.moe_init(gen, cfg, dtype, device)
        else:
            d_ff = cfg.d_ff
            if cfg.moe is not None and cfg.moe.dense_d_ff:
                d_ff = cfg.moe.dense_d_ff
            p["mlp"] = _mlp_init(gen, cfg, d_ff, dtype, device)
    if cfg.post_block_norm:
        p["postnorm1"] = L.rmsnorm_init(cfg.d_model, device)
        p["postnorm2"] = L.rmsnorm_init(cfg.d_model, device)
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


def stage_periods(n_periods: int, stage=(0, 1)) -> range:
    """The periods of stage ``s`` of ``S`` (``stage = (s, S)``): its
    contiguous window ``[s·n/S, (s+1)·n/S)``, the reference's stage
    sharding of the stacked leaves' dim 0."""
    s, num = stage
    if n_periods % num:
        raise ValueError(f"{n_periods} scan periods do not split into "
                         f"{num} equal pipeline stages")
    w = n_periods // num
    return range(s * w, (s + 1) * w)


def _model_slice(tree, prefix: tuple, kv_sharded: bool, model):
    """This model rank's slices (``model = (m, tp)``) of a drawn global
    (sub)tree whose leaves sit at ``prefix`` + their path, as copies."""
    m, tp = model
    if tp == 1:
        return tree
    got = iter([shard_param(x, tp_split_dim(prefix + path, x.dim(),
                                            kv_sharded), m, tp).clone()
                for path, x in leaf_paths(tree)])
    return tree_map(lambda _: next(got), tree)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                stage=(0, 1), model=(0, 1)) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (default ``cuda``; raises without one unless
    ``device="cpu"``).  Same tree, shapes and distributions as the
    reference: dense N(0,1)/sqrt(in), embeddings N(0,1)*0.02, norm scales
    zero (the (1 + scale) form).  The draws differ from ``jax.random``.

    ``stage = (s, S)``: pipeline stage s of S holds its window of the
    stacked periods (`stage_periods`) and the whole replicated leaves.
    Every period is drawn in the same order as the full init and those
    outside the window are dropped, so the window equals the same rows of
    the full init.

    ``model = (m, tp)``: model rank m of tp holds its slice of every split
    leaf (`parallel/sharding.py::tp_split_dim`) of the global tree in the
    reference's layout at that tp (q heads padded to its ``h_pad``).  The
    global tree is drawn in the same order and each leaf sliced as it is
    drawn, so a seed gives the same model at every tp with the same
    ``h_pad``."""
    check_supported(cfg, model[1])
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = L.activation_dtype(cfg)
    layout = L.gqa_layout(cfg.num_heads, cfg.num_kv_heads, model[1])
    kvs = layout.kv_sharded

    def block(i):
        return _model_slice(_block_init(gen, cfg, i, layout, dtype, device),
                            ("layer",), kvs, model)
    period = len(cfg.layer_pattern)
    head_n = head_layer_count(cfg)
    if (cfg.num_layers - head_n) % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers - head_n} stacked "
                         f"layers are no whole number of {period}-layer "
                         f"periods")
    n_periods = (cfg.num_layers - head_n) // period
    params: dict = {
        "embed": _model_slice(L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                           dtype, device), ("embed",), kvs,
                              model),
        "head_blocks": [block(i) for i in range(head_n)],
    }
    window = stage_periods(n_periods, stage)
    blocks = []
    for j in range(period):
        # one period's block at a time into the stacked leaves, so the
        # init holds the stack and one block, never two stacks
        stacked = None
        for p in range(n_periods):
            drawn = block(head_n + p * period + j)
            if p in window:
                stacked = _stack_into(stacked, drawn, p - window.start,
                                      len(window))
        blocks.append(stacked)
    params["blocks"] = blocks
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = _model_slice(
            L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, device),
            ("lm_head",), kvs, model)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attention_block(bp, cfg: ModelConfig, rt: Runtime, x, seg, pos,
                     window: int, collect: Optional[list] = None):
    """``collect`` (serving): a list the block appends its post-rotation
    per-token cache rows to, ``{"k", "v"}`` [T, G, Dk] or the MLA latent
    ``{"kv_lat"}`` [T, 1, kv_lora+rope], in the layout the decode cache
    stores per position.

    MLA runs the reference's gather mode: every (padded) head takes the one
    latent as its KV (``kv_group_of_head`` zeros), and v is the latent's
    first kv_lora_rank columns (``v_in_k``).  Under tensor parallelism a
    rank runs its H/tp heads over the whole latent, whose replicated
    ``w_dkv`` and latent norm take their gradients through
    `copy_to_model`, and its rows of ``w_o`` give a partial output.

    Model rank m of tp runs the heads [m·hpl, (m+1)·hpl), hpl = h_pad/tp:
    with KV sharded its own KV groups, else the whole (replicated) KV
    through its heads' slice of ``kv_group_of_head`` (the replicated
    ``w_kv`` takes ``x`` through `copy_to_model`, so its gradient sums the
    ranks' heads).  Its rows of ``w_o`` give a partial output, summed over
    the model group."""
    t = x.shape[0]
    pos_s = L.scalar_positions(cfg, pos)
    layout = rt.layout(cfg)
    comm = rt.tp_comm
    hpl = layout.h_pad // rt.tp
    x = copy_to_model(x, comm)
    if cfg.mla is not None:
        # the latent is whole on every rank and used by this rank's heads
        # only: its two leaves sum their gradients over the group
        lat = {**bp, "w_dkv": copy_to_model(bp["w_dkv"], comm),
               "latent_norm": {"scale": copy_to_model(
                   bp["latent_norm"]["scale"], comm)}}
        q_eff, kv_eff = MLA.mla_qkv(lat, cfg, x, pos_s)
        if collect is not None:
            collect.append({"kv_lat": kv_eff})
        hq = q_eff.shape[1]                          # this rank's heads
        if hq < hpl:                                 # pad heads to tp
            q_eff = torch.nn.functional.pad(q_eff, (0, 0, 0, hpl - hq))
        out = R.ring_attention(
            q_eff, kv_eff, None, seg, seg, pos_s, pos_s,
            composition=rt.composition, kv_sharded=False,
            kv_group_of_head=torch.zeros(hpl, dtype=torch.int64,
                                         device=x.device),
            scale=MLA.mla_scale(cfg), window=window,
            softcap=cfg.attn_softcap, kv_chunk=rt.kv_chunk,
            block_skip=rt.block_skip, attn_impl=rt.attn_impl,
            v_in_k=(0, cfg.mla.kv_lora_rank), block_q=rt.attn_block_q,
            block_k=rt.attn_block_k, comm=rt.comm)
        return reduce_from_model(MLA.mla_output(bp, cfg, out[:, :hq]), comm)
    dk = cfg.resolved_head_dim
    heads = slice(rt.model_rank * hpl, (rt.model_rank + 1) * hpl)
    w_kv = bp["w_kv"] if layout.kv_sharded else copy_to_model(bp["w_kv"],
                                                              comm)
    q = (x @ bp["w_q"]).reshape(t, hpl, dk)
    kv = torch.einsum("td,dsgk->tsgk", x, w_kv)              # [T, 2, G, Dk]
    k, v = kv[:, 0], kv[:, 1]
    if cfg.qk_norm:              # on this rank's heads: gradients summed
        q = L.qk_head_norm(copy_to_model(bp["q_norm"], comm), q,
                           cfg.norm_eps)
        k = L.qk_head_norm(copy_to_model(bp["k_norm"], comm), k,
                           cfg.norm_eps)
    q, k = L.positional_rotate(cfg, q, k, pos, pos)
    if collect is not None:
        collect.append({"k": k, "v": v})
    out = R.ring_attention(
        q, k, v, seg, seg, pos_s, pos_s,
        composition=rt.composition, kv_sharded=layout.kv_sharded,
        kv_group_of_head=(None if layout.kv_sharded
                          else layout.group_of_head(x.device)[heads]),
        scale=dk ** -0.5, window=window, softcap=cfg.attn_softcap,
        kv_chunk=rt.kv_chunk, block_skip=rt.block_skip,
        attn_impl=rt.attn_impl, block_q=rt.attn_block_q,
        block_k=rt.attn_block_k, comm=rt.comm)
    if layout.pad_heads:
        out = out * layout.head_mask(x.device)[heads][None, :, None].to(
            out.dtype)
    return reduce_from_model(out.reshape(t, -1) @ bp["w_o"], comm)


def _ffn_block(bp, cfg: ModelConfig, x, tp_comm=None):
    """The MLP; under tensor parallelism this rank's columns of ``w_in``
    and ``w_gate`` and rows of ``w_out``, its output summed over the
    model group."""
    act = L.act_fn(cfg.act)
    x = copy_to_model(x, tp_comm)
    h = x @ bp["w_in"]
    if cfg.gated_mlp:
        h = act(x @ bp["w_gate"]) * h
    else:
        h = act(h)
    return reduce_from_model(h @ bp["w_out"], tp_comm)


def _moe_block(bp, cfg: ModelConfig, rt: Runtime, x):
    """This rank's rows route as one group.  The reference reshapes the
    wave's [T, d] to [hdp, T/hdp, d] and routes each HDP rank's rows
    apart; rank r of the port holds rows [r·C, (r+1)·C) of the wave, so
    its rows are that group, padding rows included.  Under tensor
    parallelism each model rank runs its experts, the reference's
    ``moe_impl="manual"`` (`models/moe.py`)."""
    return MOE.moe_forward(bp, cfg, x, rt.tp_comm)


def _ssm_block(bp, cfg: ModelConfig, rt: Runtime, x, seg, which: str):
    """The RWKV time mix or channel mix on this rank's buffer (the
    reference's ``_ssm_block``, whose shard_map body this is).  In a
    composition with a group of more than one rank every rank passes its
    boundary token to the next rank of its group
    (`core/ring.py::shift_from_prev_rank`), and the time mix composes the
    group's states (`core/ring.py::distributed_state_scan`); with groups
    of one only, the boundary is zeros and there is no exchange.

    The boundary token is the rank's last non-padding row with its
    segment id.  The reference sends the buffer's last row, but the
    planner lays a sharded sequence's piece at the start of each rank's
    buffer with the padding after it, so where the piece is shorter than
    the buffer the last row is padding (segment 0) and the reference cuts
    the sequence's token shift and state at that rank boundary; from the
    last non-padding row both continue, as in one unsharded buffer.  Where
    the piece fills the buffer the two rows are the same.

    Under tensor parallelism the buffer is replicated over the model
    group, so each model rank relays the same boundary over its own HDP
    group, and the state scan composes its own heads' states."""
    comp = rt.composition
    exch = None
    if max(comp) > 1:
        valid = seg > 0
        idx = torch.where(valid, torch.arange(seg.shape[0],
                                              device=seg.device), 0).amax()
        bseg = torch.where(valid.any(), seg[idx], 0)
        bx, bseg = R.shift_from_prev_rank(x[idx], bseg, comm=rt.comm,
                                          composition=comp)

        def exch(s, a):
            return R.distributed_state_scan(a[..., None], s, comm=rt.comm,
                                            composition=comp)
    else:
        bx = torch.zeros_like(x[-1])
        bseg = torch.zeros_like(seg[-1])
    if which == "channel_mix":
        return RW.rwkv_channel_mix(bp, cfg, x, seg, bx, bseg, rt.tp_comm)
    return RW.rwkv_time_mix(bp, cfg, x, seg, bx, bseg, state_exchange=exch,
                            tp_comm=rt.tp_comm)


def block_forward(bp, cfg: ModelConfig, rt: Runtime, x, seg, pos,
                  layer_idx: int, collect: Optional[list] = None):
    code = cfg.layer_code(layer_idx)
    window = cfg.window if code == "l" else 0
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if code == "r":
        h = _ssm_block(bp["time_mix"], cfg, rt, h, seg, "time_mix")
    else:
        h = _attention_block(bp["attn"], cfg, rt, h, seg, pos, window,
                             collect=collect)
    if cfg.post_block_norm:
        h = L.rmsnorm(bp["postnorm1"], h, cfg.norm_eps)
    x = x + h.to(x.dtype)
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    if code == "r":
        h = _ssm_block(bp["channel_mix"], cfg, rt, h, seg, "channel_mix")
    elif "moe" in bp:
        h = _moe_block(bp["moe"], cfg, rt, h)
    else:
        h = _ffn_block(bp["mlp"], cfg, h, rt.tp_comm)
    if cfg.post_block_norm:
        h = L.rmsnorm(bp["postnorm2"], h, cfg.norm_eps)
    return x + h.to(x.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens, tp_comm=None):
    """The embedding rows of ``tokens``.  Under tensor parallelism this
    rank holds vocabulary rows [m·V/tp, (m+1)·V/tp): it looks up the
    tokens in its rows, zeroes the others, and the rows are summed over
    the model group (the reference's ``P(model, None)`` embedding), then
    scaled as at tp = 1."""
    if tp_comm is not None:
        table = params["embed"]
        ids = tokens.reshape(-1).long() - tp_comm.rank * table.shape[0]
        mine = (ids >= 0) & (ids < table.shape[0])
        x = table.index_select(0, ids.clamp(0, table.shape[0] - 1))
        x = torch.where(mine[:, None], x, torch.zeros_like(x))
        x = reduce_from_model(x, tp_comm).reshape(*tokens.shape, cfg.d_model)
    else:
        x = params["embed"].index_select(0, tokens.reshape(-1)).reshape(
            *tokens.shape, cfg.d_model)
    if cfg.embed_scale:
        # the reference multiplies by a weakly typed Python float, which
        # JAX rounds to the activation dtype first (59.866 -> 59.75 in
        # bf16 at d_model 3584); a Python float here would multiply in
        # fp32 with the full scalar and round otherwise
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def embed_frontend(params, cfg: ModelConfig, rt: Runtime, batch,
                   collect: Optional[list] = None) -> torch.Tensor:
    """Token frontend + the un-stacked head blocks.  ``collect``:
    per-head-block KV capture for serving (see `_attention_block`)."""
    check_supported(cfg, rt.tp)
    seg, pos = batch["seg"], batch["pos"]
    x = embed_tokens(params, cfg, batch["tokens"], rt.tp_comm)
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


def logits_head(params, cfg: ModelConfig, hidden, tp_comm=None):
    """hidden [T, d] -> logits [T, V]; under tensor parallelism (``tp_comm``)
    this rank's vocabulary columns [T, V/tp], the reference's
    vocab-sharded logits."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = copy_to_model(hidden, tp_comm) @ w.to(hidden.dtype)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
