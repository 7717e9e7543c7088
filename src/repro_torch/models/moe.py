"""Mixture-of-Experts FFN with capacity-bounded dispatch.

Port of `repro/models/moe.py` (plain tensor code there too: no Pallas
kernel).  One group of T tokens routes together:

  1. router logits and softmax in fp32 (IEEE on the card: a CUDA
     `Runtime` refuses TF32, `parallel/sharding.py`), top-k per token,
     the gates optionally renormalised (`moe_route`);
  2. the (token, k) pairs in token-major order, each one's position in
     its expert from an exclusive cumsum of the one-hot over the T·k
     pairs (`moe_positions`);
  3. the pairs below the capacity (`moe_capacity`) fill a fixed
     ``[E·cap, d]`` buffer, the rest are dropped; three batched GEMMs
     run the experts; each pair's row is gathered back, weighted by its
     gate and summed over k; shared experts are added last
     (`moe_experts`).

Shapes never depend on the data and nothing syncs with the host.  Each
kept pair has its own buffer row, so the dispatch is a gather of the
pairs by row (the row -> pair map is an integer scatter whose only
colliding index, the overflow row, is cut off) and its backward adds at
most one gradient into each pair's row; the combine gathers with the
dropped pairs clamped to the last row and masked out, as the reference
does.  The forward and its autograd backward are therefore the same from
run to run, so a recompute routes exactly as the forward did.

The group is the caller's choice, as in the reference: a rank's rows of
a prefill or training wave (`models/transformer.py::_moe_block`), or the
whole decode slab (`train/serve_step.py`), which `moe_forward_sharded`
routes from each rank's share of its rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.models import layers as L


def moe_capacity(spec: MoESpec, n_tokens: int) -> int:
    cap = int(n_tokens * spec.top_k / spec.num_experts * spec.capacity_factor)
    return max(8, -(-cap // 8) * 8)                      # round up to 8


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """The reference's tree and distributions: ``router`` [d, E] float32,
    ``w_in``/``w_gate`` [E, d, f] and ``w_out`` [E, f, d] in ``dtype``,
    and ``shared_in``/``shared_gate`` [d, s·f], ``shared_out`` [s·f, d]
    with s = ``num_shared`` > 0."""
    spec = cfg.moe
    d, e, f = cfg.d_model, spec.num_experts, spec.d_expert
    p = {
        "router": L.dense_init(gen, d, e, torch.float32, device),
        "w_in": L.normal(gen, (e, d, f), 1.0 / math.sqrt(d), dtype, device),
        "w_out": L.normal(gen, (e, f, d), 1.0 / math.sqrt(f), dtype, device),
    }
    if cfg.gated_mlp:
        p["w_gate"] = L.normal(gen, (e, d, f), 1.0 / math.sqrt(d), dtype,
                               device)
    if spec.num_shared:
        s = spec.num_shared * f
        p["shared_in"] = L.dense_init(gen, d, s, dtype, device)
        p["shared_out"] = L.dense_init(gen, s, d, dtype, device)
        if cfg.gated_mlp:
            p["shared_gate"] = L.dense_init(gen, d, s, dtype, device)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def moe_route(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """x [T, d] -> (gates [T, k] float32, expert indices [T, k] int64),
    each row's top-k in descending probability."""
    spec = cfg.moe
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    gates, idx = torch.topk(probs, spec.top_k, dim=-1)
    if spec.router_norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


def moe_positions(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """idx [T, k] -> [T·k]: each (token, k) pair's position within its
    expert, pairs in token-major order (the reference's ``jnp.repeat``
    order): the exclusive cumsum of the one-hot over the pairs."""
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, num_experts)                  # [T·k, E]
    before = onehot.cumsum(dim=0) - onehot                 # exclusive
    return before.gather(1, flat[:, None]).squeeze(1)


def moe_experts(params: dict, cfg: ModelConfig, x: torch.Tensor, gates,
                idx, pos, cap: int) -> torch.Tensor:
    """The experts on routed rows: x [T, d], gates and idx [T, k] from
    `moe_route`, pos [T·k] from `moe_positions` (over this group, or the
    whole group this x is a part of), ``cap`` the group's capacity.
    Pairs at ``pos >= cap`` are dropped.  -> [T, d] in x's dtype."""
    spec = cfg.moe
    t, d = x.shape
    e, k = spec.num_experts, spec.top_k
    n = t * k
    act = L.act_fn(cfg.act)
    keep = pos < cap
    slot = torch.where(keep, idx.reshape(-1) * cap + pos,
                       torch.full_like(pos, e * cap))      # overflow row
    # dispatch: buffer row -> pair (n: an empty row), then one gather
    pair = torch.arange(n, device=x.device)
    src = torch.full((e * cap + 1,), n, dtype=torch.int64, device=x.device)
    src.scatter_(0, slot, pair)
    xk = torch.cat([x.repeat_interleave(k, dim=0), x.new_zeros(1, d)])
    buf = xk.index_select(0, src[: e * cap]).view(e, cap, d)

    h = torch.bmm(buf, params["w_in"])
    if cfg.gated_mlp:
        h = act(torch.bmm(buf, params["w_gate"])) * h
    else:
        h = act(h)
    out = torch.bmm(h, params["w_out"]).view(e * cap, d)

    # combine: each pair's row (dropped pairs masked), gate-weighted, Σ_k
    y_pairs = out.index_select(0, slot.clamp(max=e * cap - 1))
    y_pairs = torch.where(keep[:, None], y_pairs, y_pairs.new_zeros(()))
    w = gates.reshape(n).to(x.dtype)
    y = (y_pairs * w[:, None]).view(t, k, d).sum(dim=1)

    if spec.num_shared:
        h_s = x @ params["shared_in"]
        if cfg.gated_mlp:
            h_s = act(x @ params["shared_gate"]) * h_s
        else:
            h_s = act(h_s)
        y = y + h_s @ params["shared_out"]
    return y.to(x.dtype)


def moe_forward(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """x [T, d] -> [T, d]: the T rows route as one group."""
    gates, idx = moe_route(params, cfg, x)
    return moe_experts(params, cfg, x, gates, idx,
                       moe_positions(idx, cfg.moe.num_experts),
                       moe_capacity(cfg.moe, x.shape[0]))


def moe_forward_sharded(params: dict, cfg: ModelConfig, x: torch.Tensor,
                        comm) -> torch.Tensor:
    """This rank's rows x [n, d] of a group of ``comm.size · n`` rows held
    in rank order (rank r: rows [r·n, (r+1)·n)), routed as that whole
    group: the same result for these rows as `moe_forward` on the group.
    Each rank routes its own rows and all-gathers the top-k indices
    (the capacity and every pair's position are the group's); the
    experts run on its own rows only."""
    spec = cfg.moe
    n, k = x.shape[0], spec.top_k
    gates, idx = moe_route(params, cfg, x)
    every = comm.all_gather(idx).reshape(-1, k)            # rank order
    pos = moe_positions(every, spec.num_experts)
    mine = pos[comm.rank * n * k:(comm.rank + 1) * n * k]
    return moe_experts(params, cfg, x, gates, idx, mine,
                       moe_capacity(spec, n * comm.size))


def router_aux_stats(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """Load-balance diagnostics of x [T, d] routed as one group:
    ``expert_load`` [E] (pairs per expert) and ``dropped_frac`` (the
    share of the T·k pairs beyond an expert's capacity)."""
    spec = cfg.moe
    t = x.shape[0]
    _, idx = moe_route(params, cfg, x)
    counts = torch.bincount(idx.reshape(-1), minlength=spec.num_experts)
    cap = moe_capacity(spec, t)
    dropped = (counts - cap).clamp_min(0).sum()
    return {"expert_load": counts,
            "dropped_frac": dropped / (t * spec.top_k)}
