"""RWKV-6 "Finch" token and channel mixing with the chunked WKV-6 scan.

Port of `repro/models/rwkv6.py`.  The WKV-6 recurrence per head (size N),
with data-dependent per-channel decay w_t in (0, 1) and bonus u:

    y_t = r_t · (S_{t-1} + (u ⊙ k_t) ⊗ v_t)
    S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t

`wkv6_chunked` runs it in chunks of L tokens.  Everything but the carried
[H, N, N] state is computed for all chunks at once: the per-chunk
cumulative log-decays, the intra-chunk scores and bonus, each chunk's
state contribution, the segment bookkeeping, the exclusive product of the
chunk decays and the correction coefficients.  One short loop over the
chunks then carries the state, and the inter-chunk term of every chunk
is one batched product against the stacked chunk-start states.  Every
exponent keeps the reference's clip at ±30, padding does not decay, and
the carried state is cut where a segment ends.  The scan runs in
float32.

Parameters keep the reference's leaves, shapes and dtypes, so the bridge
copies them as they are:

    time_mix: mix_base [5, d] f32; mix_a [d, R_mix]; mix_b [5, R_mix, d];
    w_r, w_k, w_v, w_g, w_o [d, d]; decay_base [d] f32; decay_a
    [d, R_decay]; decay_b [R_decay, d]; bonus_u [H, N] f32; ln_x {scale,
    bias} [d] f32.
    channel_mix: mix_k [d] f32; w_k [d, d_ff]; w_v [d_ff, d].

Products follow JAX's type promotion, as the reference computes them: the
token-shift mixes are float32 (a float32 ``mix_base`` plus a bf16 LoRA),
so the r/k/v/g and decay projections multiply float32 activations by the
bf16 weights upcast, and the time mix's output projection takes the
float32 ``y * g``.  The channel mix casts its mix back to the activation
dtype before its projections.

Under tensor parallelism (``tp_comm``, the model group) a rank holds its
H/tp WKV heads' columns of the split leaves (`parallel/sharding.py`): it
projects r, k, v, g and the decay on its columns, scans its heads (the
state ``s0``, the group norm and the cross-rank state correction are its
heads'), and its row of ``w_o`` gives a partial output that
`parallel/tensor.py::reduce_from_model` sums, where the reference calls
``tp_reduce``.  The token shift, the mixes and the decay LoRA's hidden
layer act on the replicated stream; their outputs enter the split
products through ``copy_to_model``, so the gradients of the replicated
LoRAs (``mix_a``, ``mix_b``, ``decay_a``, ``mix_base``) and of the input
sum over the model group, as the transpose of the reference's
replicated shard_map inputs does.  The channel mix is a column-parallel
``w_k`` and a row-parallel ``w_v``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel.tensor import copy_to_model, reduce_from_model

MIX_NAMES = ("r", "k", "v", "g", "w")
CLIP = 30.0
GROUP_NORM_EPS = 1e-5


def rwkv_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    """Random time-mix parameters with the reference's distributions (the
    draws differ from ``jax.random``)."""
    rs = cfg.rwkv
    d = cfg.d_model
    n_heads = d // rs.head_size
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mix_base": torch.full((len(MIX_NAMES), d), 0.5, **f32),
        "mix_a": L.dense_init(gen, d, rs.mix_lora, dtype, device),
        "mix_b": L.normal(gen, (len(MIX_NAMES), rs.mix_lora, d), 0.01, dtype,
                          device),
        "w_r": L.dense_init(gen, d, d, dtype, device),
        "w_k": L.dense_init(gen, d, d, dtype, device),
        "w_v": L.dense_init(gen, d, d, dtype, device),
        "w_g": L.dense_init(gen, d, d, dtype, device),
        "w_o": L.dense_init(gen, d, d, dtype, device),
        "decay_base": torch.full((d,), -6.0, **f32),
        "decay_a": L.dense_init(gen, d, rs.decay_lora, dtype, device),
        "decay_b": L.normal(gen, (rs.decay_lora, d), 0.01, dtype, device),
        "bonus_u": torch.zeros((n_heads, rs.head_size), **f32),
        "ln_x": {"scale": torch.ones(d, **f32),
                 "bias": torch.zeros(d, **f32)},
    }


def channel_mix_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    return {
        "mix_k": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "w_k": L.dense_init(gen, d, cfg.d_ff, dtype, device),
        "w_v": L.dense_init(gen, cfg.d_ff, d, dtype, device),
    }


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype of the two, as ``jnp.matmul``."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# token shift
# ---------------------------------------------------------------------------

def token_shift(x, seg, x_prev_boundary, seg_prev_boundary):
    """x [T, d]; returns x shifted by one token, zeros at segment starts.
    ``x_prev_boundary`` [d] / ``seg_prev_boundary`` [] come from the
    previous rank of the group (zeros / 0 when this rank starts one)."""
    prev = torch.cat([x_prev_boundary[None, :].to(x.dtype), x[:-1]], dim=0)
    seg_prev = torch.cat([seg_prev_boundary.reshape(1).to(seg.dtype),
                          seg[:-1]])
    same = (seg == seg_prev) & (seg > 0)
    return torch.where(same[:, None], prev, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


# ---------------------------------------------------------------------------
# WKV-6 chunked scan
# ---------------------------------------------------------------------------

def wkv6_chunked(r, k, v, logw, u, seg, *, head_size: int, chunk: int,
                 s0, carry_seg):
    """r/k/v [T, d], logw [T, d] (<= 0), u [H, N]; seg [T].

    s0: incoming state [H, N, N]; carry_seg: scalar segment id the incoming
    state belongs to (0 = none).

    Returns (y [T, d], s_out [H, N, N], A_total [H, N], corr [T, H, N]), all
    float32:
      * A_total: the total decay applied to s0 (zeroed by segment resets),
        the cross-rank composition coefficient;
      * corr: per-token coefficients such that an additional incoming
        state h adds ``corr_t · h`` to y_t (masked to the tokens whose
        segment continues from the buffer start), so the sweep is linear
        in s0 and the ranks of a group exchange O(H·N²) summaries only.
    """
    t, d = r.shape
    n = head_size
    h = d // n
    chunk = min(chunk, t)
    assert t % chunk == 0, (t, chunk)
    nc = t // chunk
    dev = r.device

    def chunks(a):
        return a.float().reshape(nc, chunk, h, n)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    seg_c = seg.reshape(nc, chunk)
    valid = seg_c > 0                                        # [C, L]
    lw = torch.where(valid[..., None, None], chunks(logw), 0.0)   # pads
    cum = torch.cumsum(lw, dim=1)                            # inclusive
    cum_ex = cum - lw                                        # exclusive

    # segment bookkeeping: the segment each chunk ends in (its last valid
    # token's, else the one it received), and the one it received
    carry = torch.as_tensor(carry_seg, device=dev).reshape(()).to(seg.dtype)
    ar = torch.arange(chunk, device=dev)
    last_idx = torch.where(valid, ar, -1).amax(dim=1)        # [C]
    own_last = seg_c.gather(1, last_idx.clamp(min=0)[:, None])[:, 0]
    ci = torch.arange(nc, device=dev)
    latest = torch.cummax(torch.where(last_idx >= 0, ci, -1), dim=0).values
    last_seg = torch.where(latest >= 0, own_last[latest.clamp(min=0)],
                           carry)                            # [C]
    c_seg = torch.cat([carry.reshape(1), last_seg[:-1]])     # received
    same_as_carry = (seg_c == c_seg[:, None]) & valid        # may read S0
    in_last = (seg_c == last_seg[:, None]) & valid           # feeds S_out
    keep_carry = (last_seg == c_seg).float()

    # inter-chunk coefficients and the correction for a later h_in
    decay_ex = torch.exp(torch.clamp(cum_ex, -CLIP, 0.0))
    r_decay = torch.where(same_as_carry[..., None, None], rc * decay_ex, 0.0)
    a_eff = torch.exp(torch.clamp(cum[:, -1], -CLIP, 0.0)) \
        * keep_carry[:, None, None]                          # [C, H, N]
    a_run = torch.cumprod(a_eff, dim=0)
    a_before = torch.cat([torch.ones_like(a_eff[:1]), a_run[:-1]])
    corr = r_decay * a_before[:, None]                       # [C, L, H, N]

    # intra-chunk: scores[t, s] = sum_n r[t,n] k[s,n] e^{cum_ex[t]-cum[s]}
    q_t = rc * decay_ex
    k_s = kc * torch.exp(torch.clamp(-cum, -CLIP, CLIP))
    scores = torch.einsum("clhn,cmhn->chlm", q_t, k_s)       # [C, H, L, L]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=dev),
                     diagonal=-1)
    seg_eq = (seg_c[:, :, None] == seg_c[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    scores = torch.where((tri & seg_eq)[:, None], scores, 0.0)
    diag = torch.einsum("clhn,hn,clhn->clh", rc, u.float(), kc)
    diag = torch.where(valid[..., None], diag, 0.0)
    y = torch.einsum("chlm,cmhn->clhn", scores, vc) + diag[..., None] * vc

    # each chunk's own state contribution, then the carried state
    k_hat = kc * torch.exp(torch.clamp(cum[:, -1:] - cum, -CLIP, 0.0))
    k_hat = torch.where(in_last[..., None, None], k_hat, 0.0)
    s_new = torch.einsum("clhn,clhm->chnm", k_hat, vc)       # [C, H, N, N]
    s = s0.float()
    starts = []
    for c in range(nc):
        starts.append(s)
        s = a_eff[c][..., None] * s + s_new[c]
    y = y + torch.einsum("clhn,chnm->clhm", r_decay, torch.stack(starts))
    return (y.reshape(t, d), s, a_run[-1], corr.reshape(t, h, n))


def _group_norm(y: torch.Tensor, n: int) -> torch.Tensor:
    """Per-head normalisation of float32 y [..., d] over heads of n."""
    yh = y.reshape(*y.shape[:-1], -1, n)
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, unbiased=False, keepdim=True)
    return ((yh - mu) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(y.shape)


def _mixes(params: dict, x, delta) -> dict:
    """The five data-dependent token-shift mixes (float32)."""
    mix_lora = torch.tanh(_mm(x, params["mix_a"]))           # [T, R]
    return {name: x + (params["mix_base"][i]
                       + _mm(mix_lora, params["mix_b"][i])) * delta
            for i, name in enumerate(MIX_NAMES)}


def _projections(params: dict, mixes: dict, tp_comm=None):
    """r, k, v, g and the log-decay on this rank's columns; under tensor
    parallelism the mixes and the decay LoRA's hidden layer enter the
    split products through one ``copy_to_model`` each."""
    mr, mk, mv, mg = (mixes[n] for n in "rkvg") if tp_comm is None else \
        copy_to_model(torch.stack([mixes[n] for n in "rkvg"]),
                      tp_comm).unbind(0)
    r = _mm(mr, params["w_r"])
    k = _mm(mk, params["w_k"])
    v = _mm(mv, params["w_v"])
    g = F.silu(_mm(mg, params["w_g"]))
    hidden = copy_to_model(torch.tanh(_mm(mixes["w"], params["decay_a"])),
                           tp_comm)
    logw = -torch.exp(params["decay_base"] + _mm(hidden, params["decay_b"]))
    return r, k, v, g, logw


def rwkv_time_mix(params: dict, cfg: ModelConfig, x, seg, x_prev_boundary,
                  seg_prev_boundary, state_exchange=None, tp_comm=None):
    """The RWKV-6 time-mix block on this rank's token buffer x [T, d].

    ``state_exchange(s_local, a_total) -> h_in`` composes the ranks' (A,
    b) summaries when the sequence is sharded over an HDP group (None:
    purely local, h_in = 0), on this rank's heads.  ``tp_comm``: the
    model group (module docstring).  Returns out [T, d] (float32, as the
    reference's)."""
    rs = cfg.rwkv
    d = params["w_r"].shape[1]
    n = rs.head_size
    xp = token_shift(x, seg, x_prev_boundary, seg_prev_boundary)
    r, k, v, g, logw = _projections(params, _mixes(params, x, xp - x),
                                    tp_comm)
    # carry_seg = the previous rank's last segment: the cross-rank decay
    # chain (and the h_in correction) stays alive only while it continues
    y, s_local, a_total, corr = wkv6_chunked(
        r, k, v, logw, params["bonus_u"], seg, head_size=n,
        chunk=rs.chunk_size,
        s0=torch.zeros((d // n, n, n), dtype=torch.float32, device=x.device),
        carry_seg=seg_prev_boundary)
    if state_exchange is not None:
        h_in = state_exchange(s_local, a_total)              # [H, N, N]
        y = y + torch.einsum("thn,hnm->thm", corr,
                             h_in.float()).reshape(y.shape)
    y = _group_norm(y, n) * params["ln_x"]["scale"] + params["ln_x"]["bias"]
    return reduce_from_model(_mm(y.to(x.dtype) * g, params["w_o"]), tp_comm)


def rwkv_channel_mix(params: dict, cfg: ModelConfig, x, seg, x_prev_boundary,
                     seg_prev_boundary, tp_comm=None):
    xp = token_shift(x, seg, x_prev_boundary, seg_prev_boundary)
    xk = copy_to_model((x + params["mix_k"] * (xp - x)).to(x.dtype), tp_comm)
    kk = torch.square(F.relu(xk @ params["w_k"]))
    return reduce_from_model(kk @ params["w_v"], tp_comm)


# ---------------------------------------------------------------------------
# sequential oracle (tests)
# ---------------------------------------------------------------------------

def wkv6_sequential(r, k, v, logw, u, seg, *, head_size: int, s0,
                    carry_seg):
    """Token-by-token WKV-6 recurrence, the oracle of `wkv6_chunked`."""
    t, d = r.shape
    n = head_size
    h = d // n
    rs_, ks_, vs_ = (a.reshape(t, h, n).float() for a in (r, k, v))
    ws_ = torch.exp(logw.reshape(t, h, n).float())
    u = u.float()
    s = s0.float()
    c_seg = int(carry_seg)
    ys = []
    for i in range(t):
        st = int(seg[i])
        if st <= 0:
            ys.append(torch.zeros(h, n, dtype=torch.float32,
                                  device=r.device))
            continue
        s_use = s if st == c_seg else torch.zeros_like(s)
        ys.append(torch.einsum("hn,hnm->hm", rs_[i], s_use)
                  + (rs_[i] * u * ks_[i]).sum(-1)[:, None] * vs_[i])
        s = ws_[i][..., None] * s_use + torch.einsum("hn,hm->hnm", ks_[i],
                                                     vs_[i])
        c_seg = st
    return torch.stack(ys).reshape(t, d), s


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def rwkv_decode_step(params: dict, cfg: ModelConfig, x, state: dict):
    """Single-token time mix.  x [B, d]; state {"s" [B, H, N, N] f32,
    "x_tm" [B, d]} -> (out [B, d] float32, {"s", "x_tm"})."""
    rs = cfg.rwkv
    d = cfg.d_model
    n = rs.head_size
    h = d // n
    r, k, v, g, logw = _projections(params, _mixes(params, x,
                                                   state["x_tm"] - x))
    r, k, v = (a.reshape(-1, h, n).float() for a in (r, k, v))
    w = torch.exp(logw).reshape(-1, h, n)
    s = state["s"]
    y = torch.einsum("bhn,bhnm->bhm", r, s) \
        + torch.einsum("bhn,hn,bhn->bh", r, params["bonus_u"], k)[..., None] \
        * v
    s = w[..., None] * s + torch.einsum("bhn,bhm->bhnm", k, v)
    y = _group_norm(y.reshape(x.shape[0], d), n)
    y = y * params["ln_x"]["scale"] + params["ln_x"]["bias"]
    return _mm(y.to(x.dtype) * g, params["w_o"]), {"s": s, "x_tm": x}


def rwkv_decode_channel_mix(params: dict, x, x_prev):
    """Single-token channel mix: x [B, d] (the normed input, cached as
    the next step's ``x_prev``)."""
    xk = x + params["mix_k"] * (x_prev - x)
    kk = torch.square(F.relu(xk.to(x.dtype) @ params["w_k"]))
    return kk @ params["w_v"]


def state_bytes(cfg: ModelConfig) -> int:
    """Decode state bytes a slot: per layer the float32 [H, N, N] WKV
    state and the two [d] token-shift rows in the activation dtype."""
    rs = cfg.rwkv
    d = cfg.d_model
    per = (d // rs.head_size) * rs.head_size ** 2 * 4 \
        + 2 * d * torch.finfo(L.activation_dtype(cfg)).bits // 8
    return per * cfg.num_layers
