"""Flash attention over packed segments, forward and backward: CUDA kernel
wrappers and their plain PyTorch versions.

Layout (the reference's kernel layout):
    q    [G, Hg, T, Dk]
    k    [G, S, Dk]
    v    [G, S, Dv]
    q_seg/q_pos [T]; k_seg/k_pos [S]  (int32; segment 0 = padding)

`flash_attention_fwd_carry` folds one KV block into carried online-softmax
state (acc [G,Hg,T,Dv], m/l [G,Hg,T], fp32) and `flash_attention_fwd`
finalises to (out [G,Hg,T,Dv] in q's dtype, lse [G,Hg,T] fp32).
`flash_attention_bwd` takes the forward's (out, lse) and the output
gradient do and returns (dq, dk, dv) through two kernels:
`flash_attention_bwd_dq` returns dq and delta = rowsum(do·out) [G,Hg,T]
fp32, which `flash_attention_bwd_dkv` then takes.  On a CUDA tensor
each wrapper launches its Hopper kernel (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``; bf16, `KERNEL_DIMS`) or raises; on a CPU
tensor it runs the plain version, which repeats the Pallas kernels'
arithmetic panel by panel.  Each kernel wrapper counts its launches in its
``launches`` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import NEG_INF, attention_mask

BLOCK_Q = 64          # the CUDA kernel's q-tile and KV-tile rows
BLOCK_K = 64
HEAD_DIMS = (32, 64, 128)
# the (Dk, Dv) pairs the CUDA kernels are instantiated for: every pair of
# HEAD_DIMS, (256, 256) (Gemma-2 and Gemma-3) and (576, 512) (DeepSeek-V2's
# absorbed latent attention: kv_lora_rank 512 + qk_rope 64, v the first 512)
KERNEL_DIMS = frozenset({(a, b) for a in HEAD_DIMS for b in HEAD_DIMS}
                        | {(256, 256), (576, 512)})


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def flash_attention_fwd_carry_plain(q, k, v, q_seg, k_seg, q_pos, k_pos,
                                    acc, m, l, *, scale, causal=True,
                                    window=0, softcap=0.0, block_k=BLOCK_K):
    """Plain version of the carry kernel: the online update of the Pallas
    ``_online_update``, one KV panel of ``block_k`` rows at a time.
    Returns new (acc, m, l); its inputs are left unchanged."""
    acc, m, l = acc.clone(), m.clone(), l.clone()
    qf = q.float()
    for a in range(0, k.shape[1], block_k):
        b = a + block_k
        s = torch.einsum("ghtd,gsd->ghts", qf, k[:, a:b].float()) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = attention_mask(q_seg, k_seg[a:b], q_pos, k_pos[a:b],
                              causal=causal, window=window)
        s = torch.where(mask, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_cur[..., None]), 0.0)
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("ghts,gsd->ghtd", p.to(v.dtype).float(),
                          v[:, a:b].float())
        acc = acc * alpha[..., None] + pv
        m = m_cur
    return acc, m, l


def finalize(acc, m, l, dtype):
    """(acc, m, l) -> (out in ``dtype`` with zero rows where l == 0,
    lse with NEG_INF there), as the Pallas kernel's last grid step."""
    live = l > 0
    safe_l = torch.where(live, l, 1.0)
    out = torch.where(live[..., None], acc / safe_l[..., None], 0.0)
    lse = torch.where(live, m + torch.log(safe_l), NEG_INF)
    return out.to(dtype), lse


def zero_state(g, hg, t, dv, device):
    return (torch.zeros((g, hg, t, dv), dtype=torch.float32, device=device),
            torch.full((g, hg, t), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((g, hg, t), dtype=torch.float32, device=device))


def flash_attention_fwd_plain(q, k, v, q_seg, k_seg, q_pos, k_pos, *, scale,
                              causal=True, window=0, softcap=0.0,
                              block_k=BLOCK_K):
    """Plain version of the finalising kernel -> (out, lse)."""
    g, hg, t, _ = q.shape
    state = zero_state(g, hg, t, v.shape[-1], q.device)
    acc, m, l = flash_attention_fwd_carry_plain(
        q, k, v, q_seg, k_seg, q_pos, k_pos, *state, scale=scale,
        causal=causal, window=window, softcap=softcap, block_k=block_k)
    return finalize(acc, m, l, q.dtype)


def flash_attention_bwd_plain(q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse,
                              do, *, scale, causal=True, window=0,
                              softcap=0.0, block_k=BLOCK_K):
    """Plain version of both backward kernels -> (dq, dk, dv) in the
    inputs' dtypes.  One KV panel of ``block_k`` rows at a time, in fp32:
    the arithmetic of ``_bwd_dq_kernel`` (dq += ds·k·scale) and of
    ``_bwd_dkv_kernel`` (dv = pᵀ·do, dk = dsᵀ·q·scale) on the same p, ds."""
    qf, dof = q.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1)                  # [G,Hg,T]
    dq = torch.zeros_like(qf)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    for a in range(0, k.shape[1], block_k):
        b = a + block_k
        kb, vb = k[:, a:b].float(), v[:, a:b].float()
        s = torch.einsum("ghtd,gsd->ghts", qf, kb) * scale
        dcap = None
        if softcap:
            th = torch.tanh(s / softcap)
            s = softcap * th
            dcap = 1.0 - th * th
        mask = attention_mask(q_seg, k_seg[a:b], q_pos, k_pos[a:b],
                              causal=causal, window=window)
        p = torch.exp(torch.where(mask, s, NEG_INF) - lse[..., None])
        p = torch.where(mask, p, 0.0)
        dp = torch.einsum("ghte,gse->ghts", dof, vb)
        ds = p * (dp - delta[..., None])
        if dcap is not None:
            ds = ds * dcap
        dq += torch.einsum("ghts,gsd->ghtd", ds, kb) * scale
        dv[:, a:b] = torch.einsum("ghts,ghte->gse", p, dof)
        dk[:, a:b] = torch.einsum("ghts,ghtd->gsd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# checks and launch
# ---------------------------------------------------------------------------

def _check(q, k, v, q_seg, k_seg, q_pos, k_pos, state=None):
    if q.dim() != 4 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"want q [G,Hg,T,Dk], k [G,S,Dk], v [G,S,Dv]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    g, hg, t, dk = q.shape
    s, dv = k.shape[1], v.shape[-1]
    if k.shape != (g, s, dk) or v.shape[:2] != (g, s):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    for name, x, n in (("q_seg", q_seg, t), ("q_pos", q_pos, t),
                       ("k_seg", k_seg, s), ("k_pos", k_pos, s)):
        if x.shape != (n,) or x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{n}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if state is not None:
        acc, m, l = state
        if acc.shape != (g, hg, t, dv) or m.shape != (g, hg, t) \
                or l.shape != (g, hg, t):
            raise ValueError("carry shapes must be acc [G,Hg,T,Dv], "
                             "m/l [G,Hg,T]")
        if any(x.dtype != torch.float32 for x in state):
            raise ValueError("carry (acc, m, l) must be float32")
    tensors = [q, k, v, q_seg, k_seg, q_pos, k_pos, *(state or ())]
    if any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return tensors


def _check_bwd(q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do,
               delta=None):
    _check(q, k, v, q_seg, k_seg, q_pos, k_pos)
    g, hg, t, _ = q.shape
    want = (g, hg, t, v.shape[-1])
    if tuple(out.shape) != want or tuple(do.shape) != want:
        raise ValueError(f"out and do must be [G,Hg,T,Dv] = {want}, got "
                         f"{tuple(out.shape)}, {tuple(do.shape)}")
    if out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"out/do dtypes {out.dtype}, {do.dtype} differ from "
                         f"q's {q.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x is not None and (tuple(x.shape) != (g, hg, t)
                              or x.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 [G,Hg,T]")
    if any(x.device != q.device for x in (out, lse, do, delta)
           if x is not None):
        raise ValueError("all inputs must be on one device")


def _launch(source, symbol, q, k, v, args, *, block_q, block_k):
    """Check what the CUDA kernels take, then call ``symbol`` of
    ``csrc/<source>.cu`` with ``args`` (`build.call`).  Raises on anything
    the kernel does not take, or a launch error."""
    g, hg, t, dk = q.shape
    dv = v.shape[-1]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA flash kernels take bfloat16, got "
                        f"{q.dtype}")
    if (dk, dv) not in KERNEL_DIMS:
        raise ValueError(f"the CUDA flash kernels take Dk, Dv in "
                         f"{HEAD_DIMS}, Dk = Dv = 256 or (Dk, Dv) = "
                         f"(576, 512), got {dk}, {dv}")
    if (block_q, block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(f"the CUDA flash kernels tile {BLOCK_Q}x{BLOCK_K}, "
                         f"got block_q={block_q}, block_k={block_k}")
    bufs = [a for a in args if isinstance(a, torch.Tensor)]
    if not all(x.is_contiguous() for x in bufs):
        raise ValueError("the CUDA flash kernels take contiguous tensors")
    if any(x.data_ptr() % 16 for x in bufs if x.dtype == torch.bfloat16):
        raise ValueError("bf16 operands must be 16-byte aligned")
    if t == 0 or g == 0 or hg == 0 or k.shape[1] == 0:
        return
    from repro_torch.kernels import build
    build.call(source, symbol, args, q.device)


def _fwd_args(q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m, l, out, lse, *,
              carry, scale, causal, window, softcap):
    g, hg, t, dk = q.shape
    return [q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m, l, out, lse,
            int(carry), g, hg, t, k.shape[1], dk, v.shape[-1], float(scale),
            int(causal), int(window), float(softcap)]


def _bwd_args(q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do, grads, *,
              scale, causal, window, softcap):
    g, hg, t, dk = q.shape
    return [q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do, *grads, g,
            hg, t, k.shape[1], dk, v.shape[-1], float(scale), int(causal),
            int(window), float(softcap)]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def flash_attention_fwd_carry(q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m,
                              l, *, scale, causal=True, window=0,
                              softcap=0.0, block_q=BLOCK_Q, block_k=BLOCK_K):
    """One ring step: fold one KV block into carried online-softmax state.

    Updates ``acc``, ``m`` and ``l`` IN PLACE (the kernel reads and writes
    them; the CPU path copies its result into them) and returns them.
    """
    _check(q, k, v, q_seg, k_seg, q_pos, k_pos, (acc, m, l))
    if q.device.type == "cpu":
        new = flash_attention_fwd_carry_plain(
            q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m, l, scale=scale,
            causal=causal, window=window, softcap=softcap, block_k=block_k)
        for dst, src in zip((acc, m, l), new):
            dst.copy_(src)
        return acc, m, l
    args = _fwd_args(q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m, l, None,
                     None, carry=True, scale=scale, causal=causal,
                     window=window, softcap=softcap)
    _launch("flash_fwd", "flash_fwd_bf16", q, k, v, args, block_q=block_q,
            block_k=block_k)
    flash_attention_fwd_carry.launches += 1
    return acc, m, l


flash_attention_fwd_carry.launches = 0


def flash_attention_fwd(q, k, v, q_seg, k_seg, q_pos, k_pos, *, scale,
                        causal=True, window=0, softcap=0.0, block_q=BLOCK_Q,
                        block_k=BLOCK_K):
    """Packed-segment causal flash forward -> (out [G,Hg,T,Dv] in q's
    dtype, zero rows where no key is visible; lse [G,Hg,T] fp32, NEG_INF
    on those rows)."""
    _check(q, k, v, q_seg, k_seg, q_pos, k_pos)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, q_seg, k_seg, q_pos, k_pos, scale=scale, causal=causal,
            window=window, softcap=softcap, block_k=block_k)
    g, hg, t, _ = q.shape
    out = torch.empty((g, hg, t, v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((g, hg, t), dtype=torch.float32, device=q.device)
    args = _fwd_args(q, k, v, q_seg, k_seg, q_pos, k_pos, None, None, None,
                     out, lse, carry=False, scale=scale, causal=causal,
                     window=window, softcap=softcap)
    _launch("flash_fwd", "flash_fwd_bf16", q, k, v, args, block_q=block_q,
            block_k=block_k)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _delta(out, do):
    """delta = rowsum(do·out) [G,Hg,T] in fp32, as the backward uses it."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_dq(q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do,
                           *, scale, causal=True, window=0, softcap=0.0,
                           block_q=BLOCK_Q, block_k=BLOCK_K):
    """(dq [G,Hg,T,Dk] in q's dtype, delta [G,Hg,T] fp32): the dq kernel of
    the backward, which also writes delta = rowsum(do·out) once per q row
    for `flash_attention_bwd_dkv`."""
    _check_bwd(q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do,
            block_k=block_k, **kw)[0], _delta(out, do)
    dq = torch.empty_like(q)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    args = _bwd_args(q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do,
                     [dq, delta], **kw)
    _launch("flash_bwd", "flash_bwd_dq_bf16", q, k, v, args,
            block_q=block_q, block_k=block_k)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse,
                            do, delta, *, scale, causal=True, window=0,
                            softcap=0.0, block_q=BLOCK_Q, block_k=BLOCK_K):
    """(dk [G,S,Dk], dv [G,S,Dv]) in k's dtype (the dkv kernel of the
    backward), summed over the Hg heads of each group.  ``delta`` is the
    one `flash_attention_bwd_dq` returned for the same inputs; the kernel
    reads it in place of ``out``, and the plain version recomputes it."""
    _check_bwd(q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do, delta)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do,
            block_k=block_k, **kw)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = _bwd_args(q, k, v, q_seg, k_seg, q_pos, k_pos, delta, lse, do,
                     [dk, dv], **kw)
    _launch("flash_bwd", "flash_bwd_dkv_bf16", q, k, v, args,
            block_q=block_q, block_k=block_k)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do, *,
                        scale, causal=True, window=0, softcap=0.0,
                        block_q=BLOCK_Q, block_k=BLOCK_K):
    """Packed-segment flash backward from the forward's (out, lse) and the
    output gradient ``do`` [G,Hg,T,Dv] -> (dq, dk, dv).  Rows with no
    visible key (padding) get dq = 0, and keys no row sees dk = dv = 0."""
    args = (q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, do)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              block_k=block_k)
    if q.device.type == "cpu":
        _check_bwd(*args)
        return flash_attention_bwd_plain(*args, **kw)
    dq, delta = flash_attention_bwd_dq(*args, block_q=block_q, **kw)
    return (dq, *flash_attention_bwd_dkv(*args, delta, block_q=block_q,
                                         **kw))
