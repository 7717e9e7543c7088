"""Flash attention forward over packed segments: CUDA kernel wrappers and
their plain PyTorch versions.

Layout (the reference's kernel layout):
    q    [G, Hg, T, Dk]
    k    [G, S, Dk]
    v    [G, S, Dv]
    q_seg/q_pos [T]; k_seg/k_pos [S]  (int32; segment 0 = padding)

`flash_attention_fwd_carry` folds one KV block into carried online-softmax
state (acc [G,Hg,T,Dv], m/l [G,Hg,T], fp32) and `flash_attention_fwd`
finalises to (out [G,Hg,T,Dv] in q's dtype, lse [G,Hg,T] fp32).  On a
CUDA tensor each wrapper launches the Hopper kernel of
``csrc/flash_fwd.cu`` (bf16, Dk/Dv in {32, 64, 128}) or raises; on a CPU
tensor it runs the plain version, which repeats the Pallas kernels'
arithmetic panel by panel.  Each wrapper counts its kernel launches in
its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.attention import NEG_INF, attention_mask

BLOCK_Q = 64          # the CUDA kernel's q-tile and KV-tile rows
BLOCK_K = 64
HEAD_DIMS = (32, 64, 128)


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


def _launch(q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m, l, out, lse, *,
            carry, scale, causal, window, softcap, block_q, block_k):
    """Check what the CUDA kernel takes, then launch it on the current
    stream.  Raises on anything it does not take, or a launch error."""
    g, hg, t, dk = q.shape
    s, dv = k.shape[1], v.shape[-1]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA flash kernel takes bfloat16, got "
                        f"{q.dtype}")
    if dk not in HEAD_DIMS or dv not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes Dk, Dv in "
                         f"{HEAD_DIMS}, got {dk}, {dv}")
    if (block_q, block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(f"the CUDA flash kernel tiles {BLOCK_Q}x{BLOCK_K}, "
                         f"got block_q={block_q}, block_k={block_k}")
    bufs = [x for x in (q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m, l,
                        out, lse) if x is not None]
    if not all(x.is_contiguous() for x in bufs):
        raise ValueError("the CUDA flash kernel takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    if t == 0 or g == 0 or hg == 0:
        return
    from repro_torch.kernels import build
    fn = build.load("flash_fwd").flash_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ptr(q), ptr(k), ptr(v), ptr(q_seg), ptr(k_seg), ptr(q_pos),
                 ptr(k_pos), ptr(acc), ptr(m), ptr(l), ptr(out), ptr(lse),
                 int(carry), g, hg, t, s, dk, dv, float(scale), int(causal),
                 int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed: cudaError {err}")


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
    _launch(q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m, l, None, None,
            carry=True, scale=scale, causal=causal, window=window,
            softcap=softcap, block_q=block_q, block_k=block_k)
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
    _launch(q, k, v, q_seg, k_seg, q_pos, k_pos, None, None, None, out, lse,
            carry=False, scale=scale, causal=causal, window=window,
            softcap=softcap, block_q=block_q, block_k=block_k)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
