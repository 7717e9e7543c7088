"""Fused softmax cross-entropy: CUDA kernel wrappers and their plain
PyTorch versions.

Port of `repro/kernels/fused_ce.py`.  `fused_ce_fwd(logits [T, V],
labels [T] int32)` returns (nll, lse, tgt) [T] in fp32; `fused_ce_bwd`
returns dlogits = (softmax(logits) - onehot(labels)) * g in the logits'
dtype.  Unlike the Pallas kernels, any V is taken (the vocabulary tail is
masked, not asserted away: 128256 is no multiple of a 2048 panel).  On a
CUDA tensor each wrapper launches its Hopper kernel of ``csrc/fused_ce.cu``
(bf16 logits) or raises; on a CPU tensor it runs the plain version, which
repeats the Pallas kernels' arithmetic one vocabulary panel at a time.
Each wrapper counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30
BLOCK_V = 2048        # the plain versions' vocabulary panel


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_ce_fwd_plain(logits, labels, *, block_v=BLOCK_V):
    """Running max, sum-exp and target logit over vocabulary panels, in
    fp32 -> (nll, lse, tgt)."""
    t, v = logits.shape
    dev = logits.device
    m = torch.full((t,), NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((t,), dtype=torch.float32, device=dev)
    tgt = torch.full((t,), NEG_INF, dtype=torch.float32, device=dev)
    for a in range(0, v, block_v):
        lg = logits[:, a:a + block_v].float()
        m_cur = torch.maximum(m, lg.amax(dim=1))
        s = s * torch.exp(m - m_cur) \
            + torch.exp(lg - m_cur[:, None]).sum(dim=1)
        m = m_cur
        col = labels.long() - a
        in_panel = (col >= 0) & (col < lg.shape[1])
        picked = lg.gather(1, col.clamp(0, lg.shape[1] - 1)[:, None])[:, 0]
        tgt = torch.where(in_panel, picked, tgt)
    lse = m + torch.log(s)
    return lse - tgt, lse, tgt


def fused_ce_bwd_plain(logits, labels, lse, g, *, block_v=BLOCK_V):
    """(exp(lg - lse) - onehot(label)) * g, panel by panel, in the logits'
    dtype."""
    out = torch.empty_like(logits)
    lab = labels.long()
    for a in range(0, logits.shape[1], block_v):
        lg = logits[:, a:a + block_v].float()
        p = torch.exp(lg - lse[:, None])
        cols = torch.arange(a, a + lg.shape[1], device=logits.device)
        onehot = (cols[None, :] == lab[:, None]).float()
        out[:, a:a + block_v] = ((p - onehot) * g[:, None]).to(logits.dtype)
    return out


# ---------------------------------------------------------------------------
# checks and launch
# ---------------------------------------------------------------------------

def _check(logits, labels, *rows):
    if logits.dim() != 2 or not logits.is_floating_point():
        raise ValueError(f"logits must be a float [T, V] tensor, got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    t = logits.shape[0]
    if labels.shape != (t,) or labels.dtype != torch.int32:
        raise ValueError(f"labels must be int32 [{t}], got {labels.dtype} "
                         f"{tuple(labels.shape)}")
    for x in rows:
        if x.shape != (t,) or x.dtype != torch.float32:
            raise ValueError(f"lse and g must be float32 [{t}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    if any(x.device != logits.device for x in (labels, *rows)):
        raise ValueError("all inputs must be on one device")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {logits.device}")


def _launch(symbol, logits, args):
    """Check what the CUDA kernel takes, then call ``symbol`` of
    ``csrc/fused_ce.cu`` with ``args`` (`build.call`).  Raises on anything
    the kernel does not take, or a launch error."""
    if logits.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA cross-entropy kernels take bfloat16 "
                        f"logits, got {logits.dtype}")
    bufs = [a for a in args if isinstance(a, torch.Tensor)]
    if not all(x.is_contiguous() for x in bufs):
        raise ValueError("the CUDA cross-entropy kernels take contiguous "
                         "tensors")
    if any(x.data_ptr() % 16 for x in bufs if x.dtype == torch.bfloat16):
        raise ValueError("logits and dlogits must be 16-byte aligned")
    from repro_torch.kernels import build
    build.call("fused_ce", symbol, args, logits.device)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def fused_ce_fwd(logits, labels):
    """logits [T, V], labels [T] int32 -> (nll, lse, tgt) [T] fp32."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return fused_ce_fwd_plain(logits, labels)
    t, v = logits.shape
    nll, lse, tgt = (torch.empty((t,), dtype=torch.float32,
                                 device=logits.device) for _ in range(3))
    _launch("fused_ce_fwd_bf16", logits, [logits, labels, nll, lse, tgt, t,
                                          v])
    fused_ce_fwd.launches += 1
    return nll, lse, tgt


fused_ce_fwd.launches = 0


def fused_ce_bwd(logits, labels, lse, g):
    """dlogits [T, V] in the logits' dtype for loss = sum(nll * g), from the
    forward's lse; rows with g = 0 come out exactly zero."""
    _check(logits, labels, lse, g)
    if logits.device.type == "cpu":
        return fused_ce_bwd_plain(logits, labels, lse, g)
    t, v = logits.shape
    dlogits = torch.empty_like(logits)
    _launch("fused_ce_bwd_bf16", logits, [logits, labels, lse, g, dlogits,
                                          t, v])
    fused_ce_bwd.launches += 1
    return dlogits


fused_ce_bwd.launches = 0
