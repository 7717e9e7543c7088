"""Shared layers: norms, rotary embeddings, activations, GQA layout.

PyTorch port of `repro/models/layers.py`.  Functions are plain functions
on tensors; parameters are nested dicts of tensors.  Initializers take an
explicit `torch.Generator` (no global RNG).  Computation runs in
``cfg.dtype`` (bf16 by default) with fp32 norm internals.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------

def activation_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.zeros(d, dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """(1 + scale) RMS norm with fp32 internals, output in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"])).to(x.dtype)


def qk_head_norm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Per-head RMS norm over head_dim (Gemma-3 / Qwen-3): ``scale`` [D]
    fp32 in the (1 + scale) form, fp32 internals, output in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, D]; positions: [..., T] int (absolute positions).
    Split-halves rotation: (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [D/2]
    angles = positions[..., None].float() * freqs            # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]                    # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positional_rotate(cfg: ModelConfig, q, k, q_pos, k_pos):
    """Apply the config's positional scheme to q/k ([..., T, H, D])."""
    if cfg.pos_embed == "rope":
        return (apply_rope(q, q_pos, cfg.rope_theta),
                apply_rope(k, k_pos, cfg.rope_theta))
    if cfg.pos_embed == "none":
        return q, k
    raise NotImplementedError(
        f"pos_embed={cfg.pos_embed!r} is not ported yet (rope and none are)")


def scalar_positions(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Collapse M-RoPE [T,3] ids to the scalar causal position (t component)."""
    if (cfg.pos_embed == "mrope" and positions.dim() >= 2
            and positions.shape[-1] == 3):
        return positions[..., 0]
    return positions


# ---------------------------------------------------------------------------
# GQA head layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GQALayout:
    """How (num_heads, num_kv_heads) map onto a TP axis of size `tp`
    (same arithmetic as the reference).  Model rank m of tp runs the
    padded heads [m·h_pad/tp, (m+1)·h_pad/tp): its slices of `head_mask`
    and, where KV is replicated, of `group_of_head`
    (`models/transformer.py::_attention_block`)."""
    num_heads: int
    num_kv_heads: int
    tp: int
    hpg_pad: int          # padded q-heads per kv group
    h_pad: int            # padded total q heads
    kv_sharded: bool

    @property
    def pad_heads(self) -> int:
        return self.h_pad - self.num_heads

    def head_mask(self, device=None) -> torch.Tensor:
        """[h_pad] 1.0 for real heads (in padded-group-major order)."""
        hpg = -(-self.num_heads // self.num_kv_heads)
        if self.hpg_pad == hpg:
            return torch.ones(self.h_pad, dtype=torch.float32, device=device)
        within = torch.arange(self.h_pad, device=device) % self.hpg_pad
        return (within < hpg).float()

    def group_of_head(self, device=None) -> torch.Tensor:
        """[h_pad] kv-group index of each padded q head."""
        return torch.arange(self.h_pad, device=device) // self.hpg_pad


def gqa_layout(num_heads: int, num_kv_heads: int, tp: int) -> GQALayout:
    hpg = -(-num_heads // num_kv_heads)                      # ceil heads/group
    hpg_pad = hpg
    while (num_kv_heads * hpg_pad) % tp != 0:
        hpg_pad += 1
    return GQALayout(
        num_heads=num_heads, num_kv_heads=num_kv_heads, tp=tp,
        hpg_pad=hpg_pad, h_pad=num_kv_heads * hpg_pad,
        kv_sharded=(num_kv_heads % tp == 0))


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    """N(0, std²) drawn in fp32 from ``gen`` on ``device``, cast to dtype."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, scale: float = 1.0) -> torch.Tensor:
    return normal(gen, (in_dim, out_dim), scale / math.sqrt(in_dim), dtype,
                  device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)
