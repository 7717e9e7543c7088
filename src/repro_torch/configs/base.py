"""Model / parallelism / run configuration for the ByteScale-JAX framework.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (the exact published configuration) plus the generic
``ModelConfig.reduced()`` smoke-test shrinkage.  ``registry.get_config(name)``
is the single lookup point used by the launcher, dry-run and tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-Experts block configuration."""
    num_experts: int
    top_k: int
    d_expert: int                 # hidden size of each routed expert FFN
    num_shared: int = 0           # always-on shared experts (DeepSeek-V2 style)
    first_k_dense: int = 0        # leading layers that use a dense FFN instead
    moe_period: int = 1           # every `moe_period`-th layer is MoE (Jamba: 2)
    dense_d_ff: int = 0           # d_ff of the dense layers (first_k_dense / off-period)
    capacity_factor: float = 1.25
    router_norm_topk: bool = True # renormalize top-k gate weights


@dataclass(frozen=True)
class MLASpec:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0          # 0 => no query compression (V2-Lite)


@dataclass(frozen=True)
class RWKVSpec:
    """RWKV-6 'Finch' token-mixing configuration."""
    head_size: int = 64
    decay_lora: int = 64          # rank of the data-dependent decay LoRA
    mix_lora: int = 32            # rank of the token-shift mix LoRA
    chunk_size: int = 128         # chunked-scan block length


@dataclass(frozen=True)
class MambaSpec:
    """Mamba-1 selective SSM configuration (Jamba's mixer)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 => ceil(d_model / 16)
    chunk_size: int = 256


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads

    # Per-layer block pattern, cycled over `num_layers`.
    #   'g' global attention   'l' local (sliding-window) attention
    #   'm' Mamba mixer        'r' RWKV-6 mixer
    layer_pattern: str = "g"
    window: int = 0               # sliding-window width for 'l' layers
    attn_softcap: float = 0.0     # Gemma-2 attention logit soft-capping
    final_softcap: float = 0.0    # Gemma-2 final logit soft-capping
    qk_norm: bool = False         # Gemma-3 / Qwen-3 per-head RMS q/k norm

    pos_embed: str = "rope"       # rope | mrope | sinusoidal | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    rwkv: Optional[RWKVSpec] = None
    mamba: Optional[MambaSpec] = None

    act: str = "silu"             # silu | gelu
    gated_mlp: bool = True        # SwiGLU/GeGLU vs plain 2-layer MLP
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # Gemma-style extras
    embed_scale: bool = False     # multiply embeddings by sqrt(d_model)
    post_block_norm: bool = False # Gemma-2/3 post-attn/post-ffn norms

    # Modality frontend: the backbone consumes precomputed embeddings.
    frontend: str = "none"        # none | vision_stub | audio_stub
    sub_quadratic: bool = False   # eligible for long_500k decode
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return all(c in ("m", "r") for c in self.layer_pattern)

    def pattern_period(self) -> str:
        """The repeating unit of the layer pattern."""
        return self.layer_pattern

    def layer_code(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_k_dense:
            return False
        return (i % self.moe.moe_period) == (self.moe.moe_period - 1) \
            if self.moe.moe_period > 1 else True

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        period = len(self.layer_pattern)
        n_layers = max(2 * period, period)       # >= one full period, >= 2 layers
        if self.moe is not None:
            # keep at least one dense + one moe layer when the full model has them
            n_layers = max(n_layers, self.moe.first_k_dense + self.moe.moe_period)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(2, self.moe.top_k),
                d_expert=64, dense_d_ff=128 if self.moe.dense_d_ff else 0,
                num_shared=min(1, self.moe.num_shared))
        mla = None
        if self.mla is not None:
            mla = MLASpec(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                          v_head_dim=16, q_lora_rank=0)
        rwkv = dataclasses.replace(self.rwkv, head_size=16, decay_lora=8,
                                   mix_lora=8, chunk_size=16) if self.rwkv else None
        mamba = dataclasses.replace(self.mamba, d_state=4, chunk_size=16) \
            if self.mamba else None
        n_heads = 4
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=64,
            num_heads=n_heads,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            window=min(self.window, 16) if self.window else 0,
            mrope_sections=(2, 3, 3),
            moe=moe, mla=mla, rwkv=rwkv, mamba=mamba,
        )

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline numbers)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                 # lm head
        for i in range(self.num_layers):
            code = self.layer_code(i)
            if code in ("g", "l"):
                if self.mla is not None:
                    m = self.mla
                    total += d * (m.kv_lora_rank + m.qk_rope_dim)          # kv down
                    total += m.kv_lora_rank * nq * (m.qk_nope_dim + m.v_head_dim)
                    total += d * nq * (m.qk_nope_dim + m.qk_rope_dim)      # q proj
                    total += nq * m.v_head_dim * d                         # o proj
                else:
                    total += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            elif code == "m":
                ms = self.mamba or MambaSpec()
                d_in = ms.expand * d
                dt_rank = ms.dt_rank or -(-d // 16)
                total += d * 2 * d_in                    # in proj (x, z)
                total += d_in * ms.d_conv                # conv
                total += d_in * (dt_rank + 2 * ms.d_state)
                total += dt_rank * d_in + d_in * ms.d_state  # dt proj, A
                total += d_in * d                        # out proj
            elif code == "r":
                rs = self.rwkv or RWKVSpec()
                total += 4 * d * d + d * d               # r,k,v,g,o
                total += 2 * d * rs.decay_lora           # decay lora
                total += 2 * d * 3.5 * d                 # channel mix approx
            # FFN
            if self.is_moe_layer(i):
                e = self.moe
                mult = 3 if self.gated_mlp else 2
                total += e.num_experts * mult * d * e.d_expert
                total += e.num_shared * mult * d * e.d_expert
                total += d * e.num_experts               # router
            elif code != "r":                            # rwkv counts its own mix
                d_ff = self.d_ff
                if self.moe is not None and self.moe.dense_d_ff:
                    d_ff = self.moe.dense_d_ff
                mult = 3 if self.gated_mlp else 2
                total += mult * d * d_ff
        return int(total)


# ---------------------------------------------------------------------------
# Input shapes (assigned grid)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode | long_decode


SHAPE_GRID: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "long_decode"),
)

SHAPES = {s.name: s for s in SHAPE_GRID}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k only for sub-quadratic archs (see DESIGN.md §5)."""
    if shape.kind == "long_decode":
        return cfg.sub_quadratic
    return True
