"""Gemma-3-12B [hf:google/gemma-3-1b-pt family; unverified].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 — 5:1 local:global
layer pattern (window 1024), qk-norm instead of softcap, 128k context.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern="lllllg",      # 5 local : 1 global
    window=1024,
    qk_norm=True,
    pos_embed="rope",
    rope_theta=1_000_000.0,
    act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    embed_scale=True,
    post_block_norm=True,
)
