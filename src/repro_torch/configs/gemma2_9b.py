"""Gemma-2-9B [arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000 — alternating
local(4096-window)/global attention, attn logit softcap 50, final softcap 30,
GeGLU, post-block norms, sqrt(d) embedding scale, head_dim=256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern="lg",          # local, global, local, global, ...
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    pos_embed="rope",
    rope_theta=10_000.0,
    act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    embed_scale=True,
    post_block_norm=True,
)
