"""StarCoder2-7B [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152 — GQA, RoPE.
StarCoder2 uses a plain (non-gated) GELU MLP, 4x expansion.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    layer_pattern="g",
    pos_embed="rope",
    rope_theta=1_000_000.0,
    act="gelu",
    gated_mlp=False,
    norm_eps=1e-5,
)
