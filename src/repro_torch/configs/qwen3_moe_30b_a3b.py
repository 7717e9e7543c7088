"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) moe d_ff=768 vocab=151936 — 128 experts,
top-8, every layer MoE, qk-norm, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    layer_pattern="g",
    qk_norm=True,
    pos_embed="rope",
    rope_theta=1_000_000.0,
    act="silu",
    gated_mlp=True,
    moe=MoESpec(num_experts=128, top_k=8, d_expert=768,
                router_norm_topk=True),
)
