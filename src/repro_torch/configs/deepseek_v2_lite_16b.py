"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434; hf].

27L d_model=2048 16H (MLA) moe d_ff=1408 vocab=102400 — MLA kv_lora_rank=512,
2 shared + 64 routed experts top-6, first layer dense (d_ff 10944).
"""
from repro_torch.configs.base import ModelConfig, MoESpec, MLASpec

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,             # MLA: all heads share the latent KV
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    layer_pattern="g",
    pos_embed="rope",
    rope_theta=10_000.0,
    act="silu",
    gated_mlp=True,
    moe=MoESpec(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                first_k_dense=1, dense_d_ff=10944,
                router_norm_topk=False),
    mla=MLASpec(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                v_head_dim=128, q_lora_rank=0),
)
