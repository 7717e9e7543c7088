"""RWKV-6 'Finch' 7B [arXiv:2404.05892; hf].

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536 — data-dependent
decay, 64 heads of size 64.  Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, RWKVSpec

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                # wkv heads = d_model / head_size
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern="r",
    pos_embed="none",
    gated_mlp=False,             # rwkv channel-mix is its own 2-layer relu^2 MLP
    rwkv=RWKVSpec(head_size=64, decay_lora=64, mix_lora=32, chunk_size=128),
    sub_quadratic=True,
    norm_eps=1e-5,
)
