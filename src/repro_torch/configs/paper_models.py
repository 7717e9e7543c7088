"""The models ByteScale evaluates (Table 1) — used by the benchmark suite.

| Model          | #Layers | #Heads | #Groups | Hidden |
|----------------|---------|--------|---------|--------|
| LLaMA-7B       | 32      | 32     | 8       | 4096   |
| LLaMA-13B      | 40      | 40     | 8       | 5120   |
| LLaMA-30B      | 60      | 56     | 8       | 6656   |
| LLaMA-70B      | 80      | 64     | 8       | 8192   |
| Mistral-8x7B   | 32      | 32     | 8       | 4096 (topk=2) |
| Mistral-8x22B  | 56      | 48     | 8       | 6144 (topk=2) |
"""
from repro_torch.configs.base import ModelConfig, MoESpec


def _llama(name, layers, heads, hidden, d_ff, vocab=32000):
    return ModelConfig(
        name=name, family="dense", num_layers=layers, d_model=hidden,
        num_heads=heads, num_kv_heads=8, head_dim=hidden // heads, d_ff=d_ff,
        vocab_size=vocab, layer_pattern="g", pos_embed="rope",
        rope_theta=500_000.0, act="silu", gated_mlp=True, norm_eps=1e-5)


LLAMA_7B = _llama("llama-7b", 32, 32, 4096, 11008)
LLAMA_13B = _llama("llama-13b", 40, 40, 5120, 13824)
LLAMA_30B = _llama("llama-30b", 60, 56, 6656, 17920)
LLAMA_70B = _llama("llama-70b", 80, 64, 8192, 28672)

MISTRAL_8X7B = ModelConfig(
    name="mistral-8x7b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=32000,
    layer_pattern="g", pos_embed="rope", rope_theta=1_000_000.0, act="silu",
    gated_mlp=True, norm_eps=1e-5,
    moe=MoESpec(num_experts=8, top_k=2, d_expert=14336))

MISTRAL_8X22B = ModelConfig(
    name="mistral-8x22b", family="moe", num_layers=56, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=32000,
    layer_pattern="g", pos_embed="rope", rope_theta=1_000_000.0, act="silu",
    gated_mlp=True, norm_eps=1e-5,
    moe=MoESpec(num_experts=8, top_k=2, d_expert=16384))

PAPER_MODELS = {m.name: m for m in (
    LLAMA_7B, LLAMA_13B, LLAMA_30B, LLAMA_70B, MISTRAL_8X7B, MISTRAL_8X22B)}
