"""Config registry: ``get_config("llama3.2-3b")`` / ``--arch`` resolution.

The port registers the models its layers run: llama3.2-3b,
starcoder2-7b, the Gemma-style decoders gemma2-9b and gemma3-12b (local
and global layers, softcaps, post-block and q/k norms, the embedding
scale), the Mixture-of-Experts qwen3-moe-30b-a3b (q/k norms, 128 experts
top-8) and deepseek-v2-lite-16b (Multi-head Latent Attention, two shared
experts and a dense head layer), the attention-free rwkv6-7b (RWKV-6
time and channel mixes), and all of the paper's Table 1
(`paper_models.py`): the dense LLaMA-7B…70B and the Mixture-of-Experts
Mistral-8x7B and 8x22B.  The reference's other assigned models wait for
their mixers or frontends (ROADMAP queue 1 item 8: Mamba for jamba, the
embeds frontends and M-RoPE)."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_lite_16b, gemma2_9b,
                                 gemma3_12b, llama3_2_3b, paper_models,
                                 qwen3_moe_30b_a3b, rwkv6_7b,
                                 starcoder2_7b)
from repro_torch.configs.base import ModelConfig

ALL_CONFIGS = {
    **{m.CONFIG.name: m.CONFIG for m in (llama3_2_3b, starcoder2_7b,
                                           gemma2_9b, gemma3_12b,
                                           qwen3_moe_30b_a3b,
                                           deepseek_v2_lite_16b, rwkv6_7b)},
    **paper_models.PAPER_MODELS,
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in ALL_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_CONFIGS)}")
    return ALL_CONFIGS[name]
