"""Config registry: ``get_config("llama3.2-3b")`` / ``--arch`` resolution.

The port registers the models its layers run: llama3.2-3b,
starcoder2-7b and all of the paper's Table 1 (`paper_models.py`): the
dense LLaMA-7B…70B and the Mixture-of-Experts Mistral-8x7B and 8x22B.
The reference's other assigned models wait for what they add:
qwen3-moe-30b-a3b for q/k norms, deepseek-v2-lite for MLA, and the rest
for their mixers or frontends (ROADMAP queue 1 item 8)."""
from __future__ import annotations

from repro_torch.configs import llama3_2_3b, paper_models, starcoder2_7b
from repro_torch.configs.base import ModelConfig

ALL_CONFIGS = {
    **{m.CONFIG.name: m.CONFIG for m in (llama3_2_3b, starcoder2_7b)},
    **paper_models.PAPER_MODELS,
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in ALL_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_CONFIGS)}")
    return ALL_CONFIGS[name]
