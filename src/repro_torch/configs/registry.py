"""Config registry: ``get_config("llama3.2-3b")`` / ``--arch`` resolution.

The port registers the dense models its layers run: llama3.2-3b,
starcoder2-7b and the paper's LLaMA-7B…70B (`paper_models.py`, Table 1).
The paper's Mistral entries are copied with that module and stay
unregistered until MoE is ported (ROADMAP queue 1 item 6)."""
from __future__ import annotations

from repro_torch.configs import llama3_2_3b, paper_models, starcoder2_7b
from repro_torch.configs.base import ModelConfig

ALL_CONFIGS = {
    **{m.CONFIG.name: m.CONFIG for m in (llama3_2_3b, starcoder2_7b)},
    **{c.name: c for c in (paper_models.LLAMA_7B, paper_models.LLAMA_13B,
                           paper_models.LLAMA_30B, paper_models.LLAMA_70B)},
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in ALL_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_CONFIGS)}")
    return ALL_CONFIGS[name]
