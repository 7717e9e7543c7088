"""Config registry: ``get_config("llama3.2-3b")``.

The serving slice of the port knows the one model it runs; other
architectures join as their layers are ported."""
from __future__ import annotations

from repro_torch.configs import llama3_2_3b
from repro_torch.configs.base import ModelConfig

ALL_CONFIGS = {m.CONFIG.name: m.CONFIG for m in (llama3_2_3b,)}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in ALL_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_CONFIGS)}")
    return ALL_CONFIGS[name]
