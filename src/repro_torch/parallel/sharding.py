"""The port's runtime: what model code needs to know about placement.

Port of `repro/parallel/sharding.py::Runtime`: there is no mesh and
tensor parallelism is 1.  The HDP ranks are ``comm`` (a
`parallel.comm.HdpComm`, the reference's ``(mesh, hdp_axes)``); ``None``
is one rank, where every composition is ``(1,)``.  A composition must sum
to the HDP size; left out, it is all singletons.  The device defaults to
``cuda``; without a GPU the caller must ask for ``device="cpu"``
explicitly — a runtime never falls back to the CPU on its own.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ring import ATTN_IMPLS, check_composition
from repro_torch.models.layers import gqa_layout
from repro_torch.parallel.comm import HdpComm


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means ``cuda``.  Raises if a CUDA device is asked for (or
    defaulted to) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU (the port never falls back to it on its own)")
        if dev.index is None:            # tensors report "cuda:<index>"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Runtime:
    device: Optional[Union[str, torch.device]] = None
    composition: Optional[Tuple[int, ...]] = None   # None: all singletons
    attn_impl: str = "flash"          # flash (the kernel; its plain version
                                      # on the CPU) | ref (plain oracle)
    attn_block_q: int = 64            # flash kernel tile rows
    attn_block_k: int = 64
    kv_chunk: int = 1024              # ref path KV chunk
    block_skip: bool = True
    remat: str = "full"               # none | full: recompute each layer
                                      # period in the backward
                                      # (torch.utils.checkpoint)
    comm: Optional[HdpComm] = None    # the HDP ranks; None: one rank

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        comp = (1,) * self.hdp_size if self.composition is None \
            else tuple(self.composition)
        check_composition(comp, self.hdp_size)
        object.__setattr__(self, "composition", comp)
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{ATTN_IMPLS}")
        if self.remat == "offload":
            raise NotImplementedError(
                "remat='offload' (selective activation offload) comes with "
                "the offload slice of the port (ROADMAP queue 1 item 4)")
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat {self.remat!r} not in ('none', 'full')")

    @property
    def tp(self) -> int:
        return 1

    @property
    def hdp_size(self) -> int:
        return 1 if self.comm is None else self.comm.size

    def with_composition(self, comp: Tuple[int, ...]) -> "Runtime":
        """The same runtime running ``comp`` (raises unless it sums to
        the HDP size)."""
        return dataclasses.replace(self, composition=tuple(comp))

    def layout(self, cfg: ModelConfig):
        return gqa_layout(cfg.num_heads, cfg.num_kv_heads, self.tp)
