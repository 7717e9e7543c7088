"""The port's runtime: what model code needs to know about placement.

Port of `repro/parallel/sharding.py::Runtime`: there is no mesh and
tensor parallelism is 1.  The HDP ranks are ``comm`` (a
`parallel.comm.HdpComm`, the reference's ``(mesh, hdp_axes)``); ``None``
is one rank, where every composition is ``(1,)``.  A composition must sum
to the HDP size; left out, it is all singletons.  The device defaults to
``cuda``; without a GPU the caller must ask for ``device="cpu"``
explicitly — a runtime never falls back to the CPU on its own.

``remat="offload"`` with ``offload_periods = k`` is the reference's
selective offload: the first k layer periods keep their input residual in
host memory between the forward and the recompute of the backward
(`parallel/host_offload.py`), the rest are recomputed from a residual
kept on the device.  ``offload_store`` holds the host buffers, and k > 0
needs one; the trainer hands one store to every wave, so the buffers are
reused from wave to wave.

A runtime on the card refuses TF32 matmuls: float32 products stay IEEE
fp32, as the reference's on the CPU, and the MoE router's top-k hangs on
its product (`models/moe.py`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ring import ATTN_IMPLS, check_composition
from repro_torch.models.layers import gqa_layout
from repro_torch.parallel.comm import HdpComm

if TYPE_CHECKING:
    from repro_torch.parallel.host_offload import HostOffload


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


REMATS = ("none", "full", "offload")


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
                                      # (models.transformer._Period) |
                                      # offload: full, the first
                                      # offload_periods periods' inputs
                                      # in host memory
    offload_periods: int = 0
    comm: Optional[HdpComm] = None    # the HDP ranks; None: one rank
    offload_store: Optional["HostOffload"] = field(
        default=None, compare=False, repr=False)   # needed at k > 0

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        comp = (1,) * self.hdp_size if self.composition is None \
            else tuple(self.composition)
        check_composition(comp, self.hdp_size)
        object.__setattr__(self, "composition", comp)
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{ATTN_IMPLS}")
        if self.remat not in REMATS:
            raise ValueError(f"remat {self.remat!r} not in {REMATS}")
        if (self.device.type == "cuda"
                and torch.backends.cuda.matmul.allow_tf32):
            raise ValueError("torch.backends.cuda.matmul.allow_tf32 is on: "
                             "the port's float32 products (the MoE "
                             "router's among them) must stay IEEE fp32")
        if self.offload_periods < 0:
            raise ValueError(f"offload_periods {self.offload_periods} < 0")

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
