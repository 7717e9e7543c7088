"""The port's runtime: what model code needs to know about placement.

Port of `repro/parallel/sharding.py::Runtime` and of its rule table
(`param_spec` / `params_pspecs`) for the attention decoders.  There is no
mesh: the HDP ranks are ``comm`` (a `parallel.comm.HdpComm`, the
reference's ``(mesh, hdp_axes)``); ``None`` is one rank, where every
composition is ``(1,)``.  A composition must sum
to the HDP size; left out, it is all singletons.  The device defaults to
``cuda``; without a GPU the caller must ask for ``device="cpu"``
explicitly — a runtime never falls back to the CPU on its own.

Under pipeline parallelism (`parallel/pipeline.py`) ``stage_comm`` holds
the ranks of this rank's stage group, one per stage at the same HDP
position and model rank (the reference's ``stage_axis``); ``None`` is one
stage.
``hdp_size`` stays the size of the HDP group, not of the world, as the
reference's leaves the stage axis out (`launch/mesh.py::NON_HDP_AXES`).

``remat="offload"`` with ``offload_periods = k`` is the reference's
selective offload: the first k layer periods keep their input residual in
host memory between the forward and the recompute of the backward
(`parallel/host_offload.py`), the rest are recomputed from a residual
kept on the device.  ``offload_store`` holds the host buffers, and k > 0
needs one; the trainer hands one store to every wave, so the buffers are
reused from wave to wave.

Under tensor parallelism ``tp_comm`` holds this rank's model group (the
reference's ``model_axis``; `parallel/comm.py::grid` lays out stage x
HDP x model ranks), ``None`` is tp = 1; it combines with stages and with
offload.  Each rank holds its slice of the split leaves: `tp_split_dim`
is the reference's rule table (``w_q``, ``w_in``, ``w_gate``,
``lm_head``, the shared experts' ``shared_in`` / ``shared_gate``
column-parallel; ``w_o``, ``w_out``, ``shared_out`` row-parallel;
``embed`` by vocabulary rows; ``w_kv`` by KV head where the layout shards
KV; the experts' [E, ...] leaves and MLA's ``w_uk`` / ``w_uv`` on their
first dimension; norms, the router, MLA's ``w_dkv`` and latent norm
replicated; RWKV-6's time mix by WKV head: ``w_r``, ``w_k``, ``w_v``,
``w_g``, ``decay_b`` column-parallel, ``w_o`` row-parallel,
``decay_base``, ``bonus_u`` and ``ln_x`` on their heads, the mix and decay
LoRAs' inputs replicated, and its channel mix's ``w_k`` / ``w_v`` column-
and row-parallel), and `shard_param` takes the slice.  The Mamba leaves
raise `NotImplementedError` at tp > 1 (`TP_LATER`).

A runtime on the card refuses TF32 matmuls: float32 products stay IEEE
fp32, as the reference's on the CPU, and the MoE router's top-k hangs on
its product (`models/moe.py`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ring import ATTN_IMPLS, check_composition
from repro_torch.models.layers import gqa_layout
from repro_torch.parallel.comm import HdpComm
from repro_torch.tree import leaf_paths

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
    stage_comm: Optional[HdpComm] = None   # the stage group; None: one
                                           # stage
    tp_comm: Optional[HdpComm] = None      # the model group; None: tp 1
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
        return 1 if self.tp_comm is None else self.tp_comm.size

    @property
    def model_rank(self) -> int:
        return 0 if self.tp_comm is None else self.tp_comm.rank

    @property
    def hdp_size(self) -> int:
        return 1 if self.comm is None else self.comm.size

    @property
    def num_stages(self) -> int:
        return 1 if self.stage_comm is None else self.stage_comm.size

    @property
    def stage_rank(self) -> int:
        return 0 if self.stage_comm is None else self.stage_comm.rank

    def with_composition(self, comp: Tuple[int, ...]) -> "Runtime":
        """The same runtime running ``comp`` (raises unless it sums to
        the HDP size)."""
        return dataclasses.replace(self, composition=tuple(comp))

    def layout(self, cfg: ModelConfig):
        return gqa_layout(cfg.num_heads, cfg.num_kv_heads, self.tp)


# ---------------------------------------------------------------------------
# the tensor-parallel rule table (the reference's param_spec)
# ---------------------------------------------------------------------------

TP_LATER = "ROADMAP queue 1 item 8 (Mamba's TP rules come with its model)"

# (parent, leaf) -> the split dimension from the leaf's own first one
# (-1: its last; "kv": w_kv [d, 2, G, Dk] on G iff KV is sharded); None:
# replicated.  "moe" leaves: the [E, ...] experts on E, the shared experts
# column- and row-parallel, the router replicated.  MLA: w_uk / w_uv
# [H, ...] on their heads, the shared latent (w_dkv, latent_norm)
# replicated.  RWKV-6 (the reference's `_ssm_param_specs`): the time
# mix's projections and decay_b column-parallel, w_o row-parallel,
# decay_base, bonus_u [H, N] and ln_x on their WKV heads, the mix and
# decay LoRAs' other leaves replicated; the channel mix's w_k / w_v
# column- and row-parallel, its mix_k replicated.
_RULES = {("attn", "w_q"): -1, ("mlp", "w_in"): -1, ("mlp", "w_gate"): -1,
          ("attn", "w_o"): 0, ("mlp", "w_out"): 0, ("attn", "w_kv"): "kv",
          ("attn", "q_norm"): None, ("attn", "k_norm"): None,
          ("attn", "w_uk"): 0, ("attn", "w_uv"): 0, ("attn", "w_dkv"): None,
          ("latent_norm", "scale"): None,
          ("moe", "w_in"): 0, ("moe", "w_gate"): 0, ("moe", "w_out"): 0,
          ("moe", "shared_in"): -1, ("moe", "shared_gate"): -1,
          ("moe", "shared_out"): 0, ("moe", "router"): None,
          ("norm1", "scale"): None, ("norm2", "scale"): None,
          ("postnorm1", "scale"): None, ("postnorm2", "scale"): None,
          ("final_norm", "scale"): None,
          **{("time_mix", w): -1 for w in ("w_r", "w_k", "w_v", "w_g",
                                            "decay_b")},
          ("time_mix", "w_o"): 0, ("time_mix", "decay_base"): 0,
          ("time_mix", "bonus_u"): 0, ("ln_x", "scale"): 0,
          ("ln_x", "bias"): 0,
          **{("time_mix", w): None for w in ("mix_base", "mix_a", "mix_b",
                                              "decay_a")},
          ("channel_mix", "w_k"): -1, ("channel_mix", "w_v"): 0,
          ("channel_mix", "mix_k"): None}


def tp_split_dim(path: Sequence[str], ndim: int,
                 kv_sharded: bool) -> Optional[int]:
    """The dimension a leaf is split on over the model group, or None
    (replicated): the reference's `param_spec` (`_RULES`; ``embed`` on its
    rows, ``lm_head`` on its columns).  ``path``: the leaf's keys from the
    root (``("blocks", "0", "attn", "w_q")``), ``ndim`` its dimensions as
    held (a stacked ``blocks`` leaf has its [n_periods] dim first; a
    ``head_blocks`` leaf is one layer's).  The Mamba leaves, and any leaf
    the table does not know, raise `NotImplementedError`."""
    path = [str(p) for p in path]
    if path in (["embed"], ["lm_head"]):
        return 0 if path[0] == "embed" else 1
    rule = _RULES.get(tuple(path[-2:]), "later")
    if rule == "later":
        raise NotImplementedError(
            f"{'/'.join(path)}: its tensor-parallel rule comes with "
            f"{TP_LATER}")
    if rule is None:
        return None
    off = 1 if path[0] == "blocks" else 0
    if rule == "kv":
        return off + 2 if kv_sharded else None
    return ndim - 1 if rule == -1 else off


def check_tp_divides(cfg: ModelConfig, tp: int) -> None:
    """ValueError unless ``tp`` divides the vocabulary, the MoE's experts,
    MLA's heads, RWKV-6's WKV heads and the width ``d_ff`` of a dense
    model's MLP or channel mix, whose leaves split on them.  The reference runs
    an E that tp does not divide through ``"gather"`` with GSPMD's uneven
    shards (`src/repro/models/transformer.py:283`), and MLA's heads so
    too: this is the one place the port raises where it does not."""
    rwkv = cfg.rwkv is not None and "r" in cfg.layer_pattern
    for what, n in (("vocabulary", cfg.vocab_size),
                    ("experts", cfg.moe.num_experts if cfg.moe else 0),
                    ("MLA heads", cfg.num_heads if cfg.mla else 0),
                    ("WKV heads",
                     cfg.d_model // cfg.rwkv.head_size if rwkv else 0),
                    ("d_ff columns", 0 if cfg.moe else cfg.d_ff)):
        if n % tp:
            raise ValueError(f"{cfg.name}: {n} {what} do not split over "
                             f"{tp} model ranks")


def tp_splits(params, kv_sharded: bool, tp: int) -> List[Optional[int]]:
    """Per leaf of ``params`` (`leaves` order): its `tp_split_dim`, all
    None at tp = 1."""
    return [None if tp == 1 else tp_split_dim(path, x.dim(), kv_sharded)
            for path, x in leaf_paths(params)]


def shard_param(x, dim: Optional[int], rank: int, tp: int):
    """Model rank ``rank``'s slice of the global leaf ``x`` split on
    ``dim`` over ``tp`` ranks (a view; ``x`` itself where ``dim`` is
    None).  Raises unless ``tp`` divides the dimension."""
    if dim is None:
        return x
    if x.shape[dim] % tp:
        raise ValueError(f"a leaf of shape {tuple(x.shape)} does not split "
                         f"over {tp} model ranks on dim {dim}")
    n = x.shape[dim] // tp
    return x.narrow(dim, rank * n, n)
