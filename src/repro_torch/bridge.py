"""Parameter bridge between the reference's flat checkpoint keys and the
port's parameter tree.

Keys follow the checkpoint flattening (``ckpt/checkpoint.py::flatten``,
the reference's scheme): the tree path joined with "/", list positions
as integers, e.g.
``blocks/0/attn/w_q`` or ``final_norm/scale``.  Leaves are numpy arrays;
bf16 leaves travel as float32 (npz has no bf16) and are cast back to
``cfg.dtype`` here.  The port keeps the reference's layouts, so every
leaf is a plain copy.  No JAX is imported: callers flatten the JAX side
themselves.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import flatten
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import stage_periods
from repro_torch.parallel.sharding import (resolve_device, shard_param,
                                           tp_split_dim)

# leaves kept in float32 whatever the model dtype, as the reference's
# init makes them (npz carries bf16 leaves as float32, so the name
# decides): norm scales, the q/k head norms, the MoE router, and RWKV-6's
# mix and decay bases, bonus, group-norm bias and channel-mix mix
_FP32_LEAVES = ("scale", "router", "q_norm", "k_norm", "mix_base",
                "decay_base", "bonus_u", "bias", "mix_k")
_LIST_NODES = ("blocks", "head_blocks")


def _insert(tree: dict, path: list, leaf) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = leaf


def _listify(node, name=None):
    if not isinstance(node, dict):
        return node
    if name in _LIST_NODES:
        return [_listify(node[str(i)]) for i in range(len(node))]
    return {k: _listify(v, k) for k, v in node.items()}


def params_from_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                     device=None, stage=(0, 1), model=(0, 1)) -> dict:
    """Flat {key: array} -> the port's parameter tree on ``device``
    (default ``cuda``).  ``stage = (s, S)``: pipeline stage s of S takes
    its window of every stacked ``blocks`` leaf
    (`models/transformer.py::stage_periods`) and the other leaves whole.
    ``model = (m, tp)``: model rank m of tp takes its slice of every split
    leaf (`parallel/sharding.py::tp_split_dim`); ``flat`` holds the
    reference's global leaves in its layout at that tp (its ``h_pad``)."""
    device = resolve_device(device)
    dtype = L.activation_dtype(cfg)
    m, tp = model
    kv_sharded = L.gqa_layout(cfg.num_heads, cfg.num_kv_heads,
                              tp).kv_sharded
    tree: dict = {"head_blocks": {}}
    for key, arr in flat.items():
        path = key.split("/")
        leaf_dtype = torch.float32 if path[-1] in _FP32_LEAVES else dtype
        if path[0] == "blocks":
            window = stage_periods(arr.shape[0], stage)
            arr = arr[window.start:window.stop]
        t = torch.tensor(np.asarray(arr, np.float32))
        if tp > 1:
            t = shard_param(t, tp_split_dim(path, t.dim(), kv_sharded),
                            m, tp).clone()
        _insert(tree, path, t.to(device=device, dtype=leaf_dtype))
    return _listify(tree)


def params_to_flat(params) -> Dict[str, np.ndarray]:
    """The port's parameter tree -> flat {key: array} (`ckpt.flatten`):
    bf16 leaves as float32, copies, so a later in-place update of the
    tree does not show in them."""
    return flatten(params)
