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
from repro_torch.parallel.sharding import resolve_device

# leaves kept in float32 whatever the model dtype (norm scales, the MoE
# router)
_FP32_LEAVES = ("scale", "router")
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
                     device=None) -> dict:
    """Flat {key: array} -> the port's parameter tree on ``device``
    (default ``cuda``)."""
    device = resolve_device(device)
    dtype = L.activation_dtype(cfg)
    tree: dict = {"head_blocks": {}}
    for key, arr in flat.items():
        path = key.split("/")
        leaf_dtype = torch.float32 if path[-1] in _FP32_LEAVES else dtype
        t = torch.tensor(np.asarray(arr, np.float32))
        _insert(tree, path, t.to(device=device, dtype=leaf_dtype))
    return _listify(tree)


def params_to_flat(params) -> Dict[str, np.ndarray]:
    """The port's parameter tree -> flat {key: array} (`ckpt.flatten`):
    bf16 leaves as float32, copies, so a later in-place update of the
    tree does not show in them."""
    return flatten(params)
