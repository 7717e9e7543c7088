"""Fault-tolerant checkpointing: atomic, integrity-checked, async-capable.

Port of `repro/ckpt/checkpoint.py` in its on-disk format:

    <dir>/step_<N>/
        arrays.npz       every leaf, keyed "params/<path>" and "opt/<path>"
                         (`flatten`'s scheme), global shapes, bf16 stored
                         as float32
        manifest.json    {step, sha256 of arrays.npz, data_state, keys}

so either package restores what the other wrote.  A checkpoint becomes
visible only when its directory is renamed from ``.tmp-step_<N>``: a torn
write is never restored.  ``latest_valid_step`` and ``restore_latest``
verify the sha256 and fall back to the newest checkpoint that passes it
(each skip is printed); ``restore`` of a named step raises instead.

ZeRO-1 state is written whole: the Trainer gathers each rank's shards to
rank 0 before ``save`` (`parallel/zero1.py::gather_to_host`), and
``restore(..., comm=)`` gives each rank its `zero1_dim` slice of every
optimiser leaf, so a checkpoint restores at any HDP size.  Under
pipeline parallelism the Trainer also gathers every stage's window of the
stacked blocks to world rank 0, so the file keeps the single global
layout, and ``restore(..., stage=(s, S))`` slices stage s's window of a
stacked leaf before its ZeRO-1 shard (which skips the stage's dim 0):
a checkpoint restores at any stage count too.  Under tensor parallelism
the Trainer gathers every model rank's slices to world rank 0 as well, and
``restore(..., model=(m, tp, splits))`` slices model rank m's part of a
split leaf before its ZeRO-1 shard (which skips the split dimension): a
checkpoint restores at any tp whose layout has the file's shapes (the
same ``h_pad``), and raises naming the shape otherwise.

Where the reference holds whole files and trees in memory, here the
sha256 is read in chunks, and ``restore`` reads one leaf at a time and
copies it into the ``like`` trees in place (the card never holds a second
copy of the state), after checking every key and shape against the file.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import stage_periods
from repro_torch.parallel.zero1 import shard, shard_shape, zero1_dim
from repro_torch.tree import leaf_paths

_HASH_CHUNK = 1 << 24       # bytes read per sha256 update
_STATE_KEYS = ("master", "m", "v")   # the optimiser leaves ZeRO-1 shards


def _host(leaf) -> np.ndarray:
    """A host copy of a tensor leaf (bf16 as float32, npz has no bf16);
    a numpy leaf as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        return t.to("cpu", dtype, copy=True).numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def named_leaves(tree, prefix=()):
    """(key, leaf) pairs: the tree path's dict keys (sorted, jax's order)
    and list positions joined with "/", the reference's `_flatten` key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def flatten(tree) -> Dict[str, np.ndarray]:
    """A tree of tensors (or numpy arrays) -> {key: host array}.  Tensors
    are copied, so a later in-place update of the tree does not show in
    the arrays."""
    return {key: _host(leaf) for key, leaf in named_leaves(tree)}


def sha256_file(path: str) -> str:
    """The file's sha256, read in chunks (the reference's digest of the
    whole file without holding it in memory)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _npz_shape(arrays, key: str) -> tuple:
    """The shape of one npz member from its header, without reading it."""
    with arrays.zip.open(key + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read = np.lib.format.read_array_header_1_0 if version == (1, 0) \
            else np.lib.format.read_array_header_2_0
        return tuple(read(f)[0])


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # the last save's seconds and bytes: snapshot_s (blocks the
        # caller), write_s and hash_s (the writer), bytes (arrays.npz)
        self.last_save: Dict[str, float] = {}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, params, opt_state, data_state: Dict,
             block: bool = False):
        """Writes step ``step``.  The previous write is waited for first,
        so the host holds one snapshot at a time; the snapshot (host
        copies of every leaf) is taken before the writer starts."""
        self.wait()
        t0 = time.perf_counter()
        flat = {"params/" + k: v for k, v in flatten(params).items()}
        flat.update({"opt/" + k: v for k, v in flatten(opt_state).items()})
        self.last_save = {"snapshot_s": time.perf_counter() - t0}

        def work():
            try:
                self._write(step, flat, data_state)
            except Exception as e:      # re-raised by wait()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def wait(self):
        """Joins the writer; raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _write(self, step: int, flat: Dict[str, np.ndarray], data_state):
        tmp = os.path.join(self.dir, f".tmp-step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        npz_path = os.path.join(tmp, "arrays.npz")
        t0 = time.perf_counter()
        np.savez(npz_path, **flat)
        t1 = time.perf_counter()
        sha = sha256_file(npz_path)
        self.last_save.update(write_s=t1 - t0,
                              hash_s=time.perf_counter() - t1,
                              bytes=float(os.path.getsize(npz_path)))
        manifest = {"step": step, "sha256": sha, "data_state": data_state,
                    "keys": sorted(flat)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)                             # atomic commit
        self._gc()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return max(steps) if steps else None

    # ------------------------------------------------------------------
    def _verified_manifest(self, step: int) -> Optional[Dict]:
        """The step's manifest iff the payload passes the sha256 check;
        None on any damage (missing/corrupt manifest or arrays)."""
        d = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            sha = sha256_file(os.path.join(d, "arrays.npz"))
        except (OSError, ValueError):
            return None
        return manifest if sha == manifest.get("sha256") else None

    def latest_valid_step(self) -> Optional[int]:
        """Newest step whose payload passes integrity (None if none do)."""
        state = self.latest_valid_state()
        return state[0] if state else None

    def latest_valid_state(self) -> Optional[Tuple[int, Dict]]:
        """(step, data_state) of the newest checkpoint passing integrity:
        one read and hash, no array loading."""
        for s in sorted(self.steps(), reverse=True):
            manifest = self._verified_manifest(s)
            if manifest is not None:
                return s, manifest["data_state"]
        return None

    def read_data_state(self, step: int) -> Optional[Dict]:
        """The step's ``data_state`` without loading arrays (integrity-
        checked)."""
        manifest = self._verified_manifest(step)
        return None if manifest is None else manifest["data_state"]

    def restore_latest(self, params_like, opt_like, comm=None,
                       stage=(0, 1), model=None):
        """Restore the newest checkpoint that passes integrity, skipping
        (and printing) damaged ones.  Returns ``(step, params, opt_state,
        data_state)`` or None when no valid checkpoint exists."""
        for s in sorted(self.steps(), reverse=True):
            try:
                params, opt, ds = self.restore(s, params_like, opt_like,
                                               comm, stage, model)
            except (OSError, KeyError, ValueError) as e:
                print(f"checkpoint step {s} skipped: {e}", flush=True)
                continue
            return s, params, opt, ds
        return None

    def restore(self, step: int, params_like, opt_like, comm=None,
                stage=(0, 1), model=None):
        """-> (params, opt_state, data_state): the ``like`` trees, their
        leaves overwritten in place with the file's (each keeps its dtype
        and device).  With ``comm`` (the HDP ranks) an optimiser leaf
        that `zero1_dim` shards over ``comm.size`` receives this rank's
        shard, the dimension taken from the parameter's full shape.
        ``stage = (s, S)``: the ``like`` trees hold pipeline stage s's
        window of every stacked ``blocks`` leaf, which receives those rows
        of the file's global leaf (and at S > 1 its ZeRO-1 shard skips
        dim 0).  ``model = (m, tp, splits)``: the ``like`` trees hold model
        rank m's slices of the split leaves (``splits``: per params leaf,
        `leaves` order, its split dimension or None), which receive those
        slices of the file's global leaves (their ZeRO-1 shards skip the
        split dimension).  Raises IOError when the sha256 fails, KeyError
        or ValueError when a key is missing or a shape differs, before any
        leaf is written."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        npz_path = os.path.join(d, "arrays.npz")
        if sha256_file(npz_path) != manifest["sha256"]:
            raise IOError(f"checkpoint step {step}: integrity check failed")
        hdp, rank = (1, 0) if comm is None else (comm.size, comm.rank)
        num = stage[1]
        m, tp, splits = (0, 1, None) if model is None else model
        split_of = {"/".join(path): sp for (path, _), sp in zip(
            leaf_paths(params_like),
            splits or [None] * len(leaf_paths(params_like)))}
        params = dict(named_leaves(params_like))

        def shapes(key):
            """A params key -> (its file shape, its stage window's rows or
            None, its model split dimension or None)."""
            full = list(params[key].shape)
            split = split_of[key]
            if split is not None:
                full[split] *= tp
            if key.split("/")[0] != "blocks":
                return tuple(full), None, split
            full[0] *= num
            return tuple(full), stage_periods(full[0], stage), split

        # (file key, like leaf, the file's shape, window rows, model split,
        # shard dim)
        plan = [("params/" + key, leaf, *shapes(key), None)
                for key, leaf in params.items()]
        for key, leaf in named_leaves(opt_like):
            top, _, rest = key.partition("/")
            if top in _STATE_KEYS:
                full, rows, split = shapes(rest)
                taken = ((0,) if rows is not None and num > 1 else ()) \
                    + (() if split is None else (split,))
                dim = zero1_dim(tuple(params[rest].shape), hdp, taken)
                plan.append(("opt/" + key, leaf, full, rows, split, dim))
            else:
                plan.append(("opt/" + key, leaf, tuple(leaf.shape), None,
                             None, None))
        with np.load(npz_path) as arrays:
            for key, leaf, full, rows, split, dim in plan:
                if key not in arrays.files:
                    raise KeyError(f"checkpoint step {step}: no {key!r}")
                mine = full if rows is None else (len(rows),) + full[1:]
                if split is not None:
                    mine = shard_shape(mine, split, tp)
                if dim is not None:
                    mine = shard_shape(mine, dim, hdp)
                got = _npz_shape(arrays, key)
                if got != full or tuple(leaf.shape) != mine:
                    raise ValueError(
                        f"checkpoint step {step}: {key} has shape {got} for "
                        f"a leaf of {tuple(leaf.shape)}, want {full}")
            for key, leaf, _, rows, split, dim in plan:   # a leaf at a time
                x = torch.from_numpy(arrays[key])
                if rows is not None:
                    x = x[rows.start:rows.stop]
                if split is not None:
                    x = shard(x, split, m, tp)
                if dim is not None:
                    x = shard(x, dim, rank, hdp)
                leaf.copy_(x)
        return params_like, opt_like, manifest["data_state"]
