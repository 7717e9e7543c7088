"""ZeRO-1 over the HDP ranks (ByteScale §5.1, Fig. 8a).

Port of `repro/parallel/zero1.py`.  HDP replicates the parameters like DP,
so the optimizer state (fp32 master, Adam m and v) is sharded over the HDP
ranks on the first dimension the HDP size divides (`zero1_dim`, the
reference's `zero1_spec` at tp = 1); a leaf with no such dimension stays
replicated.  Each step reduce-scatters the fp32 gradients into this rank's
shard (`reduce_grad`), updates the shard of master, m and v
(`optim/adamw.py`), and all-gathers the bf16 parameters (`gather_leaf`).
A checkpoint holds the state whole: `gather_to_host` gathers it to rank
0's host memory, and a restore gives each rank its `shard` of the file's
leaf, so the state restores at any HDP size.

Under pipeline parallelism the stacked block leaves hold a stage's window
of periods on dim 0, which the reference's `zero1_spec` sees taken by
the ``stage`` axis: ``taken`` names such dimensions, and `stage_taken`
gives them per leaf, so the port shards a stage's ``[n/S, ...]`` leaf on
the same dimension as the reference shards the global ``[n, ...]`` one.

Under tensor parallelism a split leaf's model dimension is taken too
(`with_splits`): the reference's `zero1_spec` sees it taken by the
``model`` axis on the global shape, and every other dimension of the
local slice has its global size, so the port shards a rank's slice on
the dimension the reference shards the global leaf on, over the HDP
group of its model rank.

Where the reference lets XLA lay the collectives out, here a leaf sharded on
a dimension d > 0 is brought into rank-major order block by block (at most
`_CHUNK` elements a block), never as a copy of the whole leaf: the stacked
MLP input of llama3.2-3b alone is ~5.6 GB in fp32.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.parallel.comm import HdpComm
from repro_torch.tree import leaves

_CHUNK = 1 << 24      # elements moved by one collective call (all ranks)


def zero1_dim(shape: Sequence[int], hdp: int,
              taken: Sequence[int] = ()) -> Optional[int]:
    """The dimension ZeRO-1 shards a leaf of ``shape`` on over ``hdp``
    ranks: the first one not in ``taken`` with ``dim % hdp == 0 and dim >
    0``; None (the leaf stays replicated) at hdp <= 1 or when no dimension
    divides."""
    if hdp <= 1:
        return None
    for i, d in enumerate(shape):
        if i not in taken and d > 0 and d % hdp == 0:
            return i
    return None


def stage_owned(params) -> List[bool]:
    """Per leaf of ``params`` (`leaves` order): does it belong to a stage
    under pipeline parallelism (the stacked ``blocks``), rather than being
    replicated over the stages (embed, head blocks, final norm, LM head)?"""
    return leaves({k: [k == "blocks"] * len(leaves(v))
                   for k, v in params.items()})


def stage_taken(params, num_stages: int) -> List[tuple]:
    """Per leaf of ``params``: the dimensions `zero1_dim` must skip, (0,)
    for a stage-owned leaf at ``num_stages > 1`` (the stage axis holds its
    dim 0), else ()."""
    return [(0,) if owned and num_stages > 1 else ()
            for owned in stage_owned(params)]


def with_splits(taken: Sequence[tuple],
                splits: Optional[Sequence[Optional[int]]]) -> List[tuple]:
    """Per leaf, ``taken`` plus its model split dimension (``splits``,
    `parallel/sharding.py::tp_splits`; None: no tensor parallelism)."""
    if splits is None:
        return list(taken)
    return [t + (() if s is None else (s,)) for t, s in zip(taken, splits)]


def shard(x: torch.Tensor, dim: int, rank: int, hdp: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // hdp
    return x.narrow(dim, rank * n, n)


def shard_shape(shape: Sequence[int], dim: int, hdp: int) -> tuple:
    return tuple(s // hdp if i == dim else s for i, s in enumerate(shape))


def _blocks(shape: Sequence[int], dim: int, hdp: int):
    """A leaf of ``shape`` viewed [P, hdp, M] — P the product of the
    dimensions before ``dim``, M the elements of one rank's share of the
    rest, so rank r's shard is [:, r, :] — -> (P, M, the (row slice,
    column slice) blocks that cover a shard, at most `_CHUNK` elements
    each over the ranks).  A block takes part of one row where M is
    large and several whole rows where it is small (a leaf sharded on its
    last dimension, as the vocab-split embedding is), so one collective
    moves up to `_CHUNK` elements either way."""
    p = math.prod(shape[:dim])
    m = math.prod(shape) // (p * hdp)
    step = max(1, _CHUNK // hdp)
    if m >= step:
        return p, m, [(slice(i, i + 1), slice(j, min(m, j + step)))
                      for i in range(p) for j in range(0, m, step)]
    rows = step // m
    return p, m, [(slice(i, min(p, i + rows)), slice(0, m))
                  for i in range(0, p, rows)]


def reduce_grad(g: torch.Tensor, comm: HdpComm,
                taken: Sequence[int] = ()) -> torch.Tensor:
    """The sum over the ranks of the contiguous gradient ``g``: this rank's
    ZeRO-1 shard (contiguous, ``g``'s dtype), or for a replicated leaf the
    whole sum, in place in ``g``."""
    dim = zero1_dim(g.shape, comm.size, taken)
    if dim is None:
        return comm.all_reduce(g)
    p, m, blocks = _blocks(g.shape, dim, comm.size)
    view = g.view(p, comm.size, m)
    out = torch.empty((p, m), dtype=g.dtype, device=g.device)
    for rows, cols in blocks:
        out[rows, cols] = comm.reduce_scatter(
            view[rows, :, cols].transpose(0, 1).contiguous())[0]
    return out.view(shard_shape(g.shape, dim, comm.size))


def _gather_blocks(part: torch.Tensor, shape, dim: int, comm: HdpComm,
                   device=None):
    """Every rank's shard ``part`` (contiguous) of a leaf of ``shape``,
    block by block -> (rows, cols, the block [rows, hdp, cols] on
    ``device``, ``part``'s by default; a host ``part`` goes over block by
    block)."""
    p, m, blocks = _blocks(shape, dim, comm.size)
    src = part.view(p, m)
    device = part.device if device is None else device
    for rows, cols in blocks:
        mine = src[rows, cols].to(device).reshape(-1)
        new = torch.empty((comm.size, *src[rows, cols].shape),
                          dtype=part.dtype, device=device)
        comm.all_gather_into(new.view(-1), mine)
        yield rows, cols, new.transpose(0, 1)


def gather_leaf(out: torch.Tensor, part: torch.Tensor, dim: int,
                comm: HdpComm, sq: bool = False) -> Optional[torch.Tensor]:
    """Writes every rank's shard ``part`` (contiguous) of the contiguous
    leaf ``out`` into it.  ``sq``: returns Σ (new − old)² of ``out`` in
    fp32 over the whole leaf, the same on every rank."""
    view = out.view(math.prod(out.shape[:dim]), comm.size, -1)
    acc = []
    for rows, cols, new in _gather_blocks(part, out.shape, dim, comm):
        if sq:
            acc.append(torch.linalg.vector_norm(
                new.float() - view[rows, :, cols].float()).square())
        view[rows, :, cols] = new
    return torch.stack(acc).sum() if sq else None


def gather_to_host(part: torch.Tensor, full_shape: Sequence[int],
                   comm: HdpComm,
                   taken: Sequence[int] = ()) -> Optional[np.ndarray]:
    """The whole leaf of ``full_shape`` from every rank's ZeRO-1 shard
    ``part`` (contiguous; the whole leaf where `zero1_dim` shards none)
    as a host array on rank 0, None on the other ranks.  Every rank must
    call it.  Block by block, so the device never holds the whole leaf
    (the checkpoint's gather; `shard` of the host array is its
    inverse)."""
    dim = zero1_dim(full_shape, comm.size, taken)
    if dim is None:
        return part.detach().to("cpu", copy=True).numpy() \
            if comm.rank == 0 else None
    return gather_dim_to_host(part, full_shape, dim, comm)


def gather_dim_to_host(part: torch.Tensor, full_shape: Sequence[int],
                       dim: int, comm: HdpComm,
                       device=None) -> Optional[np.ndarray]:
    """The leaf of ``full_shape`` whose [P, size, M] view holds rank r's
    ``part`` (contiguous) at [:, r, :] — sharded on ``dim`` — as a host
    array on rank 0, None on the other ranks.  Every rank must call it;
    the blocks move through ``device`` (`_gather_blocks`)."""
    view = torch.empty(tuple(full_shape), dtype=part.dtype).view(
        math.prod(full_shape[:dim]), comm.size, -1) \
        if comm.rank == 0 else None
    for rows, cols, new in _gather_blocks(part, full_shape, dim, comm,
                                          device):
        if view is not None:
            view[rows, :, cols] = new
    return None if view is None else view.view(tuple(full_shape)).numpy()


def zero1_bytes(params, hdp: int, taken=None) -> dict:
    """Analytic collective bytes of one ZeRO-1 update over the HDP ranks
    (fleet totals, the reference's model): the fp32 gradient reduction
    priced as a ring all-reduce, 2·(hdp − 1)·bytes, and the all-gather of
    the parameters that `zero1_dim` shards, (hdp − 1)·their bytes.
    ``taken``: per leaf, the dimensions `zero1_dim` skips (`stage_taken`;
    default none)."""
    if hdp <= 1:
        return {"zero1_grad_reduce": 0.0, "zero1_param_gather": 0.0}
    ls = leaves(params)
    taken = taken if taken is not None else [()] * len(ls)
    grad_b = sum(x.numel() * 4 for x in ls)
    gather = sum(x.numel() * x.element_size() for x, t in zip(ls, taken)
                 if zero1_dim(x.shape, hdp, t) is not None)
    return {"zero1_grad_reduce": 2.0 * (hdp - 1) * float(grad_b),
            "zero1_param_gather": (hdp - 1) * float(gather)}
