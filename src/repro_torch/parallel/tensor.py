"""Tensor parallelism over the model group: the two Megatron functions.

In the reference TP is a sharding annotation on the ``"model"`` mesh axis
and XLA inserts the collectives.  Here each rank of the model group
(``Runtime.tp_comm``, a `parallel.comm.HdpComm`) holds its slice of the
split leaves (`parallel/sharding.py::tp_split_dim`), and the layers call
the two functions where the reference's shardings change:

* `copy_to_model` before a column-parallel product: the identity in the
  forward, the sum of the ranks' partial input gradients in the backward;
* `reduce_from_model` after a row-parallel product (or the vocab-parallel
  embedding lookup): the sum of the ranks' partial outputs in the
  forward, the identity in the backward.

Every rank of the group calls each in the same order with tensors of the
same shape.  ``comm=None`` (tp = 1) returns the input itself.
"""
from __future__ import annotations

import torch


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_reduce(g.contiguous().clone())


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        return comm.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return None, g


def copy_to_model(x: torch.Tensor, comm) -> torch.Tensor:
    """``x`` (replicated over the model group) as the input of this rank's
    slice of a split product: its gradient is summed over the group."""
    return x if comm is None else _CopyToModel.apply(comm, x)


def reduce_from_model(x: torch.Tensor, comm) -> torch.Tensor:
    """This rank's partial ``x`` summed over the model group."""
    return x if comm is None else _ReduceFromModel.apply(comm, x)
