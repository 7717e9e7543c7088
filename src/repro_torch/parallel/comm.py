"""The HDP ranks of one process group: point-to-point permutes, a small
all-gather, and the collectives of the ZeRO-1 step.

Port of the reference's ``(mesh, hdp_axes)`` pair as its ring code uses
it: ``jax.lax.axis_index`` becomes `HdpComm.rank`, ``jax.lax.ppermute``
`HdpComm.ppermute`, and the block metadata the reference carries through
the ring is all-gathered once per ring call instead (`HdpComm.all_gather`).

`ppermute` keeps ``jax.lax.ppermute``'s semantics: every listed ``(src,
dst)`` pair moves each tensor from rank ``src`` to rank ``dst``, a rank no
pair targets receives zeros, and a receiver gets its own buffer.  Every
rank of the group calls it with the same ``perm`` and tensors of the same
shapes and dtypes.

Three implementations:

* `ProcessGroupComm` — one process per rank over a ``torch.distributed``
  group: ``batch_isend_irecv`` and the collectives over NCCL for CUDA
  tensors and over gloo for CPU tensors.  It never swaps one backend for
  the other: a tensor on the wrong device raises.
* `HostStagedComm` — a gloo group of processes that share one CUDA
  device (NCCL refuses two ranks on one GPU): each CUDA tensor is copied
  to host memory, moved by gloo, and copied back.  Only ``chip_smoke.py``
  and the ``cuda`` tests construct it; no code picks it on its own.
* `ThreadRanks` — g ranks as g threads of one process, exchanging through
  a barrier and a mailbox.  It exists for ``chip_smoke.py`` and the tests
  only, as the one-device counterpart of the reference tests' virtual
  device mesh (``--xla_force_host_platform_device_count``); nothing on the
  main path constructs it.
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, List, Sequence, Tuple

import torch

Perm = Sequence[Tuple[int, int]]


class Pending:
    """An issued `ppermute`: `wait` returns the received tensors.  Every
    rank waits on it, senders too (a send is not complete before).  Over
    NCCL the wait orders the current stream after the transfer and does
    not block the host.  ``device``: where the received tensors go once
    they are in (`HostStagedComm` receives into host memory)."""

    def __init__(self, works, out: List[torch.Tensor], device=None):
        self._works = works
        self._out = out
        self._device = device

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._works = []
        if self._device is not None:
            self._out = [x.to(self._device) for x in self._out]
        return self._out


class HdpComm:
    """The ranks of one HDP axis: ``rank``, ``size``, `ppermute`,
    `ppermute_async`, `all_gather` and the ZeRO-1 step's collectives
    (`all_reduce`, `reduce_scatter`, `all_gather_into`, `broadcast`).
    Every rank of the group calls each of them in the same order with
    tensors of the same shapes and dtypes."""

    rank: int
    size: int

    def ppermute_async(self, tensors: Sequence[torch.Tensor],
                       perm: Perm) -> Pending:
        raise NotImplementedError

    def ppermute(self, tensors: Sequence[torch.Tensor],
                 perm: Perm) -> List[torch.Tensor]:
        return self.ppermute_async(tensors, perm).wait()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x [...] -> [size, ...], rank r's x at row r."""
        raise NotImplementedError

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sums the contiguous ``x`` over the ranks, in place; returns it."""
        raise NotImplementedError

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x [size·n, ...] contiguous -> [n, ...]: this rank's block r (rows
        [r·n, (r+1)·n)) of the sum of every rank's x."""
        raise NotImplementedError

    def all_gather_into(self, out: torch.Tensor, x: torch.Tensor) -> None:
        """Writes every rank's x [n, ...] into the contiguous ``out`` [size·n,
        ...], rank r's at rows [r·n, (r+1)·n)."""
        raise NotImplementedError

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's contiguous ``x`` into every rank's, in place; returns
        it."""
        raise NotImplementedError


def check_perm(perm: Perm, size: int) -> None:
    """Each rank sends at most once and receives at most once, as
    ``jax.lax.ppermute`` requires."""
    srcs = [a for a, _ in perm]
    dsts = [b for _, b in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"perm {list(perm)}: a rank sends or receives twice")
    if any(not 0 <= r < size for r in srcs + dsts):
        raise ValueError(f"perm {list(perm)} names a rank outside "
                         f"[0, {size})")


def _routes(perm: Perm, rank: int):
    """-> (the rank this one sends to or None, the rank it receives from
    or None)."""
    send = [b for a, b in perm if a == rank]
    recv = [a for a, b in perm if b == rank]
    return (send[0] if send else None), (recv[0] if recv else None)


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------

class ProcessGroupComm(HdpComm):
    """The ranks of a ``torch.distributed`` group (default: the world).
    NCCL groups take CUDA tensors, gloo groups CPU tensors.

    The first point-to-point batch of an NCCL group must involve every
    rank, and in a composition such as (1, 2, 1) the singleton ranks send
    nothing, so construction runs one collective over the group."""

    staged = False      # HostStagedComm: tensors cross through host memory

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.backend == "gloo":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"backend {self.backend!r}: the HDP ring runs "
                             f"over nccl (CUDA) or gloo (CPU)")
        self._global = [r if group is None else
                        dist.get_global_rank(group, r)
                        for r in range(self.size)]
        dist.all_reduce(torch.zeros(1, device=self.device), group=group)

    def _check(self, tensors) -> None:
        for x in tensors:
            if x.device.type != self.device.type:
                raise ValueError(
                    f"a {self.backend} group moves {self.device.type} "
                    f"tensors, got one on {x.device}")

    def _wire(self, x: torch.Tensor, copy: bool = True) -> torch.Tensor:
        """``x`` as the backend moves it: itself, or under staging a host
        copy (``copy=False``: an empty host buffer of its shape)."""
        if not self.staged:
            return x
        return x.to("cpu") if copy else torch.empty(x.shape, dtype=x.dtype)

    def ppermute_async(self, tensors, perm) -> Pending:
        check_perm(perm, self.size)
        dist = self._dist
        self._check(tensors)
        tensors = [self._wire(x.contiguous()) for x in tensors]
        dst, src = _routes(perm, self.rank)
        ops, out = [], []
        for x in tensors:
            if src is None:
                out.append(torch.zeros_like(x))
                continue
            if src == self.rank:
                out.append(x.clone())
                continue
            buf = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, buf, self._global[src],
                                  self.group))
            out.append(buf)
        if dst is not None and dst != self.rank:
            ops += [dist.P2POp(dist.isend, x, self._global[dst], self.group)
                    for x in tensors]
        works = dist.batch_isend_irecv(ops) if ops else []
        return Pending(works, out, self.device if self.staged else None)

    def all_gather(self, x):
        self._check([x])
        x = self._wire(x.contiguous())
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts).to(self.device)

    def all_reduce(self, x):
        self._check([x])
        w = self._wire(x)
        self._dist.all_reduce(w, group=self.group)
        if w is not x:
            x.copy_(w)
        return x

    def reduce_scatter(self, x):
        self._check([x])
        w = self._wire(x)
        out = w.new_empty((w.shape[0] // self.size, *w.shape[1:]))
        self._dist.reduce_scatter_tensor(out, w, group=self.group)
        return out.to(self.device)

    def all_gather_into(self, out, x):
        self._check([out, x])
        w, wo = self._wire(x), self._wire(out, copy=False)
        self._dist.all_gather_into_tensor(wo, w, group=self.group)
        if wo is not out:
            out.copy_(wo)

    def broadcast(self, x):
        self._check([x])
        w = self._wire(x)
        self._dist.broadcast(w, src=self._global[0], group=self.group)
        if w is not x:
            x.copy_(w)
        return x


class HostStagedComm(ProcessGroupComm):
    """A gloo group of processes that share one CUDA device: the ranks
    take CUDA tensors, and every transfer copies them to host memory, runs
    the gloo operation, and copies the result back.  NCCL refuses two
    ranks on one GPU, and `ThreadRanks` cannot exchange inside an autograd
    backward on CUDA, so this is how one card runs several ranks of the
    multi-rank trainer.  Its transfers say nothing of a card-to-card
    link.  Only ``chip_smoke.py`` and the ``cuda`` tests construct it."""

    staged = True

    def __init__(self, group=None):
        super().__init__(group)
        if self.backend != "gloo":
            raise ValueError(f"HostStagedComm runs over gloo, the group's "
                             f"backend is {self.backend!r}")
        self.device = torch.device("cuda", torch.cuda.current_device())


def grid(stages: int, hdp: int, tp: int, comm_cls=ProcessGroupComm):
    """This process's three groups of a ``(stages, hdp, tp)`` grid over
    the world -> (its HDP comm, its stage comm, its model comm), ``None``
    for a group of one.

    World rank ``s·(hdp·tp) + h·tp + m`` is stage s, HDP position h, model
    rank m: the reference's ``("stage", "data", "model")`` mesh, model
    fastest.  The model group of (s, h) is the ranks that share s and h,
    the HDP group of (s, m) those that share s and m, the stage group of
    (h, m) those that share h and m.  ``dist.new_group`` must be called
    by every process for every group in one order, so every process
    creates all of them: the model groups, then the HDP groups, then the
    stage groups, each in world order of its first rank.  ``comm_cls`` is
    `ProcessGroupComm` (gloo on the CPU, NCCL one process per card) or
    `HostStagedComm` (gloo, processes sharing a card); its construction
    runs one collective over each group, model group first, then HDP
    group, then stage group, on every rank alike."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if stages * hdp * tp != world:
        raise ValueError(f"a {stages} x {hdp} x {tp} grid needs "
                         f"{stages * hdp * tp} ranks, the world has {world}")
    s, rest = divmod(dist.get_rank(), hdp * tp)
    h, m = divmod(rest, tp)

    def rank(s_, h_, m_):
        return (s_ * hdp + h_) * tp + m_

    def groups(size, members):
        """Every group of ``members``, created in order (None for groups
        of one; the world group itself for one that spans the world)."""
        if size == 1 or size == world:
            return [None] * len(members)
        return [dist.new_group(g) for g in members]

    model_groups = groups(tp, [[rank(a, b, c) for c in range(tp)]
                               for a in range(stages) for b in range(hdp)])
    hdp_groups = groups(hdp, [[rank(a, b, c) for b in range(hdp)]
                              for a in range(stages) for c in range(tp)])
    stage_groups = groups(stages, [[rank(a, b, c) for a in range(stages)]
                                   for b in range(hdp) for c in range(tp)])
    tp_comm = None if tp == 1 else comm_cls(model_groups[s * hdp + h])
    hdp_comm = None if hdp == 1 else comm_cls(hdp_groups[s * tp + m])
    stage_comm = None if stages == 1 else comm_cls(stage_groups[h * tp + m])
    return hdp_comm, stage_comm, tp_comm


def stage_grid(stages: int, hdp: int, comm_cls=ProcessGroupComm):
    """`grid` at tp = 1 -> (this process's HDP comm, its stage comm):
    world rank ``s·hdp + h`` is stage s, HDP position h."""
    hdp_comm, stage_comm, _ = grid(stages, hdp, 1, comm_cls)
    return hdp_comm, stage_comm


def tp_grid(hdp: int, tp: int, comm_cls=ProcessGroupComm):
    """`grid` at one stage -> (this process's HDP comm, its model comm):
    world rank ``h·tp + m`` is HDP position h, model rank m."""
    hdp_comm, _, tp_comm = grid(1, hdp, tp, comm_cls)
    return hdp_comm, tp_comm


# ---------------------------------------------------------------------------
# g ranks as threads of one process (chip_smoke.py and the tests)
# ---------------------------------------------------------------------------

class ThreadRanks:
    """g ranks as g threads of one process on one device: `run` calls
    ``fn(comm)`` in each thread with that rank's `HdpComm` and returns the
    results in rank order.

    It exists for ``chip_smoke.py`` and the tests, as the one-device
    counterpart of the reference tests' virtual-device mesh; nothing on
    the main path constructs it.  One thread runs at a time: a rank holds
    a baton while it runs and hands it on only while it waits at an
    exchange, so the kernel wrappers' launch counts and the device's
    stream see one rank at a time.  Autograd runs the backward of CUDA
    tensors on one device thread for all callers, where one rank's
    exchange would block the others: on a CUDA device call the ring's
    forward and backward directly, not through ``.backward()``.  Grad mode
    is per thread, so ``fn`` sets its own."""

    def __init__(self, size: int, timeout: float = 600.0):
        if size < 1:
            raise ValueError(f"ThreadRanks needs size >= 1, got {size}")
        self.size = size
        self.timeout = timeout
        self._baton = threading.Lock()
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._mail: list = [None] * size

    def _exchange(self, rank: int, item, take):
        """Post ``item``, wait for every rank's, and return ``take`` of them
        all (rank order), called before any rank goes on; the baton is
        released meanwhile."""
        self._mail[rank] = item
        self._baton.release()
        try:
            self._barrier.wait()
            got = take(self._mail)
            self._barrier.wait()           # every rank has taken its part
        finally:
            self._baton.acquire()
        return got

    def run(self, fn: Callable[[HdpComm], object]) -> list:
        results: list = [None] * self.size
        errors: list = []

        def body(rank: int):
            with self._baton:
                try:
                    results[rank] = fn(_ThreadComm(self, rank))
                except BaseException as e:     # noqa: BLE001 — re-raised
                    errors.append((rank, e))
                    self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout)
        if any(t.is_alive() for t in threads):
            self._barrier.abort()
            raise TimeoutError(f"ThreadRanks({self.size}): a rank did not "
                               f"finish in {self.timeout} s")
        if errors:
            first = min(errors, key=lambda e: isinstance(
                e[1], threading.BrokenBarrierError))
            raise RuntimeError(f"rank {first[0]} failed") from first[1]
        self._barrier.reset()
        return results


class _ThreadComm(HdpComm):
    def __init__(self, ranks: ThreadRanks, rank: int):
        self._ranks = ranks
        self.rank = rank
        self.size = ranks.size

    def _exchange(self, item, take):
        return self._ranks._exchange(self.rank, item, take)

    def ppermute_async(self, tensors, perm) -> Pending:
        check_perm(perm, self.size)
        _, src = _routes(perm, self.rank)

        def take(mail):
            if src is None:
                return [torch.zeros_like(x) for x in tensors]
            return [x.clone() for x in mail[src]]
        return Pending([], self._exchange(list(tensors), take))

    def all_gather(self, x):
        return self._exchange(x, torch.stack)

    def all_reduce(self, x):
        x.copy_(self._exchange(x, lambda mail: functools.reduce(torch.add,
                                                                 mail)))
        return x

    def reduce_scatter(self, x):
        r, n = self.rank, self.size
        return self._exchange(x, lambda mail: functools.reduce(
            torch.add, [m.unflatten(0, (n, -1))[r] for m in mail]))

    def all_gather_into(self, out, x):
        out.copy_(self._exchange(x, torch.cat))

    def broadcast(self, x):
        x.copy_(self._exchange(x, lambda mail: mail[0].clone()))
        return x
