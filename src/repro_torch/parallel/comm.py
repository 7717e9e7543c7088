"""The HDP ranks of one process group: point-to-point permutes and a small
all-gather.

Port of the reference's ``(mesh, hdp_axes)`` pair as its ring code uses
it: ``jax.lax.axis_index`` becomes `HdpComm.rank`, ``jax.lax.ppermute``
`HdpComm.ppermute`, and the block metadata the reference carries through
the ring is all-gathered once per ring call instead (`HdpComm.all_gather`).

`ppermute` keeps ``jax.lax.ppermute``'s semantics: every listed ``(src,
dst)`` pair moves each tensor from rank ``src`` to rank ``dst``, a rank no
pair targets receives zeros, and a receiver gets its own buffer.  Every
rank of the group calls it with the same ``perm`` and tensors of the same
shapes and dtypes.

Two implementations:

* `ProcessGroupComm` — one process per rank over a ``torch.distributed``
  group: ``batch_isend_irecv`` over NCCL for CUDA tensors and over gloo
  for CPU tensors.  It never swaps one backend for the other: a tensor on
  the wrong device raises.
* `ThreadRanks` — g ranks as g threads of one process, exchanging through
  a barrier and a mailbox.  It exists for ``chip_smoke.py`` and the tests
  only, as the one-device counterpart of the reference tests' virtual
  device mesh (``--xla_force_host_platform_device_count``); nothing on the
  main path constructs it.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Sequence, Tuple

import torch

Perm = Sequence[Tuple[int, int]]


class Pending:
    """An issued `ppermute`: `wait` returns the received tensors.  Every
    rank waits on it, senders too (a send is not complete before).  Over
    NCCL the wait orders the current stream after the transfer and does
    not block the host."""

    def __init__(self, works, out: List[torch.Tensor]):
        self._works = works
        self._out = out

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._works = []
        return self._out


class HdpComm:
    """The ranks of one HDP axis: ``rank``, ``size``, `ppermute`,
    `ppermute_async` and `all_gather`."""

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

    def ppermute_async(self, tensors, perm) -> Pending:
        check_perm(perm, self.size)
        dist = self._dist
        tensors = [x.contiguous() for x in tensors]
        self._check(tensors)
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
        return Pending(works, out)

    def all_gather(self, x):
        self._check([x])
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)


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

    def ppermute_async(self, tensors, perm) -> Pending:
        check_perm(perm, self.size)
        _, src = _routes(perm, self.rank)

        def take(mail):
            if src is None:
                return [torch.zeros_like(x) for x in tensors]
            return [x.clone() for x in mail[src]]
        return Pending([], self._ranks._exchange(self.rank, list(tensors),
                                                 take))

    def all_gather(self, x):
        return self._ranks._exchange(self.rank, x, torch.stack)
