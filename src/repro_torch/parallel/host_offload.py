"""Selective activation offload: the host side of ``remat="offload"``.

The counterpart of the reference's host-offload probes
(`repro/compat.py`: ``host_offload_memory_kind``, ``offload_policy``,
``device_memory_stats``) and of XLA's host-offload machinery, which moves
the remat policy's "resid" entries to ``pinned_host`` memory in the
forward and back in the backward (`repro/models/transformer.py`).

`HostOffload` holds one host buffer per offloaded layer period, and moves
a period's input residual between it and the device:

* forward (`save`, `release`): the device-to-host copy of period i runs
  on a copy stream of its own, after an event on the compute stream, so
  it overlaps period i's compute; once period i's kernels are queued, the
  compute stream waits on the copy's event, so the device tensor, freed
  after that on the compute stream, is reused only after the copy (a
  ``record_stream`` would instead hold the block until the host, which
  runs ahead of the card, sees the copy finish).
* backward (`prefetch`, `load`): when the backward reaches period j, the
  host-to-device copy of period j - 1 is issued on the copy stream, so it
  overlaps period j's recompute and backward; the periods come back in
  FILO order (k - 1 first), and the compute stream waits on the copy's
  event before it reads the tensor.  That is Eq. 3's premise, T(s) >=
  Act(s)·r / B (`core/offload.py`): the transfer hides under compute.

The host buffers are pinned on CUDA, so the copies are asynchronous DMA.
The trainer keeps one `HostOffload` for all its waves: period i's buffer
is allocated on first use and grown only when a wave needs more bytes
than it holds, and every wave copies into a view of it (a pinned
allocation costs milliseconds a GB).  Waves run one after another and
every copy runs on the one copy stream, so the views never overlap in
time; the pinned bytes (`pinned_bytes`) are bounded by the largest wave's
k period inputs.  A failed pinned allocation or copy raises: no path
keeps the residual on the device instead.  On the CPU (tests,
``device="cpu"``) the same bookkeeping copies into plain CPU tensors,
without streams.

Under pipeline parallelism a stage holds the offloaded inputs of every
microbatch of a round between its forward and its backward: the executor
sets ``slot`` to the microbatch before each of them, and a period's
buffer is keyed by (slot, period) (by the period alone in slot 0, the
only one outside a pipeline), so the microbatches' inputs never share
one.

``d2h_bytes`` and ``h2d_bytes`` count every copy where it is issued (the
bytes ledger's measured offload traffic, `obs/ledger.py`); `busy_ms` is
the copy stream's busy time over the last dispatch, from CUDA events.
`PeakMeter` reads the peak device memory of one dispatch (the reference's
``device_memory_stats``) and keeps the high-water mark over all of them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


class PeakMeter:
    """Peak device memory per dispatch, on CUDA (None on the CPU, which
    has no allocator statistics; the reference's ``device_memory_stats()``
    returns {} there).  `start` resets the allocator's peak for a region
    and `read` returns the peak since; the allocator's peak before each
    reset is folded into `high_water`, the peak over every region, which
    is what a reader of ``torch.cuda.max_memory_allocated`` over the whole
    run would otherwise have seen."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._high = 0

    def start(self) -> None:
        if self.cuda:
            self._high = max(self._high,
                             torch.cuda.max_memory_allocated(self.device))
            torch.cuda.reset_peak_memory_stats(self.device)

    def read(self) -> Optional[int]:
        if not self.cuda:
            return None
        peak = torch.cuda.max_memory_allocated(self.device)
        self._high = max(self._high, peak)
        return peak

    def high_water(self) -> Optional[int]:
        if not self.cuda:
            return None
        return max(self._high, torch.cuda.max_memory_allocated(self.device))


class HostOffload:
    """Host buffers and copies for the offloaded periods of every wave
    (see the module docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        # keyed by `_key`
        self._host: Dict[tuple, torch.Tensor] = {}     # uint8 buffers
        self._layout: Dict[tuple, tuple] = {}          # (shape, dtype)
        self._ready: Dict[tuple, Tuple[torch.Tensor, object]] = {}
        self._saving: Dict[tuple, object] = {}         # d2h end events
        self._spans: List[tuple] = []        # (start, end) CUDA events
        self.d2h_bytes = 0
        self.h2d_bytes = 0
        self.slot = 0       # the pipelined microbatch the periods belong to

    def _key(self, i: int):
        return (self.slot, i) if self.slot else i

    def begin(self) -> None:
        """A new forward: nothing of the last dispatch is pending (a copy
        never released or loaded is waited for, then dropped)."""
        for done in [*self._saving.values(),
                     *(done for _, done in self._ready.values())]:
            if done is not None:
                torch.cuda.current_stream(self.device).wait_event(done)
        self._saving.clear()
        self._ready.clear()
        self._spans.clear()

    @property
    def pinned_bytes(self) -> int:
        """Bytes of host memory the buffers hold (pinned on CUDA)."""
        return sum(buf.numel() for buf in self._host.values())

    def host_view(self, i: int) -> torch.Tensor:
        """Period i's input as the last forward saved it."""
        key = self._key(i)
        buf, shape, dtype = self._host[key], *self._layout[key]
        return buf[:torch.Size(shape).numel() * dtype.itemsize] \
            .view(dtype).view(shape)

    def _buffer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        key = self._key(i)
        buf = self._host.get(key)
        if buf is None or buf.numel() < x.nbytes:
            buf = torch.empty(x.nbytes, dtype=torch.uint8,
                              pin_memory=self.cuda)
            if self.cuda and not buf.is_pinned():
                raise RuntimeError(f"could not pin {buf.nbytes} bytes of "
                                   f"host memory for an offloaded period")
            self._host[key] = buf
        self._layout[key] = (x.shape, x.dtype)
        return self.host_view(i)

    def _copy(self, dst: torch.Tensor, src: torch.Tensor):
        """``dst.copy_(src)`` on the copy stream, after the work queued on
        the compute stream so far; -> the copy's end event."""
        self.copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
        self._spans.append((start, end))
        return end

    def save(self, i: int, x: torch.Tensor) -> None:
        """Forward: start copying period i's input to its host buffer."""
        host = self._buffer(i, x)
        if self.cuda:
            self._saving[self._key(i)] = self._copy(host, x)
        else:
            host.copy_(x)
        self.d2h_bytes += x.nbytes

    def release(self, i: int) -> None:
        """Forward, after period i's kernels are queued: the compute stream
        waits for period i's copy, so its input may be freed."""
        done = self._saving.pop(self._key(i), None)
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)

    def prefetch(self, i: int) -> None:
        """Backward: start bringing period i's input back (once)."""
        key = self._key(i)
        if key in self._ready:
            return
        host = self.host_view(i)
        if self.cuda:
            # allocated on the compute stream, which waits on the copy's
            # event before it reads the tensor (or drops it, `begin`)
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            self._ready[key] = (dev, self._copy(dev, host))
        else:
            self._ready[key] = (host.clone(), None)
        self.h2d_bytes += host.nbytes

    def load(self, i: int) -> torch.Tensor:
        """Backward: period i's input on the device, ready for the compute
        stream."""
        self.prefetch(i)
        x, done = self._ready.pop(self._key(i))
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        return x

    def busy_ms(self) -> Optional[float]:
        """The copy stream's busy time over the copies since `begin` (waits
        for them); None on the CPU."""
        if not self.cuda:
            return None
        torch.cuda.synchronize(self.device)
        return float(sum(a.elapsed_time(b) for a, b in self._spans))
