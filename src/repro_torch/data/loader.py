"""Single-controller data pipeline (ByteScale §7 "Remote Dataloader").

The Ray single-controller design maps to:
  * ``SyntheticDataset``      — the HDFS/server role: deterministic token
    provider + per-step global-batch length metadata (no raw-data reads are
    needed to *plan*, exactly the paper's metadata-first design).
  * ``GlobalScheduler``       — the controller: sees every step's length
    metadata ahead of time, runs Alg. 1/Alg. 2 and emits (wave plan,
    loading plan).
  * ``WaveMaterializer``      — the client role: turns a wave's per-rank
    piece lists into flat device buffers (tokens/labels/seg/pos), with a
    background prefetch thread so building wave w+1 overlaps executing w.

Buffers are *global* flat arrays [hdp · capacity · c_mult]; rank r's slice
is [r·C : (r+1)·C].  Labels are next-token within the original sequence
(available across piece boundaries since the provider is random-access).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hdp import StepPlan, Wave
from repro_torch.core.planner import PlanSpec
from repro_torch.data.distribution import DISTRIBUTIONS, LengthDistribution


class SyntheticDataset:
    """Deterministic random-access corpus with a skewed length mix."""

    def __init__(self, dist: str | LengthDistribution, vocab_size: int,
                 tokens_per_step: int, context: int, seed: int = 0):
        self.dist = DISTRIBUTIONS[dist] if isinstance(dist, str) else dist
        self.vocab = vocab_size
        self.tokens_per_step = tokens_per_step
        self.context = context
        self.seed = seed

    def step_lengths(self, step: int) -> List[int]:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        return self.dist.sample_tokens(rng, self.tokens_per_step,
                                       self.context)

    def tokens(self, step: int, seq_id: int, start: int, end: int) -> np.ndarray:
        """Deterministic pseudo-tokens — reproducible across restarts and
        re-shardings (a hash over (step, seq_id, index), not storage).
        ``step`` is mixed into the hash so step t+1 carries fresh content
        for a recycled ``seq_id`` (it used to be ignored, replaying the
        same tokens every step)."""
        idx = np.arange(start, end, dtype=np.uint64)
        h = (idx + np.uint64(seq_id) * np.uint64(1_000_000_007)
             + np.uint64(step) * np.uint64(97_370_169_095_641)
             + np.uint64(self.seed) * np.uint64(11_400_714_819_323_198_485))
        h = (h * np.uint64(2_654_435_761)) ^ (h >> np.uint64(13))
        return (h % np.uint64(self.vocab)).astype(np.int32)


@dataclass
class LoadedWave:
    batch: Dict[str, np.ndarray]
    composition: tuple
    c_mult: int
    offload_ratio: float
    cost_max: float


class GlobalScheduler:
    """The single controller: metadata in, (plan, buffers) out — a thin
    facade over `repro_torch.sched.service.SchedulerService`, which owns the
    lookahead window, the composition-template registry, the async planner
    thread and the live straggler weights.  All plan construction goes
    through `repro_torch.core.planner.plan_window`."""

    def __init__(self, dataset: SyntheticDataset, cfg: ModelConfig, *,
                 capacity: int, hdp: int, mode: str = "dp",
                 strategy: str = "balance", use_offload: bool = True,
                 num_stages: int = 1,
                 rank_speed: Optional[np.ndarray] = None,
                 lookahead: int = 1, sched_async: bool = False,
                 plan_ahead: int = 2):
        from repro_torch.sched.service import SchedulerService
        self.ds = dataset
        self.cfg = cfg
        spec = PlanSpec.for_config(
            cfg, capacity=capacity, hdp=hdp, strategy=strategy, mode=mode,
            use_offload=use_offload, num_stages=num_stages)
        self.service = SchedulerService(dataset, spec, lookahead=lookahead,
                                        async_plan=sched_async,
                                        plan_ahead=plan_ahead)
        if rank_speed is not None:
            self.service.update_rank_speed(rank_speed)

    # the spec lives in the service (the trainer re-aligns use_offload
    # through this property — see Trainer._align_offload)
    @property
    def spec(self) -> PlanSpec:
        return self.service.spec

    @spec.setter
    def spec(self, value: PlanSpec):
        self.service.spec = value

    @property
    def rank_speed(self) -> Optional[np.ndarray]:
        return self.service.rank_speed

    @property
    def capacity(self) -> int:
        return self.spec.capacity

    @property
    def hdp(self) -> int:
        return self.spec.hdp

    @property
    def strategy(self) -> str:
        return self.spec.strategy

    def plan_step(self, step: int) -> StepPlan:
        return self.service.plan_step(step)

    def get_step(self, step: int):
        """(plan, pre-materialized waves or None) — see SchedulerService."""
        return self.service.get_step(step)

    def update_rank_speed(self, speed: np.ndarray):
        """Straggler mitigation: the trainer feeds back *measured* per-rank
        speeds (sched/calibrate.py); windows planned from now on give slow
        ranks proportionally less work."""
        self.service.update_rank_speed(speed)

    def update_coeffs(self, coeffs):
        """Swap refitted Eq. 3 cost coefficients into future windows."""
        self.service.update_coeffs(coeffs)

    def stop(self):
        self.service.stop()


class WaveMaterializer:
    def __init__(self, dataset: SyntheticDataset, cfg: ModelConfig,
                 capacity: int, prefetch: int = 2):
        self.ds = dataset
        self.cfg = cfg
        self.capacity = capacity
        self.prefetch = prefetch

    def materialize(self, step: int, wave: Wave) -> LoadedWave:
        c = self.capacity * wave.c_mult
        hdp = len(wave.slots)
        t = hdp * c
        tokens = np.zeros(t, np.int32)
        labels = np.zeros(t, np.int32)
        seg = np.zeros(t, np.int32)
        pos = np.zeros(t, np.int32)
        for r, slot in enumerate(wave.slots):
            cursor = r * c
            for p in slot:
                n = p.length
                tokens[cursor:cursor + n] = self.ds.tokens(
                    step, p.seq_id, p.start, p.end)
                labels[cursor:cursor + n] = self.ds.tokens(
                    step, p.seq_id, p.start + 1, p.end + 1)
                seg[cursor:cursor + n] = p.seq_id + 1
                pos[cursor:cursor + n] = np.arange(p.start, p.end)
                cursor += n
        batch = {"tokens": tokens, "labels": labels, "seg": seg, "pos": pos}
        if self.cfg.pos_embed == "mrope":
            batch["pos"] = np.stack([pos] * 3, axis=-1)
        return LoadedWave(batch=batch, composition=wave.composition,
                          c_mult=wave.c_mult,
                          offload_ratio=wave.offload_ratio,
                          cost_max=max(wave.costs))

    def iter_step(self, step: int, plan: StepPlan) -> Iterator[LoadedWave]:
        """Prefetching iterator: wave w+1 builds while w executes."""
        yield from self._prefetched(
            lambda: (self.materialize(step, w) for w in plan.waves))

    def materialize_round(self, step: int, plan: StepPlan,
                          rd) -> Dict[str, np.ndarray]:
        """One pipelined round's microbatches stacked to [M, ...] — the
        round-level analogue of `materialize` (shared by `iter_rounds`'
        prefetch and the scheduler service's materialize-ahead)."""
        loaded = [self.materialize(step, plan.waves[i])
                  for i in rd.wave_ids]
        return {k: np.stack([lw.batch[k] for lw in loaded])
                for k in loaded[0].batch}

    def iter_rounds(self, step: int, plan: StepPlan,
                    rounds) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator over pipelined rounds: yields each round's
        microbatches stacked to [M, ...] (round r+1 materializes in the
        background while round r executes — the pipelined analogue of
        `iter_step`)."""
        def produce():
            for rd in rounds:
                yield self.materialize_round(step, plan, rd)
        yield from self._prefetched(produce)

    def _prefetched(self, produce) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        err: List[BaseException] = []
        cancel = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer walked away —
            # a plain q.put() would block forever once the generator is
            # closed mid-step (error in the trainer, elastic reconfig)
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in produce():
                    if not _put(item):
                        return
            except BaseException as e:
                # a bad plan must fail the *step*, not vanish with the
                # thread: capture and re-raise on the consumer side (the
                # bare `finally: q.put(stop)` used to swallow it)
                err.append(e)
            finally:
                _put(stop)

        th = threading.Thread(target=producer, daemon=True,
                              name="wave-materializer-prefetch")
        th.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            # reached on normal exhaustion AND on GeneratorExit/throw();
            # release the producer if it is parked on a full queue
            cancel.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            th.join()
        if err:
            raise err[0]
