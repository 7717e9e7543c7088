"""The training loop: HDP waves + gradient accumulation, one process per
HDP rank.

Port of `repro/train/trainer.py`.  Per step
(paper Fig. 7): the GlobalScheduler plans the global batch (sync, or from
the scheduler service's planner thread with pre-materialized waves); each
wave runs through a per-(composition, c_mult, offload) callable — the
cache that stands for the reference's jit executable cache, with its
``trainer.compile_hit``/``compile_miss`` counters; gradients accumulate in
fp32 with token-level loss scaling and one guarded AdamW apply follows,
its sentinel summary fetched from the device once.  Measured wave times
feed the online calibrator (per-rank speeds, refitted cost coefficients)
and compiled keys warm the scheduler's composition templates.

Over several HDP ranks (``rt.comm``, one process each) every rank plans
the same step, where the reference's single controller plans for the
mesh: the ranks check their plan fingerprints against each other before
the first wave, each runs its own rows of every wave through the ring,
and the apply is the ZeRO-1 update (`train/train_step.py`).  One
all-gather a step carries every rank's per-wave loss shares and seconds,
so the step's losses and the calibrator's per-rank times are the same on
every rank.

With ``use_offload`` the planner sizes groups with Eq. 3's offload term
and each wave with an offload ratio r > 0 runs under ``remat="offload"``:
its first `core.offload.offload_periods` layer periods keep their input
residual in pinned host memory between the forward and the backward's
recompute (`parallel/host_offload.py`: one set of host buffers for all
the waves, grown to the largest and reused); over several ranks each rank
offloads its own rows.

The bytes ledger (`obs/ledger.py`, on with tracing or ``REPRO_LEDGER``)
gets one record per wave: the predicted ring, offload and ZeRO-1 bytes
beside the measured ones (this rank's forward sends and offload copies,
summed over the ranks in the step's all-gather) and the wave's peak
device memory (the largest over the ranks).  ``peak.high_water()`` is the
peak over the whole run, which the per-dispatch resets hide from
``torch.cuda.max_memory_allocated``.

Checkpoints (``ckpt_dir``; `ckpt/checkpoint.py`, the reference's format)
are written every ``ckpt_every`` steps and at the end of ``run``, and
``resume_if_possible`` restores the newest one that passes integrity.
Over several ranks every rank gathers its ZeRO-1 shards of master, m and
v to rank 0, which alone writes; on restore every rank reads the file,
takes its own shards and checks that the others chose the same step.  So
a run changes its HDP size by a relaunch at hdp' that restores the
checkpoint.

Under pipeline parallelism (``rt.stage_comm``, ``rt.num_stages > 1``;
PP-Balance plans with ``mode="pp"``) the world is stages × HDP ranks and
each rank holds its stage's window of the stacked blocks: the wave queue
runs as rounds of like (composition, c_mult, offload) waves
(`parallel/pipeline.py::pipeline_rounds`, at most ``max_round_waves``
each), every round the wavefront of `pipeline_grad_step`, one pipeline
microbatch a wave.  A round's loss is the sum of its waves' losses,
computed on the last stage and shared over the stage group; an offloading
round offloads the stage-local count `offload_periods(cfg, r, S)`;
``nan_fault["wave"]`` counts rounds, as the reference's does.  The
per-round seconds, bytes and losses are shared over the stage group and
then over the HDP ranks in one all-gather each a step, so every rank of
the world sees the same step.  The plan check, the checkpoint checks and
the save cover every rank of the world: a save gathers ZeRO-1 within
each HDP group, then each stage's window over the stage group, to world
rank 0, which writes the reference's global layout.

Under tensor parallelism (``rt.tp_comm``, ``rt.tp > 1``; the attention
decoders and RWKV-6) the world is a stages × hdp × tp grid, world rank
s·(hdp·tp) + h·tp + m (`parallel/comm.py::grid`, the reference's
``("stage", "data", "model")`` mesh): each rank holds its model rank's
slices of the split leaves (`init_params(..., model=(m, tp))`) of its
stage's window, the model ranks of one HDP position take the same rows
of every wave, rank 0's initial weights are broadcast within each model
rank's HDP group (never across model ranks), and ZeRO-1 shards over the
HDP group of each model rank, skipping both the stage's and the model's
dimension.  Under PP the residual a stage sends goes to the rank of the
next stage at the same HDP position and model rank, the last stage runs
the vocab-parallel CE over its model group, and the tied embedding sums
its gradient over the stage group on each model rank's vocabulary rows.
With ``use_offload`` each model rank offloads its own copy of the
replicated residual through its own `HostOffload`, as every device of
the reference's mesh does; the plan is the reference's (the planner has
no tp term).  The plan check, the step's numbers and the checkpoint
checks span the whole grid; a save gathers ZeRO-1 within each HDP group,
then the model slices over the model group, then the stage windows over
the stage group, to world rank 0, which writes the global layout, and a
restore takes this rank's stage window, its model slice, then its ZeRO-1
shard, so a file moves between grids where the layouts' ``h_pad``
agree.

What the port does not run yet raises `NotImplementedError` naming the
ROADMAP queue item that brings it: the in-place ``resize`` to another
HDP size and the planner thread with calibration over several ranks
(queue 1 item 9).  The numerics monitor and step provenance come with
queue 1 item 9.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.offload import offload_periods
from repro_torch.data.loader import GlobalScheduler, WaveMaterializer
from repro_torch.models.transformer import check_supported, init_params
from repro_torch.obs import get_metrics, get_recorder, get_tracer
from repro_torch.obs import ledger as ledger_mod
from repro_torch.obs.numerics import fingerprints_by_rank
from repro_torch.optim import adamw
from repro_torch.parallel.host_offload import HostOffload, PeakMeter
from repro_torch.parallel.pipeline import (assert_pipeline_ready,
                                           busy_seconds,
                                           pipeline_grad_step,
                                           pipeline_rounds,
                                           pipeline_schedule_stats,
                                           rounds_splitter,
                                           stage_gather_to_host)
from repro_torch.parallel.sharding import Runtime, tp_splits
from repro_torch.parallel.zero1 import (gather_dim_to_host, gather_to_host,
                                        stage_owned, stage_taken,
                                        with_splits, zero1_bytes, zero1_dim)
from repro_torch.sched.calibrate import OnlineCalibrator, fit_length_of
from repro_torch.train.train_step import make_accum_steps, zeros_accum
from repro_torch.tree import leaves, tree_map


@dataclass
class TrainerConfig:
    capacity: int = 512
    steps: int = 10
    ckpt_every: int = 5
    ckpt_dir: Optional[str] = None
    mode: str = "dp"                 # balance mode (PP-Balance: "pp")
    use_offload: bool = False        # offload remat (Eq. 3 plans, the
                                     # leading periods' inputs in pinned
                                     # host memory)
    straggler_ema: float = 0.5
    attn_impl: Optional[str] = None  # override Runtime.attn_impl per run:
                                     # "ref" (plain oracle) | "flash" (the
                                     # kernels); None keeps the Runtime's
    sched_async: bool = False        # consume pre-materialized waves from
                                     # the scheduler service's planner
                                     # thread
    calibrate: bool = True           # feed measured wave times back into
                                     # the scheduler
    recalibrate_every: int = 8       # refit Eq. 3 CostCoeffs every N steps
                                     # (0 = never)
    ckpt_save: bool = True           # False: restore only (the same on
                                     # every rank; over several ranks
                                     # rank 0 alone writes)
    numerics_guard: bool = True      # skip the optimizer apply when any
                                     # grad element is non-finite
    nan_fault: Optional[Dict] = None  # fault injection: {"step": k,
                                      # "wave": i} poisons that wave's
                                      # (under PP: round's) loss
                                      # denominator with NaN
    max_round_waves: int = 0         # pipelined executor: split rounds
                                     # longer than this many waves (0 = no
                                     # cap) to bound in-flight activations


class Trainer:
    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime],
                 opt_cfg: adamw.AdamWConfig, scheduler: GlobalScheduler,
                 tcfg: TrainerConfig, seed: int = 0, params=None):
        """``rt=None`` means ``Runtime()`` on the default device (``cuda``;
        it raises without one).  ``params`` (a tree on the runtime's
        device, e.g. bridged from the reference; under PP this stage's
        window) replaces the seeded init; over several ranks each HDP
        group's rank 0's are broadcast to the group either way, and the
        optimiser state (this rank's ZeRO-1 shards) is built from them."""
        self.cfg = cfg
        self.rt = rt if rt is not None else Runtime()
        if tcfg.sched_async and tcfg.calibrate \
                and (self.rt.hdp_size > 1 or self.rt.num_stages > 1):
            raise NotImplementedError(
                "the planner thread applies speed updates from a window "
                "that depends on its timing in each process, so calibrated "
                "ranks could plan apart: sched_async with calibrate over "
                "several ranks waits for the single controller, ROADMAP "
                "queue 1 item 9")
        self.pipelined = self.rt.num_stages > 1
        if self.pipelined:
            assert_pipeline_ready(cfg, self.rt)
        tp = self.rt.tp
        check_supported(cfg, tp)
        self.opt_cfg = opt_cfg
        self.sched = scheduler
        self.tcfg = tcfg
        self.seed = seed
        if scheduler.hdp != self.rt.hdp_size:
            raise ValueError(f"plan world {scheduler.hdp} must match the "
                             f"runtime's {self.rt.hdp_size} rank(s)")
        self.offload_ok = tcfg.use_offload
        # one set of host buffers for every wave (grown to the largest)
        self.offload_store = HostOffload(self.rt.device) \
            if self.offload_ok else None
        self.peak = PeakMeter(self.rt.device)   # per-dispatch peaks
        self._align_offload(scheduler)
        self.loader = WaveMaterializer(scheduler.ds, cfg, tcfg.capacity)
        self.params = params if params is not None else init_params(
            cfg, seed=seed, device=self.rt.device,
            stage=(self.rt.stage_rank, self.rt.num_stages),
            model=(self.rt.model_rank, tp))
        if self.rt.comm is not None:
            for p in leaves(self.params):
                self.rt.comm.broadcast(p)
        # per leaf: its model split dimension (None: replicated), and the
        # dimensions ZeRO-1 must skip (the stage's and the model's)
        self._splits = tp_splits(self.params,
                                 self.rt.layout(cfg).kv_sharded, tp)
        self._taken = with_splits(stage_taken(self.params,
                                              self.rt.num_stages),
                                  self._splits)
        self.opt_state = adamw.init_state(self.params, self.rt.comm,
                                          self._taken)
        self.step = 0
        self.grad_step, self.apply_step = make_accum_steps(
            cfg, self.rt, opt_cfg, guard=tcfg.numerics_guard)
        self._exec_cache: Dict[tuple, Runtime] = {}
        self.ckpt = CheckpointManager(tcfg.ckpt_dir) \
            if tcfg.ckpt_dir else None
        self._check_ckpt_config()
        self.last_ckpt_step: Optional[int] = None
        self.ckpt_stats: Dict[str, float] = {}   # the last save's and
        # restore's seconds and bytes (`_save`, `resume_if_possible`)
        self.history: list = []
        self.calib = OnlineCalibrator(
            scheduler.spec.coeffs, self.rt.hdp_size, cfg.num_layers,
            quadratic=scheduler.spec.quadratic, ema=tcfg.straggler_ema)
        self.wave_time_fn = None     # fake-clock hook: replaces the
                                     # measured dispatch time (scalar wall
                                     # or per-rank vector)
        self.telemetry_fn = None     # called with (waves, measured, fresh,
                                     # wall_s=host wall) for every dispatch
                                     # (this rank's time)
        self._clock = time.perf_counter
        self.ledger: Optional[ledger_mod.Ledger] = None   # built on the
        # first dispatch with tracing or REPRO_LEDGER on
        self.last_ledger_record: Optional[Dict] = None
        self.last_numerics: Optional[Dict] = None   # the last step's
        # loss, per-wave losses and seconds, sentinels and applied flag
        self._attach_materializer(scheduler)

    def _attach_materializer(self, scheduler) -> None:
        """Materialize-ahead from the planner thread: per-wave buffers, or
        under PP stacked [M, ...] round buffers (`rounds_splitter` is the
        one round-split contract shared with the executor)."""
        if self.tcfg.sched_async:
            scheduler.service.attach_materializer(
                self.loader,
                rounds_fn=rounds_splitter(self.tcfg.max_round_waves)
                if self.pipelined else None)

    def _align_offload(self, scheduler: GlobalScheduler):
        """Keep plan and execution consistent: when waves do not offload
        (off in the TrainerConfig), the scheduler must not size groups
        with Eq. 3's offload term either."""
        if scheduler.spec.use_offload and not self.offload_ok:
            scheduler.spec = scheduler.spec.replace(use_offload=False)

    def _wave_rt(self, composition, offload_ratio) -> Runtime:
        rt_wave = self.rt.with_composition(composition)
        if self.tcfg.attn_impl is not None:
            rt_wave = dataclasses.replace(rt_wave,
                                          attn_impl=self.tcfg.attn_impl)
        if self.offload_ok and offload_ratio > 0:
            # under PP the count is the stage-local one: each stage
            # offloads its own window's leading periods (core/offload.py)
            k = offload_periods(self.cfg, offload_ratio, self.rt.num_stages)
            rt_wave = dataclasses.replace(
                rt_wave, remat="offload", offload_periods=k,
                offload_store=self.offload_store)
        return rt_wave

    def _wave_fn(self, composition, c_mult, offload_ratio):
        """-> (the wave's or round's runtime, fresh): ``fresh`` marks a
        cache miss (on the card the first dispatch also builds the
        kernels; the calibrator skips it)."""
        key = (tuple(composition), c_mult, round(offload_ratio, 2))
        fresh = key not in self._exec_cache
        get_metrics().counter("trainer.compile_miss" if fresh
                              else "trainer.compile_hit").inc()
        if fresh:
            self._exec_cache[key] = self._wave_rt(composition, offload_ratio)
        return self._exec_cache[key], fresh

    def resize(self, new_hdp_scheduler: GlobalScheduler):
        """Elastic rescale at the same HDP size: the new scheduler and a
        fresh calibrator take over, params and optimiser state carry on
        (the reference's `resize`).  Another size raises: it needs a new
        process group, so it is a relaunch at that size that restores the
        checkpoint (`resume_if_possible` re-shards ZeRO-1)."""
        if new_hdp_scheduler.hdp != self.rt.hdp_size:
            raise NotImplementedError(
                f"resize from {self.rt.hdp_size} to {new_hdp_scheduler.hdp} "
                f"HDP ranks needs a new process group: relaunch at "
                f"{new_hdp_scheduler.hdp} ranks and restore the checkpoint "
                f"(resume_if_possible re-shards ZeRO-1); the in-place "
                f"resize comes with ROADMAP queue 1 item 9 (ctrl/elastic.py)")
        if new_hdp_scheduler is not self.sched:
            self.sched.stop()   # old planner thread + pre-built buffers
        self.sched = new_hdp_scheduler
        self._align_offload(new_hdp_scheduler)
        self.calib = OnlineCalibrator(
            new_hdp_scheduler.spec.coeffs, new_hdp_scheduler.hdp,
            self.cfg.num_layers, quadratic=new_hdp_scheduler.spec.quadratic,
            ema=self.tcfg.straggler_ema)
        self._attach_materializer(new_hdp_scheduler)

    # ------------------------------------------------------------------
    @property
    def _multi(self) -> bool:
        """More than one rank in the world (HDP ranks, stages or model
        ranks)."""
        return self.rt.hdp_size > 1 or self.pipelined or self.rt.tp > 1

    def _lead(self) -> bool:
        """World rank 0 (or the only rank): the one that writes
        checkpoints."""
        return (self.rt.comm is None or self.rt.comm.rank == 0) \
            and self.rt.stage_rank == 0 and self.rt.model_rank == 0

    def _gather_world(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` -> [world, ...], world rank s·(hdp·tp) + h·tp
        + m's at that row (an all-gather over the model group, then one
        over the HDP group, then one over the stage group)."""
        shape = x.shape
        for comm in (self.rt.tp_comm, self.rt.comm, self.rt.stage_comm):
            x = x[None] if comm is None else comm.all_gather(x)
        return x.reshape(-1, *shape)

    def _all_gather_ints(self, values) -> list:
        """Every rank's ``values`` (a list of ints) -> one row a rank of
        the world."""
        return self._gather_world(torch.tensor(
            values, dtype=torch.int64, device=self.rt.device)).tolist()

    def _check_ckpt_config(self) -> None:
        """Over several ranks every rank must take part in every save's
        gathers: a rank without ``ckpt_dir``, or with another
        ``ckpt_save``, would leave the others waiting in them."""
        if not self._multi:
            return
        got = self._all_gather_ints([self.ckpt is not None,
                                     self.tcfg.ckpt_save])
        if any(row != got[0] for row in got):
            raise ValueError(f"ckpt_dir set and ckpt_save must agree on "
                             f"every rank (by rank {got})")

    def data_state(self) -> Dict:
        """Checkpoint data_state: the step cursor plus the calibrator's and
        the scheduler service's warm state."""
        return {"step": self.step, "calib": self.calib.state_dict(),
                "sched": self.sched.service.state_dict()}

    def load_ctrl_state(self, data_state: Dict) -> None:
        """Warm-start the calibrator and scheduler service from a
        checkpoint's data_state (no-ops on geometry mismatch)."""
        calib_state = data_state.get("calib")
        if calib_state:
            self.calib.load_state(calib_state)
        sched_state = data_state.get("sched")
        if sched_state:
            self.sched.service.load_state(sched_state)
            if self.tcfg.calibrate and self.calib.n_observed > 0:
                self.sched.update_rank_speed(self.calib.rank_speed())

    def resume_if_possible(self) -> bool:
        """Restore the newest checkpoint that passes integrity (a damaged
        newest one falls back to the last good one) into the params and
        optimiser state, each rank its stage window and its ZeRO-1 shards
        of the file's global leaves, so the checkpoint may come from any
        HDP size and stage count.  Over several ranks every rank
        all-gathers the step it restored, and a disagreement raises on
        every rank.  Calibrator and scheduler state restore warm when the
        HDP size still matches."""
        if self.ckpt is None:
            return False
        t0 = self._clock()
        res = self.ckpt.restore_latest(
            self.params, self.opt_state, comm=self.rt.comm,
            stage=(self.rt.stage_rank, self.rt.num_stages),
            model=(self.rt.model_rank, self.rt.tp, self._splits))
        if self._multi:
            got = [row[0] for row in self._all_gather_ints(
                [-1 if res is None else res[0]])]
            if len(set(got)) > 1:
                raise RuntimeError(f"the ranks restored different "
                                   f"checkpoints (steps by rank {got})")
        if res is None:
            return False
        _, self.params, self.opt_state, data_state = res
        self.step = int(data_state["step"])
        self.last_ckpt_step = self.step
        self.load_ctrl_state(data_state)
        self.ckpt_stats.update(resumed_at=self.step,
                               restore_s=self._clock() - t0)
        return True

    def _gathered_trees(self):
        """(params, optimiser state) with the global leaves, on world rank
        0: at one rank its own trees; over several, every HDP group's
        ZeRO-1 shards gathered to its rank 0, then under TP every model
        rank's slices gathered to model rank 0, then under PP every
        stage's window of the stacked leaves gathered to stage 0 (host
        arrays there).  None leaves elsewhere.  Every rank must call
        it."""
        if not self._multi:
            return self.params, self.opt_state
        comm, stages, model = self.rt.comm, self.rt.stage_comm, \
            self.rt.tp_comm

        def global_leaf(x, p, taken, owned, split, sharded):
            """This rank's part of a leaf (its ZeRO-1 shard if ``sharded``,
            else the whole leaf) -> the global leaf at world rank 0.  A
            model group's ranks share their HDP position, and a stage
            group's their HDP position and model rank, so all of a
            group's ranks or none reach its gather."""
            if sharded and comm is not None:
                x = gather_to_host(x, p.shape, comm, taken)
            elif comm is not None and comm.rank != 0:
                x = None
            if x is not None and model is not None:
                if split is None:
                    x = x if model.rank == 0 else None
                else:
                    part = torch.as_tensor(x)
                    if part.dtype == torch.bfloat16:     # npz has no bf16
                        part = part.float()
                    part = part.contiguous()
                    full = list(p.shape)
                    full[split] *= model.size
                    x = gather_dim_to_host(part, full, split, model,
                                           self.rt.device)
            if x is None or stages is None:
                return x
            if not owned:
                return x if stages.rank == 0 else None
            if isinstance(x, torch.Tensor):
                x = x.detach().to("cpu", torch.float32, copy=True).numpy()
            return stage_gather_to_host(x, stages)

        def tree(src, sharded):
            got = iter([global_leaf(x, p, t, o, sp, sharded)
                        for x, p, t, o, sp in
                        zip(leaves(src), leaves(self.params), self._taken,
                            stage_owned(self.params), self._splits)])
            return tree_map(lambda _: next(got), src)

        opt = {"step": self.opt_state["step"],
               **{k: tree(self.opt_state[k], True)
                  for k in ("master", "m", "v")}}
        return tree(self.params, False), opt

    def _save(self, block: bool = False) -> None:
        """Checkpoint the current step.  Over several ranks every rank
        must call it: the ZeRO-1 shards and the stage windows are
        gathered to world rank 0, which alone writes (after its previous
        write has finished, so its host holds one snapshot at a time)."""
        t0 = self._clock()
        if self._lead():
            self.ckpt.wait()
        stats = {}
        t1 = self._clock()
        params, opt = self._gathered_trees()
        if self._multi:
            stats["gather_s"] = self._clock() - t1
            stats["gathered_bytes"] = 3.0 * sum(
                p.numel() * 4 for p, t in zip(leaves(self.params),
                                              self._taken)
                if zero1_dim(p.shape, self.rt.hdp_size, t) is not None)
        if self._lead():
            self.ckpt.save(self.step, params, opt, self.data_state(),
                           block=block)
            stats.update(self.ckpt.last_save)
        del params, opt
        self.last_ckpt_step = self.step
        stats["save_s"] = self._clock() - t0
        self.ckpt_stats.update(stats)

    # ------------------------------------------------------------------
    def _observe(self, waves, measured, fresh_compile: bool,
                 modeled: bool = False):
        """Feed one dispatch's time to the local calibrator (the
        reference's `_observe`; the loop calls the telemetry hook itself,
        per dispatch): fresh dispatches are skipped unless the time is
        modeled."""
        if (fresh_compile and not modeled) or not self.tcfg.calibrate:
            return
        costs = np.zeros(self.sched.hdp)
        for w in waves:
            costs += np.asarray(w.costs)
        kw = dict(fit_length=fit_length_of(waves))
        if np.ndim(measured) > 0:
            self.calib.observe(costs, rank_seconds=measured, **kw)
        else:
            self.calib.observe(costs, seconds=float(measured), **kw)

    def _check_plan(self, plan) -> None:
        """Every rank of the world must run the same plan.  One gather
        over the world (`_gather_world`) of a prefix of each rank's plan
        fingerprint, before the first dispatch; on a mismatch every rank raises (one rank raising while
        the others wait inside a wave's ring would hang them)."""
        if not self._multi:
            return
        got = fingerprints_by_rank(self._gather_world, plan, self.rt.device)
        if len(set(got)) > 1:
            raise RuntimeError(
                f"step {self.step}: the ranks planned different steps "
                f"(plan fingerprint prefixes by rank {got})")

    def _share(self, comm, losses, seconds, meas, per_rank: bool):
        """One all-gather over ``comm`` of this rank's per-wave loss
        shares, per-dispatch seconds and (ledger on) per-dispatch [ring,
        pp, d2h, h2d bytes, peak] -> (losses summed over the ranks;
        seconds, each dispatch's [size] vector if ``per_rank`` else the
        largest; meas with bytes summed and the largest peak), the same on
        every rank of ``comm``."""
        nl, nd = len(losses), len(seconds)
        flat = [x for m in meas for x in m] if meas is not None else []
        got = comm.all_gather(torch.tensor(
            losses + seconds + flat, dtype=torch.float64,
            device=self.rt.device)).cpu().numpy()
        if meas is not None:
            m = got[:, nl + nd:].reshape(comm.size, nd, 5)
            meas = [[*m[:, i, :4].sum(axis=0).tolist(),
                     float(m[:, i, 4].max())] for i in range(nd)]
        secs = got[:, nl:nl + nd]
        seconds = [secs[:, i] for i in range(nd)] if per_rank \
            else secs.max(axis=0).tolist()
        return [float(x) for x in got[:, :nl].sum(axis=0)], seconds, meas

    def _share_waves(self, losses, seconds, meas=None):
        """The step's numbers, the same on every rank of the world: each
        wave's loss summed over the ranks (under PP the last stage's,
        shared over the stage group), each dispatch's seconds (at one HDP
        rank this rank's; else an [hdp] vector, under PP each HDP
        position's slowest stage) and, with the ledger on, each dispatch's
        fleet bytes and largest peak (`_share`).  At one rank the inputs
        themselves."""
        if self.rt.tp_comm is not None:
            # the model ranks of an HDP position computed the same loss
            # and sent their own heads' ring bytes: model rank 0's losses
            # and bytes, every rank's slowest seconds and largest peak,
            # so every calibrator sees the same times
            lead = self.rt.model_rank == 0
            losses, seconds, meas = self._share(
                self.rt.tp_comm, losses if lead else [0.0] * len(losses),
                seconds, meas if meas is None or lead
                else [[0.0] * 4 + m[4:] for m in meas], per_rank=False)
        if self.rt.stage_comm is not None:
            losses, seconds, meas = self._share(
                self.rt.stage_comm, losses, seconds, meas, per_rank=False)
        if self.rt.hdp_size > 1:
            losses, seconds, meas = self._share(
                self.rt.comm, losses, seconds, meas, per_rank=True)
        return losses, seconds, meas

    def _global_meta(self):
        """The global parameter tree's shapes and dtypes as meta tensors
        (a stage's stacked windows scaled back to [n_periods, ...], a
        model slice to its whole leaf)."""
        num = self.rt.num_stages

        def meta(p, owned, split):
            shape = [p.shape[0] * num, *p.shape[1:]] if owned \
                else list(p.shape)
            if split is not None:
                shape[split] *= self.rt.tp
            return torch.empty(shape, dtype=p.dtype, device="meta")
        got = iter([meta(p, o, sp) for p, o, sp in zip(
            leaves(self.params), stage_owned(self.params), self._splits)])
        return tree_map(lambda _: next(got), self.params)

    def _ensure_ledger(self, tr) -> Optional[ledger_mod.Ledger]:
        """The bytes ledger (obs/ledger.py), built on the first dispatch
        with tracing or REPRO_LEDGER on (on every rank alike: its tallies
        ride the step's all-gathers), and rebuilt after a resize.  None
        when the ledger is off (zero cost on the disabled path).  Its
        ZeRO-1 bytes are the reference's, priced on the global tree."""
        if not (tr.enabled or ledger_mod.ledger_enabled()):
            return None
        if self.ledger is None or self.ledger.hdp != self.sched.hdp:
            self.ledger = ledger_mod.Ledger(
                self.cfg, capacity=self.tcfg.capacity, hdp=self.sched.hdp,
                num_stages=self.rt.num_stages, tp=self.rt.tp,
                kv_sharded=self.rt.layout(self.cfg).kv_sharded,
                coeffs=self.sched.spec.coeffs,
                offload_active=self.offload_ok)
            self.ledger.set_step_bytes(zero1_bytes(self._global_meta(),
                                                   self.rt.hdp_size))
        return self.ledger

    def _dispatch(self, tr, led, run, idx: int, composition, fresh: bool,
                  waves):
        """Run one dispatch (a wave, or under PP a round; ``run()`` ->
        (grads, loss tensor a wave)) under a span; a fresh cache entry's
        first call sits in a nested "compile" span.  The loss fetch blocks
        until the dispatch has run, so the time is its own.  -> (grads,
        this rank's loss shares, seconds, with the ledger on (``led``)
        this rank's [ring and pp bytes sent in the forward, offload d2h
        and h2d bytes, peak device memory of the dispatch (nan on the
        CPU)])."""
        extra = {}
        if tr.enabled:
            extra = {"cost_max": round(float(max(
                         np.sum([w.costs for w in waves], axis=0))), 9),
                     "cost_sum": round(float(sum(sum(w.costs)
                                                 for w in waves)), 9),
                     "tokens": int(sum(p.length for w in waves
                                       for slot in w.slots
                                       for p in slot))}
        store = self.offload_store
        moved = (store.d2h_bytes, store.h2d_bytes) if store else (0, 0)
        if led is not None:
            self.peak.start()
        with tr.span("round" if self.pipelined else "wave", step=self.step,
                     idx=idx, composition=composition, fresh=fresh,
                     **extra):
            t_w = self._clock()
            with (ledger_mod.capture() if led is not None
                  else contextlib.nullcontext({})) as tally, \
                    (tr.span("compile", step=self.step,
                             composition=composition) if fresh
                     else contextlib.nullcontext()):
                grads, loss = run()
                loss = loss.tolist()
            dt = self._clock() - t_w
        meas = None
        if led is not None:
            peak = self.peak.read()
            meas = [tally.get("ring", 0.0), tally.get("pp", 0.0),
                    float(store.d2h_bytes - moved[0]) if store else 0.0,
                    float(store.h2d_bytes - moved[1]) if store else 0.0,
                    float("nan") if peak is None else float(peak)]
        return grads, loss, dt, meas

    def _record_ledger(self, led, keys, fresh_flags, meas) -> None:
        """One ledger record per dispatch of the step, from the fleet
        tallies (the reference's per-dispatch record), and its metrics."""
        mx = get_metrics()
        for i, ((comp, c_mult, ratio, n), m) in enumerate(zip(keys, meas)):
            ring, pp, d2h, h2d, peak = m
            rec = led.record_dispatch(
                step=self.step, idx=i,
                kind="round" if self.pipelined else "wave",
                composition=comp, c_mult=c_mult, offload_ratio=ratio,
                n_waves=n, fresh=fresh_flags[i],
                measured={"ring": ring, "pp": pp, "offload_d2h": d2h,
                          "offload_h2d": h2d},
                hbm_peak=peak if np.isfinite(peak) else None)
            self.last_ledger_record = rec
            mx.counter("comm.pred_bytes").inc(sum(rec["pred"].values()))
            mx.counter("comm.meas_bytes").inc(sum(rec["meas"].values()))
            mx.gauge("mem.hbm_pred_peak").set(float(rec["hbm_pred"]))
            if "hbm_meas" in rec:
                mx.gauge("mem.hbm_meas_peak").set(rec["hbm_meas"])
            self.calib.observe_bytes(sum(rec["pred"].values()),
                                     sum(rec["meas"].values()))
            mx.gauge("comm.residual").set(led.comm_residual())

    def _nan_fault_hits(self, idx: int) -> bool:
        nf = self.tcfg.nan_fault
        return bool(nf) and self.step == int(nf.get("step", -1)) \
            and idx == int(nf.get("wave", 0))

    def _to_device(self, arrays: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a wave's global buffers, on the device: HDP
        rank r of hdp takes rows [r·C·c_mult, (r+1)·C·c_mult)."""
        dev = self.rt.device
        hdp = self.rt.hdp_size
        r = 0 if hdp == 1 else self.rt.comm.rank

        def rows(v):
            n = v.shape[0] // hdp
            return v[r * n:(r + 1) * n]
        return {k: torch.from_numpy(np.ascontiguousarray(rows(v))).to(dev)
                for k, v in arrays.items()}

    def _denom(self, denom: float, idx: int) -> torch.Tensor:
        return torch.tensor(
            float("nan") if self._nan_fault_hits(idx) else denom,
            dtype=torch.float32, device=self.rt.device)

    def _run_wave(self, grads, item, denom: float, idx: int, rt_wave):
        """A wave's dispatch body: ``item`` a `LoadedWave` -> (run, None)."""
        batch = self._to_device(item.batch)
        batch["denom"] = self._denom(denom, idx)

        def run():
            g, metrics = self.grad_step(self.params, grads, batch, rt_wave)
            return g, metrics["loss"][None]
        return run, None

    def _run_round(self, grads, item, denom: float, idx: int, rt_round):
        """A round's dispatch body: ``item`` its stacked [M, ...] buffers
        -> (run, the list its compute spans go to)."""
        n = next(iter(item.values())).shape[0]
        batches = [self._to_device({k: v[m] for k, v in item.items()})
                   for m in range(n)]
        den = self._denom(denom, idx)
        busy: list = []
        return (lambda: pipeline_grad_step(self.params, grads, self.cfg,
                                           rt_round, batches, den, busy),
                busy)

    def train_step(self) -> Dict:
        tr = get_tracer()
        mx = get_metrics()
        t0 = self._clock()
        with tr.span("plan", step=self.step):
            if self.tcfg.sched_async:
                plan, pre_waves = self.sched.get_step(self.step)
            else:
                plan, pre_waves = self.sched.plan_step(self.step), None
        self._check_plan(plan)
        denom = float(plan.denom)
        grads = zeros_accum(self.params)
        led = self._ensure_ledger(tr)
        if self.pipelined:
            # rounds of like waves, each one wavefront (parallel/pipeline);
            # pre_waves: the service's pre-built round buffers (its
            # rounds_fn is this split)
            rounds = pipeline_rounds(plan, self.tcfg.max_round_waves)
            units = [(rd.wave_ids, rd.composition, rd.c_mult,
                      rd.offload_ratio) for rd in rounds]
            items = iter(pre_waves) if pre_waves is not None \
                else self.loader.iter_rounds(self.step, plan, rounds)
            body = self._run_round
        else:
            units = [([i], tuple(w.composition), w.c_mult, w.offload_ratio)
                     for i, w in enumerate(plan.waves)]
            items = iter(pre_waves) if pre_waves is not None \
                else self.loader.iter_step(self.step, plan)
            body = self._run_wave
        losses = [0.0] * len(plan.waves)      # this rank's shares
        seconds, measured, fresh_flags, busy_s = [], [], [], []
        keys, meas = [], []
        for i, (ids, comp, c_mult, ratio) in enumerate(units):
            with tr.span("materialize", step=self.step, idx=i):
                item = next(items)
            waves = [plan.waves[j] for j in ids]
            rt_wave, fresh = self._wave_fn(comp, c_mult, ratio)
            run, busy = body(grads, item, denom, i, rt_wave)
            grads, loss, dt, m = self._dispatch(tr, led, run, i, comp,
                                                fresh, waves)
            if busy is not None:
                busy_s.append(busy_seconds(busy))
            for j, x in zip(ids, loss):
                losses[j] = x
            keys.append((tuple(comp), c_mult, ratio, len(ids)))
            meas.append(m)
            seconds.append(dt)
            fresh_flags.append(fresh)
            mx.histogram("trainer.dispatch_s").observe(dt)
            measured.append(dt if self.wave_time_fn is None
                            else self.wave_time_fn(
                                waves if self.pipelined else waves[0]))
            if self.telemetry_fn is not None:
                self.telemetry_fn(waves, measured[-1], fresh, wall_s=dt)
        for _ in items:                 # drain the prefetch epilogue so
            pass                        # producer errors still surface
        losses, rank_seconds, meas = self._share_waves(
            losses, seconds, meas if led is not None else None)
        if led is not None:
            self._record_ledger(led, keys, fresh_flags, meas)
        modeled = self.wave_time_fn is not None
        for i, (ids, *_) in enumerate(units):
            self._observe([plan.waves[j] for j in ids], measured[i]
                          if modeled else rank_seconds[i], fresh_flags[i],
                          modeled=modeled)
        with tr.span("apply", step=self.step):
            self.params, self.opt_state, om = self.apply_step(
                self.params, self.opt_state, grads)
            del grads
            # ONE device->host fetch for the whole sentinel summary
            om_keys = list(om)
            vals = torch.stack([torch.as_tensor(om[k]).to(
                device=self.rt.device, dtype=torch.float64)
                for k in om_keys]).tolist()
            om = dict(zip(om_keys, vals))
            for k in ("applied", "grad_nonfinite"):
                om[k] = int(om[k])
        if self.tcfg.calibrate and self.calib.n_observed > 0:
            self.sched.update_rank_speed(self.calib.rank_speed())
            if self.tcfg.recalibrate_every > 0 \
                    and (self.step + 1) % self.tcfg.recalibrate_every == 0:
                refit = self.calib.coeffs()
                if refit is not None:
                    self.sched.update_coeffs(refit)
        # compiled keys seed future windows' composition templates
        self.sched.service.warm_keys(list(self._exec_cache))
        self.step += 1
        rec = {"step": self.step, "loss": float(np.sum(losses)),
               "waves": len(plan.waves), "tokens": int(plan.denom),
               "bubble_frac": plan.stats["bubble_frac"],
               "grad_norm": float(om["grad_norm"]),
               "wall_s": self._clock() - t0,
               "t_wall": time.time()}
        if self.pipelined:
            rec["rounds"] = len(units)
            rec["bubble_frac_pipeline"] = pipeline_schedule_stats(
                plan, self.rt.num_stages,
                self.tcfg.max_round_waves)["bubble_frac_pipeline"]
        self.history.append(rec)
        self.last_numerics = {
            "step": self.step - 1, "loss": rec["loss"],
            "grad_norm": rec["grad_norm"],
            "grad_nonfinite": om["grad_nonfinite"],
            "applied": om["applied"], "wave_losses": losses,
            "wave_seconds": [np.asarray(x).tolist() for x in rank_seconds],
            "sentinels": {k: v for k, v in om.items() if k != "applied"}}
        if self.pipelined:
            # this rank's own: each round's seconds and compute seconds
            self.last_numerics["round_seconds"] = seconds
            self.last_numerics["round_busy_s"] = busy_s
            self.last_numerics["rounds"] = [list(ids) for ids, *_ in units]
            self.last_numerics["round_losses"] = [
                float(np.sum([losses[j] for j in ids])) for ids, *_ in units]
        mx.counter("trainer.steps").inc()
        mx.counter("trainer.waves").inc(len(plan.waves))
        mx.gauge("trainer.loss").set(rec["loss"])
        mx.gauge("trainer.step_wall_s").set(rec["wall_s"])
        if om["applied"] == 0:
            mx.counter("numerics.guard_skips").inc()
        mx.gauge("numerics.grad_nonfinite").set(float(om["grad_nonfinite"]))
        get_recorder().record("train_step", step=self.step,
                              loss=rec["loss"], waves=rec["waves"],
                              wall_s=rec["wall_s"])
        mx.export_step(self.step)
        if self.ckpt is not None and self.tcfg.ckpt_save \
                and self.step % self.tcfg.ckpt_every == 0:
            with tr.span("checkpoint", step=self.step):
                self._save()
        return rec

    def run(self, steps: Optional[int] = None):
        """``steps`` more steps, then (with ``ckpt_dir`` and ``ckpt_save``)
        a blocking save of the last one, unless the periodic save already
        wrote it.  Over several ranks one collective follows world rank
        0's write, so no rank returns before the checkpoint is on disk."""
        n = steps if steps is not None else self.tcfg.steps
        for _ in range(n):
            yield self.train_step()
        if self.ckpt is None or not self.tcfg.ckpt_save:
            return
        if self.last_ckpt_step != self.step:
            self._save(block=True)
        if self._lead():
            self.ckpt.wait()
            self.ckpt_stats.update(self.ckpt.last_save)
        if self._multi:
            self._all_gather_ints([self.step])
