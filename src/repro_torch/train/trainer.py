"""The training loop: HDP waves + gradient accumulation, one process.

Port of `repro/train/trainer.py` on its non-pipelined branch.  Per step
(paper Fig. 7): the GlobalScheduler plans the global batch (sync, or from
the scheduler service's planner thread with pre-materialized waves); each
wave runs through a per-(composition, c_mult, offload) callable — the
cache that stands for the reference's jit executable cache, with its
``trainer.compile_hit``/``compile_miss`` counters; gradients accumulate in
fp32 with token-level loss scaling and one guarded AdamW apply follows,
its sentinel summary fetched from the device once.  Measured wave times
feed the online calibrator (per-rank speeds, refitted cost coefficients)
and compiled keys warm the scheduler's composition templates.

What the port does not run yet raises `NotImplementedError` naming the
ROADMAP queue item that brings it: checkpointing (``ckpt_dir``, queue 1
item 5), pipeline parallelism (queue 1 item 7), offload execution (queue 1
item 4) and elastic ``resize`` (with the ring, queue 1 item 2).  The
numerics monitor, step provenance and the bytes ledger come with queue 1
item 9.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.loader import GlobalScheduler, WaveMaterializer
from repro_torch.models.transformer import init_params
from repro_torch.obs import get_metrics, get_recorder, get_tracer
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import Runtime
from repro_torch.sched.calibrate import OnlineCalibrator, fit_length_of
from repro_torch.train.train_step import make_accum_steps, zeros_accum


@dataclass
class TrainerConfig:
    capacity: int = 512
    steps: int = 10
    ckpt_dir: Optional[str] = None   # checkpointing: not ported yet
    mode: str = "dp"                 # balance mode ("pp": not ported yet)
    use_offload: bool = False        # offload remat: not ported yet
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
    numerics_guard: bool = True      # skip the optimizer apply when any
                                     # grad element is non-finite
    nan_fault: Optional[Dict] = None  # fault injection: {"step": k,
                                      # "wave": i} poisons that wave's
                                      # loss denominator with NaN


class Trainer:
    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime],
                 opt_cfg: adamw.AdamWConfig, scheduler: GlobalScheduler,
                 tcfg: TrainerConfig, seed: int = 0, params=None):
        """``rt=None`` means ``Runtime()`` on the default device (``cuda``;
        it raises without one).  ``params`` (a tree on the runtime's
        device, e.g. bridged from the reference) replaces the seeded
        init; the optimiser state is built from it either way."""
        if tcfg.ckpt_dir is not None:
            raise NotImplementedError(
                "checkpointing (ckpt_dir) comes with the port of "
                "ckpt/checkpoint.py, ROADMAP queue 1 item 5")
        if scheduler.spec.num_stages > 1 or tcfg.mode == "pp":
            raise NotImplementedError(
                "pipeline parallelism comes with ROADMAP queue 1 item 7")
        if tcfg.use_offload and scheduler.spec.use_offload:
            raise NotImplementedError(
                "offload execution comes with ROADMAP queue 1 item 4")
        self.cfg = cfg
        self.rt = rt if rt is not None else Runtime()
        if self.rt.hdp_size > 1:
            raise NotImplementedError(
                "the multi-rank trainer (each rank its slice of every wave, "
                "gradients all-reduced) comes with ROADMAP queue 1 item 3")
        self.opt_cfg = opt_cfg
        self.sched = scheduler
        self.tcfg = tcfg
        self.seed = seed
        if scheduler.hdp != self.rt.hdp_size:
            raise ValueError(f"plan world {scheduler.hdp} must match the "
                             f"runtime's {self.rt.hdp_size} rank")
        self.offload_ok = False
        self._align_offload(scheduler)
        self.loader = WaveMaterializer(scheduler.ds, cfg, tcfg.capacity)
        self.params = params if params is not None else init_params(
            cfg, seed=seed, device=self.rt.device)
        self.opt_state = adamw.init_state(self.params)
        self.step = 0
        self.grad_step, self.apply_step = make_accum_steps(
            cfg, self.rt, opt_cfg, guard=tcfg.numerics_guard)
        self._exec_cache: Dict[tuple, object] = {}
        self.history: list = []
        self.calib = OnlineCalibrator(
            scheduler.spec.coeffs, self.rt.hdp_size, cfg.num_layers,
            quadratic=scheduler.spec.quadratic, ema=tcfg.straggler_ema)
        self.wave_time_fn = None     # fake-clock hook: replaces the
                                     # measured dispatch time (scalar wall
                                     # or per-rank vector)
        self.telemetry_fn = None     # called with (waves, measured, fresh,
                                     # wall_s=host wall) for every dispatch
        self._clock = time.perf_counter
        self.last_numerics: Optional[Dict] = None   # the last step's
        # loss, per-wave losses, sentinels and applied flag
        if tcfg.sched_async:
            scheduler.service.attach_materializer(self.loader)

    def _align_offload(self, scheduler: GlobalScheduler):
        """Waves cannot offload here, so the scheduler must not size groups
        with Eq. 3's offload term either."""
        if scheduler.spec.use_offload and not self.offload_ok:
            scheduler.spec = scheduler.spec.replace(use_offload=False)

    def _wave_rt(self, composition) -> Runtime:
        rt_wave = self.rt.with_composition(composition)
        if self.tcfg.attn_impl is not None:
            rt_wave = dataclasses.replace(rt_wave,
                                          attn_impl=self.tcfg.attn_impl)
        return rt_wave

    def _wave_fn(self, composition, c_mult, offload_ratio):
        """-> (callable, fresh): ``fresh`` marks a cache miss (on the card
        the first dispatch also builds the kernels; the calibrator skips
        it)."""
        key = (tuple(composition), c_mult, round(offload_ratio, 2))
        fresh = key not in self._exec_cache
        get_metrics().counter("trainer.compile_miss" if fresh
                              else "trainer.compile_hit").inc()
        if fresh:
            self._exec_cache[key] = functools.partial(
                self.grad_step, rt_wave=self._wave_rt(composition))
        return self._exec_cache[key], fresh

    def resize(self, new_hdp_scheduler: GlobalScheduler):
        raise NotImplementedError(
            "elastic resize needs more than one rank: it comes with the "
            "torch.distributed ring, ROADMAP queue 1 item 2")

    # ------------------------------------------------------------------
    def _observe(self, waves, measured, fresh_compile: bool,
                 modeled: bool = False, wall_s: Optional[float] = None):
        """Feed one measured dispatch to the telemetry hook and the local
        calibrator (the reference's `_observe`): the hook sees every
        dispatch; the calibrator skips fresh ones unless the time is
        modeled."""
        if self.telemetry_fn is not None:
            self.telemetry_fn(waves, measured, fresh_compile, wall_s=wall_s)
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

    def _dispatch(self, tr, fn, grads, batch, idx: int, composition,
                  fresh: bool, wave):
        """Run one wave under a span; a fresh cache entry's first call sits
        in a nested "compile" span.  The loss fetch blocks until the wave
        has run, so the time is the wave's."""
        extra = {}
        if tr.enabled:
            extra = {"cost_max": round(float(max(wave.costs)), 9),
                     "cost_sum": round(float(sum(wave.costs)), 9),
                     "tokens": int(sum(p.length for slot in wave.slots
                                       for p in slot))}
        with tr.span("wave", step=self.step, idx=idx,
                     composition=composition, fresh=fresh, **extra):
            t_w = self._clock()
            if fresh:
                with tr.span("compile", step=self.step,
                             composition=composition):
                    grads, metrics = fn(self.params, grads, batch)
                    loss = float(metrics["loss"])
            else:
                grads, metrics = fn(self.params, grads, batch)
                loss = float(metrics["loss"])
            dt = self._clock() - t_w
        return grads, loss, dt

    def _nan_fault_hits(self, idx: int) -> bool:
        nf = self.tcfg.nan_fault
        return bool(nf) and self.step == int(nf.get("step", -1)) \
            and idx == int(nf.get("wave", 0))

    def _to_device(self, arrays: Dict[str, np.ndarray], denom: float,
                   idx: int) -> Dict[str, torch.Tensor]:
        dev = self.rt.device
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in arrays.items()}
        batch["denom"] = torch.tensor(
            float("nan") if self._nan_fault_hits(idx) else denom,
            dtype=torch.float32, device=dev)
        return batch

    def train_step(self) -> Dict:
        tr = get_tracer()
        mx = get_metrics()
        t0 = self._clock()
        with tr.span("plan", step=self.step):
            if self.tcfg.sched_async:
                plan, pre_waves = self.sched.get_step(self.step)
            else:
                plan, pre_waves = self.sched.plan_step(self.step), None
        denom = float(plan.denom)
        grads = zeros_accum(self.params)
        losses = []
        wave_iter = iter(pre_waves) if pre_waves is not None \
            else self.loader.iter_step(self.step, plan)
        for i in range(len(plan.waves)):
            with tr.span("materialize", step=self.step, idx=i):
                lw = next(wave_iter)
            wave = plan.waves[i]
            batch = self._to_device(lw.batch, denom, i)
            fn, fresh = self._wave_fn(lw.composition, lw.c_mult,
                                      lw.offload_ratio)
            grads, loss, dt = self._dispatch(tr, fn, grads, batch, i,
                                             lw.composition, fresh, wave)
            losses.append(loss)
            mx.histogram("trainer.dispatch_s").observe(dt)
            wall = dt
            if self.wave_time_fn is not None:
                dt = self.wave_time_fn(wave)
            self._observe([wave], dt, fresh,
                          modeled=self.wave_time_fn is not None, wall_s=wall)
        for _ in wave_iter:             # drain the prefetch epilogue so
            pass                        # producer errors still surface
        with tr.span("apply", step=self.step):
            self.params, self.opt_state, om = self.apply_step(
                self.params, self.opt_state, grads)
            del grads
            # ONE device->host fetch for the whole sentinel summary
            keys = list(om)
            vals = torch.stack([torch.as_tensor(om[k]).to(
                device=self.rt.device, dtype=torch.float64)
                for k in keys]).tolist()
            om = dict(zip(keys, vals))
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
               "waves": len(plan.waves),
               "bubble_frac": plan.stats["bubble_frac"],
               "grad_norm": float(om["grad_norm"]),
               "wall_s": self._clock() - t0,
               "t_wall": time.time()}
        self.history.append(rec)
        self.last_numerics = {
            "step": self.step - 1, "loss": rec["loss"],
            "grad_norm": rec["grad_norm"],
            "grad_nonfinite": om["grad_nonfinite"],
            "applied": om["applied"], "wave_losses": losses,
            "sentinels": {k: v for k, v in om.items() if k != "applied"}}
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
        return rec

    def run(self, steps: Optional[int] = None):
        n = steps if steps is not None else self.tcfg.steps
        for _ in range(n):
            yield self.train_step()
