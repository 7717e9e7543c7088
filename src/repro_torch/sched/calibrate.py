"""Online calibration: measured wave wall times → planner inputs.

The trainer's old straggler loop EMA'd the *modeled* per-rank costs of the
plan it had just executed — on a perfectly balanced plan every rank's
modeled cost is equal, so the estimate carried no information and a real
straggler was invisible.  This module replaces it with measurement:

* **Per-rank speed.**  Two measurement channels, matching what the
  deployment can observe:

  - ``rank_seconds`` — per-rank compute times, the paper's worker→
    controller telemetry under async dispatch (§6.1: devices run their
    own wave queues and report).  Each active rank's ratio of measured to
    modeled time is a direct, well-identified speed sample.
  - ``seconds`` — the SPMD wall time of the whole dispatch (all the
    single-process trainer can measure): max_r cost_r / speed_r.  It is
    attributed to the wave's modeled bottleneck rank(s).  NOTE the
    identifiability limit: on a perfectly level wave every rank is a
    bottleneck candidate, so a straggler that is busy in *every* wave
    cannot be localized from wall times alone — the signal comes from
    waves where it idles (and grows as feedback gives it less work).

  A global scale — the rolling median of measured/modeled ratios —
  removes the cost model's absolute error; what remains per rank is its
  *relative* speed.  Ranks never observed stay at their prior (1.0).
  Residuals are always attributed against the scale as it stood BEFORE
  the current sample landed (attributing a wall sample against a scale
  it just moved biases every speed estimate toward 1), and nothing is
  attributed or outlier-gated until a short warmup has filled the
  median (a spike on the very first observation used to seed the scale
  and then gate every honest sample against the poisoned value).

* **CostCoeffs refit.**  T(s) is a *per-sequence* curve — a packed bin
  costs Σ T(len_i), a g-sharded sequence T(len)/g — so only observations
  whose bottleneck rank held exactly one whole, unsharded sequence are
  unit-consistent (length, seconds) samples for the fit; the caller marks
  them via ``fit_length`` and everything else contributes to scale/speed
  only.  Clean samples feed a least-squares refit of T(s) = α₁s² + β₁s + γ
  via `core.profiler.fit_time_coeffs`, blended toward the running
  coefficients so one noisy window cannot capsize the planner
  (`profiler.blend_coeffs`).

Compile-time pollution is the caller's job to exclude: the trainer skips
`observe` for waves that triggered a fresh jit compile.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.offload import CostCoeffs
from repro_torch.obs import get_metrics


def fit_length_of(waves) -> Optional[int]:
    """A unit-consistent T(s) sample exists only when the dispatch was a
    single wave whose bottleneck rank ran exactly one whole, unsharded
    sequence (a packed bin costs Σ T(len_i), a sharded one T(len)/g, a
    round M·T(s) — all different curves than T(s)).  Shared by the
    trainer's local observation path and the controller's telemetry
    ingestion (ctrl/controller.py)."""
    if len(waves) != 1:
        return None
    w = waves[0]
    r = int(np.argmax(w.costs))
    width, start = 1, 0
    for g in w.composition:
        if start <= r < start + g:
            width = g
            break
        start += g
    slot = w.slots[r]
    if width == 1 and len(slot) == 1 and slot[0].start == 0:
        return slot[0].length
    return None

_TIE_FRAC = 0.98          # ranks within 2% of the wave max share the blame
_OUTLIER = 8.0            # drop samples > 8x the running scale (GC, page-in)
_WARMUP = 3               # ratio samples before the outlier gate and the
                          # speed attribution engage (a median over fewer
                          # is whatever spike happened to come first)
_SCALE_WINDOW = 64        # rolling window the scale median is taken over
_GRAD_STEP_FACTOR = 3.0   # measured walls are fwd+bwd grad steps; T(s) is
                          # the forward-only curve (bwd ~ 2x fwd FLOPs), so
                          # fit samples are de-scaled by this before the fit


class OnlineCalibrator:
    """Accumulates measured (wave, seconds) observations and answers with
    per-rank relative speeds and refitted cost coefficients."""

    def __init__(self, coeffs: CostCoeffs, hdp: int, num_layers: int, *,
                 quadratic: bool = True, ema: float = 0.5,
                 max_samples: int = 256, min_fit_points: int = 4,
                 fit_time_scale: float = _GRAD_STEP_FACTOR):
        self.base = coeffs
        self.hdp = hdp
        self.num_layers = max(num_layers, 1)
        self.quadratic = quadratic
        self.ema = ema
        self.min_fit_points = min_fit_points
        self.fit_time_scale = max(fit_time_scale, 1e-9)
        self._speed = np.ones(hdp)
        # measured/modeled ratios; the scale is their rolling median, so a
        # GC/page-in spike on the FIRST observation cannot seed the scale
        # and then gate every honest sample against the poisoned value
        self._ratios: Deque[float] = deque(maxlen=_SCALE_WINDOW)
        self._samples: Deque[Tuple[int, float]] = deque(maxlen=max_samples)
        self.n_observed = 0
        # bytes-ledger audit channel (obs/ledger.py): EMA of the relative
        # |predicted - measured| comm-bytes residual per dispatch — a
        # drifting value means the analytic byte model (the same model
        # Eq. 2/Eq. 3 price communication with) no longer matches what
        # the executables actually move
        self._bytes_residual: Optional[float] = None
        self._bytes_n = 0

    @property
    def _scale(self) -> Optional[float]:
        """Fleet-wide measured/modeled scale: rolling median, None until
        any observation landed."""
        if not self._ratios:
            return None
        return float(np.median(self._ratios))

    def _scale_ref(self) -> Optional[float]:
        """The scale residuals are attributed against — None during warmup
        (too few samples for the median to mean anything)."""
        if len(self._ratios) < _WARMUP:
            return None
        return float(np.median(self._ratios))

    # ------------------------------------------------------------------
    def observe(self, costs, seconds: Optional[float] = None,
                rank_seconds=None, fit_length: Optional[int] = None) -> None:
        """One executed wave (or pipelined round): ``costs`` are the plan's
        modeled per-rank times, and the measurement is either ``seconds``
        (SPMD wall time) or ``rank_seconds`` (per-rank worker telemetry) —
        see module docstring for what each channel can identify.
        ``fit_length`` marks a unit-consistent T(s) sample (the bottleneck
        rank ran one whole unsharded sequence of that length); without it
        the observation updates scale/speed only."""
        costs = np.asarray(costs, float)
        modeled = float(costs.max(initial=0.0))
        if modeled <= 0.0:
            return
        if rank_seconds is not None:
            rank_seconds = np.asarray(rank_seconds, float)
            seconds = float(rank_seconds.max(initial=0.0))
        if seconds is None or seconds <= 0.0:
            return
        ratio = seconds / modeled                   # wall per modeled second
        # the reference scale is taken BEFORE this sample lands: gating a
        # sample against a scale it already moved under-rejects spikes,
        # and attributing against a scale it already moved biases every
        # wall-channel speed sample toward 1 (self-comparison)
        ref = self._scale_ref()
        if ref is not None and ratio > _OUTLIER * ref:
            get_metrics().counter("calib.outliers").inc()
            return                                  # compile / GC spike
        self._ratios.append(float(ratio))
        if ref is not None:
            if rank_seconds is not None:
                # per-rank samples: measured_r = scale * cost_r / speed_r
                active = np.flatnonzero((costs > 0) & (rank_seconds > 0))
                for r in active:
                    rel = ref * costs[r] / rank_seconds[r]
                    self._speed[r] = (self.ema * self._speed[r]
                                      + (1 - self.ema) * rel)
            else:
                # wall time blames the modeled bottleneck rank(s): how much
                # faster/slower the wave ran than the fleet scale predicts
                rel = ref / ratio
                for r in np.flatnonzero(costs >= _TIE_FRAC * modeled):
                    self._speed[r] = (self.ema * self._speed[r]
                                      + (1 - self.ema) * rel)
        if fit_length is not None and fit_length > 0:
            # de-scale the grad-step wall to the forward-only curve T(s)
            # fits (profile_model feeds the same fitter forward timings)
            self._samples.append((int(fit_length), seconds
                                  / self.num_layers / self.fit_time_scale))
        self.n_observed += 1
        mx = get_metrics()
        mx.counter("calib.observations").inc()
        scale = self._scale
        if scale is not None:
            mx.gauge("calib.scale").set(scale)
        mx.gauge("calib.speed").set(self.rank_speed())

    # ------------------------------------------------------------------
    def ingest(self, costs, reports: Iterable[Tuple[Sequence[int],
                                                    Sequence[float]]], *,
               fresh: bool = False, exact: bool = True,
               fit_length: Optional[int] = None) -> None:
        """Paper §6.1 worker→controller telemetry: assemble per-worker
        PARTIAL per-rank measurements of one dispatch into a full
        ``rank_seconds`` vector and observe it.  ``reports`` is an
        iterable of ``(rank_ids, seconds_per_rank)`` — each worker reports
        the wall times of exactly the global ranks it owns; ranks no
        surviving worker covers stay 0 and are excluded from the speed
        update (`observe`'s active mask).  ``fresh`` marks a dispatch that
        paid a jit compile on any worker — its wall time says nothing
        about rank speed, so the whole observation is skipped (same rule
        as the trainer's local path).

        ``exact=False`` marks reports where a worker attributed ONE wall
        clock to every rank it owns (all a per-host agent can measure
        without device timers).  Dividing cost_r by that shared wall
        would mark every lightly-loaded rank slow on any imbalanced wave,
        so the observation degrades to the wall-time channel instead —
        max over reports, bottleneck-blamed (`_TIE_FRAC`), exactly the
        single-process rule."""
        if fresh:
            return
        rank_seconds = np.zeros(self.hdp)
        for ranks, times in reports:
            rank_seconds[np.asarray(list(ranks), int)] = \
                np.asarray(list(times), float)
        if exact:
            self.observe(costs, rank_seconds=rank_seconds,
                         fit_length=fit_length)
        else:
            self.observe(costs,
                         seconds=float(rank_seconds.max(initial=0.0)),
                         fit_length=fit_length)

    # ------------------------------------------------------------------
    def observe_bytes(self, pred_total: float, meas_total: float) -> None:
        """One dispatch's (predicted, measured) comm-bytes totals from the
        ledger; tracked as an EMA'd relative residual in `summary()`."""
        if pred_total <= 0 and meas_total <= 0:
            return
        resid = abs(pred_total - meas_total) \
            / max(abs(pred_total), abs(meas_total), 1.0)
        if self._bytes_residual is None:
            self._bytes_residual = resid
        else:
            self._bytes_residual = (self.ema * self._bytes_residual
                                    + (1 - self.ema) * resid)
        self._bytes_n += 1
        get_metrics().gauge("calib.bytes_residual").set(
            self._bytes_residual)

    # ------------------------------------------------------------------
    def apply_advisory(self, rank: int, slowdown: float) -> None:
        """Mid-step straggler advisory from the anomaly detector
        (obs/anomaly.py): pull ``rank``'s speed estimate toward
        ``1/slowdown`` NOW, without waiting for the step-boundary
        `ingest` batch.  Same EMA weight as a measured sample, so the
        authoritative end-of-step telemetry seamlessly refines (or
        corrects) the advisory's estimate."""
        if not (0 <= rank < self.hdp) or slowdown <= 0:
            return
        target = 1.0 / float(slowdown)
        self._speed[rank] = (self.ema * self._speed[rank]
                             + (1 - self.ema) * target)
        mx = get_metrics()
        mx.counter("calib.advisories_applied").inc()
        mx.gauge("calib.speed").set(self.rank_speed())

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe snapshot (checkpoint ``data_state``): an elastic
        restart resumes with warm speeds instead of re-learning stragglers
        from scratch."""
        return {"speed": [float(s) for s in self._speed],
                "scale": None if self._scale is None else float(self._scale),
                "ratios": [float(r) for r in self._ratios],
                "samples": [[int(s), float(t)] for s, t in self._samples],
                "n_observed": int(self.n_observed)}

    def load_state(self, state: dict,
                   rank_map: Optional[Sequence[int]] = None,
                   src_world: Optional[int] = None) -> None:
        """Restore a snapshot.  ``rank_map[i]`` is the rank — in the
        world the map was computed over — now occupying new rank i
        (elastic shrink keeps survivors' learned speeds); ``src_world``
        names that world's size, and a snapshot from any OTHER world is
        skipped (a double shrink can outrun checkpointing, leaving the
        newest snapshot on the pre-previous axis — indexing it with this
        map would hand survivors other ranks' speeds).  ``rank_map=None``
        requires matching world sizes and is a no-op on mismatch."""
        speed = np.asarray(state.get("speed", []), float)
        if rank_map is not None:
            idx = np.asarray(list(rank_map), int)
            if len(idx) != self.hdp or speed.size == 0 \
                    or idx.max(initial=-1) >= speed.size \
                    or (src_world is not None and speed.size != src_world):
                return
            self._speed = speed[idx].copy()
        else:
            if speed.size != self.hdp:
                return
            self._speed = speed.copy()
        ratios = state.get("ratios")
        if ratios is None:
            # pre-rolling-median snapshot: its EMA scale seeds one ratio
            scale = state.get("scale")
            ratios = [] if scale is None else [scale]
        self._ratios = deque((float(r) for r in ratios),
                             maxlen=_SCALE_WINDOW)
        self._samples = deque(((int(s), float(t))
                               for s, t in state.get("samples", [])),
                              maxlen=self._samples.maxlen)
        self.n_observed = int(state.get("n_observed", 0))

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """Report-facing digest (`obs.report.render_report`'s ``calib``
        argument): global scale, the median relative gap of recent
        measured/modeled ratios from that scale (how well Eq. 2/Eq. 3
        track reality once absolute error is removed), rank speeds and
        the observation count."""
        scale = self._scale
        gap = None
        if scale is not None and scale > 0 and self._ratios:
            gap = float(np.median(np.abs(
                np.asarray(self._ratios, float) / scale - 1.0)))
        out = {"scale": scale, "model_gap": gap,
               "speed": [float(s) for s in self.rank_speed()],
               "n_observed": int(self.n_observed)}
        if self._bytes_n > 0:
            out["bytes_residual"] = float(self._bytes_residual)
            out["bytes_n"] = int(self._bytes_n)
        return out

    # ------------------------------------------------------------------
    def rank_speed(self) -> np.ndarray:
        """Mean-1-normalized relative speeds, clamped away from 0 so a
        noisy estimate can only *shift* work, never zero a rank out."""
        s = np.clip(self._speed, 0.1, 10.0)
        return s / max(float(s.mean()), 1e-9)

    def coeffs(self, blend: float = 0.5) -> Optional[CostCoeffs]:
        """Refit T(s) from the measured samples; None until the window
        holds enough *distinct* lengths for the fit to be determined."""
        from repro_torch.core.profiler import blend_coeffs, fit_time_coeffs
        lengths = [s for s, _ in self._samples]
        if len(set(lengths)) < self.min_fit_points:
            return None
        fitted = fit_time_coeffs(lengths, [t for _, t in self._samples],
                                 act_per_token=self.base.a2,
                                 quadratic=self.quadratic)
        return blend_coeffs(self.base, fitted, blend)
