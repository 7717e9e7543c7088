"""SchedulerService: the single-controller scheduling loop as a service.

Owns everything the trainer used to ask `GlobalScheduler` for, plus the
lookahead window and the async pipeline:

* **Windows.**  Steps are planned in aligned windows of K
  (``lookahead``) consecutive steps through `sched.lookahead.plan_window`;
  the template registry and the per-rank load accumulator persist across
  windows, so compile keys converge to a small steady-state set and rank
  balance carries over window boundaries.

* **Async plan/dispatch.**  With ``async_plan=True`` a daemon planner
  thread keeps the plans for the next ``plan_ahead`` steps ready while the
  trainer executes step t, and — when a `WaveMaterializer` is attached —
  pre-builds each planned step's wave buffers (the materialization future),
  bounded to ``plan_ahead`` steps of buffers.  Planner-thread exceptions
  are captured and re-raised at the consumer's next call, never swallowed.
  Plans for a step are fixed when its window is planned: calibration
  feedback (`update_rank_speed` / `update_coeffs`) applies from the next
  *unplanned* window on — measured-speed staleness of at most
  ``plan_ahead + lookahead`` steps, the price of hiding plan+materialize
  latency (paper §7's remote dataloader makes the same trade).

* **Calibration inputs.**  `update_rank_speed` replaces the straggler
  weights; `update_coeffs` swaps refitted Eq. 3 coefficients into the
  PlanSpec.  Both only touch future windows, so a plan the executor
  already holds never mutates under it.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hdp import StepPlan
from repro_torch.core.planner import PlanSpec
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.sched.lookahead import plan_window, template_class


class SchedulerService:
    def __init__(self, dataset, spec: PlanSpec, *, lookahead: int = 1,
                 async_plan: bool = False, plan_ahead: int = 2):
        self.ds = dataset
        self.spec = spec
        self.lookahead = max(1, int(lookahead))
        self.plan_ahead = max(1, int(plan_ahead))
        self.async_plan = bool(async_plan)
        self.rank_speed: Optional[np.ndarray] = None
        self.templates: Dict[Tuple, Tuple] = {}
        self.load = np.zeros(spec.hdp)
        self._plans: Dict[int, StepPlan] = {}
        self._waves: Dict[int, List] = {}
        self._warm_pending: List[Tuple] = []
        self._materializer = None
        self._rounds_fn = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # every plan_window call serializes on this: the template registry
        # and load accumulator are shared mutable state, and the worker,
        # the sync path and the replay path may otherwise interleave.
        # Order: _plan_lock is never acquired while holding _cv.
        self._plan_lock = threading.Lock()
        self._cursor = 0               # next step the consumer will consume
        self._planned_until = 0        # steps [0, _planned_until) are done
        self._err: Optional[BaseException] = None
        self._stopped = False
        # the planner thread starts lazily on the first consumer call, so
        # construction-time spec rewrites (Trainer._align_offload) land
        # before any window is planned
        self._thread: Optional[threading.Thread] = None

    # -- configuration -------------------------------------------------
    def attach_materializer(self, materializer, rounds_fn=None) -> None:
        """Enable materialize-ahead: the planner thread pre-builds each
        planned step's wave buffers (WaveMaterializer.materialize).

        ``rounds_fn(plan) -> rounds`` switches to the PIPELINED product:
        instead of per-wave buffers the thread pre-builds each round's
        stacked ``[M, ...]`` microbatch buffers
        (WaveMaterializer.materialize_round), so PP runs get the same
        async prefetch as the non-PP path.  The callable must reproduce
        exactly the executor's round split (the trainer passes
        ``pipeline_rounds(plan, max_round_waves)``)."""
        with self._cv:
            self._materializer = materializer
            self._rounds_fn = rounds_fn
            self._cv.notify_all()

    def warm_keys(self, keys) -> None:
        """Seed the template registry with compositions the trainer has
        already compiled, so new windows reuse hot executables.  Keys are
        staged under _cv and merged at the next window's planning — taking
        _plan_lock here would stall the training loop behind an in-flight
        window plan, the very latency async mode exists to hide."""
        with self._cv:
            self._warm_pending.extend((tuple(comp), int(c_mult))
                                      for comp, c_mult, _off in keys)

    def update_rank_speed(self, speed) -> None:
        with self._cv:
            self.rank_speed = None if speed is None \
                else np.asarray(speed, float)

    def update_coeffs(self, coeffs) -> None:
        with self._cv:
            self.spec = self.spec.replace(coeffs=coeffs)

    # -- persistence (checkpoint data_state) ---------------------------
    def state_dict(self) -> dict:
        """JSON-safe scheduler state: straggler weights, the cross-window
        load accumulator, the composition-template registry and the
        blended CostCoeffs — everything an elastic restart needs to
        resume planning warm instead of re-learning from scratch.
        Takes ``_plan_lock`` (then ``_cv`` — the established order):
        templates and load are mutated by the planner thread under
        ``_plan_lock``, so a ``_cv``-only snapshot could tear or hit a
        dict-changed-size-during-iteration."""
        with self._plan_lock, self._cv:
            c = self.spec.coeffs
            return {
                "hdp": int(self.spec.hdp),
                "rank_speed": None if self.rank_speed is None
                else [float(s) for s in self.rank_speed],
                "load": [float(x) for x in self.load],
                "templates": [[list(widths), int(c_mult), list(comp)]
                              for (widths, c_mult), comp
                              in self.templates.items()],
                "coeffs": [float(c.a1), float(c.b1), float(c.g),
                           float(c.a2), float(c.b2)],
            }

    def load_state(self, state: dict,
                   rank_map: Optional[List[int]] = None,
                   src_world: Optional[int] = None) -> None:
        """Restore a `state_dict` snapshot.  Identity restore (``rank_map
        is None``) requires the state's hdp to match and reloads
        everything.  With ``rank_map`` (elastic shrink: ranks of the
        ``src_world``-sized previous axis now occupying new ranks
        0..hdp-1) the per-rank SPEEDS follow the surviving ranks, while
        the load accumulator resets and templates that no longer tile
        the new axis are dropped — both describe the dead geometry, not
        the survivors.  A snapshot whose hdp is neither the new world
        (identity) nor ``src_world`` (the axis the map indexes) keeps
        only its coeffs: a double shrink can outrun checkpointing, and
        misapplying the map would assign survivors other ranks'
        speeds."""
        from repro_torch.core.offload import CostCoeffs
        with self._plan_lock:           # order: _plan_lock before _cv
            with self._cv:
                coeffs = state.get("coeffs")
                if coeffs is not None:
                    self.spec = self.spec.replace(coeffs=CostCoeffs(*coeffs))
                speed = state.get("rank_speed")
                hdp = self.spec.hdp
                if rank_map is None:
                    if state.get("hdp") != hdp:
                        return          # stale geometry: coeffs only
                    if speed is not None and len(speed) == hdp:
                        self.rank_speed = np.asarray(speed, float)
                    load = state.get("load")
                    if load is not None and len(load) == hdp:
                        self.load = np.asarray(load, float)
                    items = state.get("templates", [])
                else:
                    idx = list(rank_map)
                    world_ok = src_world is None \
                        or state.get("hdp") == src_world
                    if world_ok and speed is not None and len(idx) == hdp \
                            and max(idx, default=-1) < len(speed):
                        self.rank_speed = np.asarray(
                            [speed[i] for i in idx], float)
                    self.load = np.zeros(hdp)
                    items = state.get("templates", [])
                for widths, c_mult, comp in items:
                    if sum(comp) == hdp:
                        self.templates.setdefault(
                            (tuple(widths), int(c_mult)), tuple(comp))

    # -- planning ------------------------------------------------------
    def _window_start(self, step: int) -> int:
        return step - step % self.lookahead

    def _plan_one_window(self, t0: int,
                         transient: bool = False) -> Dict[int, StepPlan]:
        """Plan window [t0, t0+K).  All planning serializes on
        ``_plan_lock`` (templates and the load accumulator are shared
        mutable state).  ``transient`` replans an already-consumed window
        (non-monotonic replay) against a COPY of the load accumulator so
        its costs are not double-counted into future leveling."""
        with self._plan_lock, \
                get_tracer().span("plan_window", t0=t0,
                                  k=self.lookahead, transient=transient):
            with self._cv:
                pending, self._warm_pending = self._warm_pending, []
            for comp, c_mult in pending:
                self.templates.setdefault(template_class(comp, c_mult),
                                          comp)
            k = self.lookahead
            spec = self.spec.replace(rank_speed=self.rank_speed)
            window = [self.ds.step_lengths(t) for t in range(t0, t0 + k)]
            load = self.load.copy() if transient else self.load
            # scheduler provenance (obs/numerics + obs/replay): the exact
            # pre-plan state this window is a deterministic function of,
            # shaped like state_dict() — which we cannot call here, it
            # takes _plan_lock.  Captured after the warm-key merge and
            # BEFORE plan_window mutates load/templates, and stamped on
            # every plan so it rides shipped plans to workers and lands
            # in each step's StepProvenance record.
            c = spec.coeffs
            prov = {
                "t0": int(t0), "k": int(k), "hdp": int(spec.hdp),
                "transient": bool(transient),
                "rank_speed": None if self.rank_speed is None
                else [float(s) for s in self.rank_speed],
                "load": [float(x) for x in load],
                "templates": [[list(w), int(m), list(comp)]
                              for (w, m), comp in self.templates.items()],
                "coeffs": [float(c.a1), float(c.b1), float(c.g),
                           float(c.a2), float(c.b2)],
            }
            plans = plan_window(window, spec, templates=self.templates,
                                load=load)
            for p, lengths in zip(plans, window):
                p.stats["lengths"] = len(lengths)
                p.stats["sched_prov"] = prov
            mx = get_metrics()
            mx.counter("sched.windows_planned").inc()
            mx.gauge("sched.templates").set(len(self.templates))
            return dict(zip(range(t0, t0 + k), plans))

    def _plan_forward(self, step: int) -> None:
        """Synchronous path: plan windows (persisting load/templates)
        until ``step`` is covered.  Runs outside _cv; publishes under it
        with the same never-backwards cursor rule as the worker."""
        while True:
            with self._cv:
                if self._planned_until > step:
                    return
                t0 = self._window_start(self._planned_until)
            plans = self._plan_one_window(t0)
            with self._cv:
                self._plans.update(plans)
                self._planned_until = max(self._planned_until,
                                          t0 + self.lookahead)
                self._cv.notify_all()

    def _worker(self) -> None:
        get_tracer().set_thread_name("sched-planner")
        try:
            while True:
                with self._cv:
                    while (not self._stopped
                           and self._planned_until
                           >= self._cursor + self.plan_ahead
                           and not self._mat_pending_locked()):
                        self._cv.wait()
                    if self._stopped:
                        return
                    need_plan = (self._planned_until
                                 < self._cursor + self.plan_ahead)
                    t0 = self._window_start(self._planned_until)
                    mat_step = self._next_mat_step_locked()
                    materializer = self._materializer
                    rounds_fn = self._rounds_fn
                    mat_plan = self._plans.get(mat_step) \
                        if mat_step is not None else None
                if need_plan:
                    plans = self._plan_one_window(t0)
                    with self._cv:
                        self._plans.update(plans)
                        # max(): a consumer fast-forward (checkpoint
                        # resume) may have jumped the cursor while this
                        # window was planning — never move it backwards
                        self._planned_until = max(self._planned_until,
                                                  t0 + self.lookahead)
                        self._cv.notify_all()
                elif mat_plan is not None and materializer is not None:
                    with get_tracer().span("materialize_ahead",
                                           step=mat_step):
                        if rounds_fn is not None:  # pipelined: stacked
                            waves = [materializer.materialize_round(
                                         mat_step, mat_plan, rd)
                                     for rd in rounds_fn(mat_plan)]
                        else:
                            waves = [materializer.materialize(mat_step, w)
                                     for w in mat_plan.waves]
                    get_metrics().counter("sched.steps_premat").inc()
                    with self._cv:
                        if mat_step > self._cursor:
                            # the consumer moved past this step while it
                            # materialized: drop, don't leak the buffers
                            self._waves[mat_step] = waves
                        self._cv.notify_all()
        except BaseException as e:       # surface in the consumer, loudly
            with self._cv:
                self._err = e
                self._cv.notify_all()

    def _mat_pending_locked(self) -> bool:
        return self._next_mat_step_locked() is not None

    def _next_mat_step_locked(self) -> Optional[int]:
        if self._materializer is None:
            return None
        # start past the in-flight step: the consumer is already
        # materializing _cursor through its own loader fallback, so
        # pre-building it here would be duplicated work thrown away
        for t in range(self._cursor + 1,
                       min(self._planned_until,
                           self._cursor + 1 + self.plan_ahead)):
            if t in self._plans and t not in self._waves:
                return t
        return None

    # -- serve-mode planning -------------------------------------------
    def plan_pool(self, lengths) -> StepPlan:
        """Serve-mode planning: one plan for the CURRENT request pool,
        keyed on the live lengths instead of a dataset step.  The serving
        engine calls this every admission round as requests arrive and
        finish, so the composition re-adapts to whatever mix is waiting.

        Shares the template registry (compile-key reuse across rounds —
        an engine that has jitted (4,4) prefill keeps getting (4,4) for
        near-identical pools) and the load accumulator + rank_speed
        (slow ranks keep getting less prefill work), all under the same
        ``_plan_lock`` discipline as the step-keyed paths.  The attached
        dataset is never touched, so a service constructed with
        ``dataset=None`` supports serve mode alone."""
        lengths = [int(x) for x in lengths]
        if not lengths:
            raise ValueError("plan_pool needs a non-empty request pool")
        with self._plan_lock, \
                get_tracer().span("plan_pool", n=len(lengths)):
            with self._cv:
                if self._err is not None:
                    raise self._err
                if self._stopped:
                    raise RuntimeError("SchedulerService is stopped")
                pending, self._warm_pending = self._warm_pending, []
                spec = self.spec.replace(rank_speed=self.rank_speed)
            for comp, c_mult in pending:
                self.templates.setdefault(template_class(comp, c_mult),
                                          comp)
            plans = plan_window([lengths], spec, templates=self.templates,
                                load=self.load)
            plans[0].stats["lengths"] = len(lengths)
            get_metrics().counter("sched.pool_plans").inc()
            return plans[0]

    # -- consumer API --------------------------------------------------
    def plan_step(self, step: int) -> StepPlan:
        """The plan for ``step`` (blocking until the planner thread has it,
        in async mode).  Consuming a step releases everything before it."""
        plan, _ = self.get_step(step, want_waves=False)
        return plan

    def get_step(self, step: int, want_waves: bool = True
                 ) -> Tuple[StepPlan, Optional[List]]:
        """(plan, materialized waves or None).  Waves come back non-None
        only when a materializer is attached and the planner thread got
        there first — the caller falls back to its own loader otherwise."""
        with self._cv:
            if self._err is not None:
                raise self._err
            if self._stopped:
                raise RuntimeError("SchedulerService is stopped")
            self._cursor = max(self._cursor, step)
            if step >= self._planned_until:
                # fast-forward (checkpoint resume lands at step N): jump
                # the window cursor instead of replanning every window
                # since 0 — only the window containing `step` and later
                # ones are ever planned
                self._planned_until = max(self._planned_until,
                                          self._window_start(step))
            if self.async_plan and self._thread is None:
                # started only after the cursor/fast-forward state above
                # is in place: a worker spun up earlier could capture the
                # pre-resume window and pollute the persistent load
                # accumulator with steps that never execute
                self._thread = threading.Thread(target=self._worker,
                                                daemon=True,
                                                name="sched-planner")
                self._thread.start()
            self._cv.notify_all()
            if self.async_plan:
                while self._planned_until <= step and self._err is None \
                        and not self._stopped:
                    self._cv.wait()
                if self._err is not None:
                    raise self._err
                if self._stopped and step not in self._plans:
                    raise RuntimeError("SchedulerService stopped while "
                                       f"waiting for step {step}")
            plan = self._plans.get(step)
            waves = self._waves.get(step) if want_waves else None
            # consumed steps free their plans and buffers
            for t in [t for t in set(self._plans) | set(self._waves)
                      if t < step]:
                self._plans.pop(t, None)
                self._waves.pop(t, None)
            self._cv.notify_all()
        if plan is None and not self.async_plan:
            self._plan_forward(step)                 # outside _cv
            with self._cv:
                plan = self._plans.get(step)
                if want_waves and waves is None:
                    waves = self._waves.get(step)
        if plan is None:
            # non-monotonic replay of an already-evicted step: plan its
            # window on demand against a load COPY (templates still apply
            # so layouts stay consistent), and never overwrite a live
            # plan — materialized buffers must stay paired with the plan
            # they were built from
            fresh = self._plan_one_window(self._window_start(step),
                                          transient=True)
            with self._cv:
                for t, p in fresh.items():
                    self._plans.setdefault(t, p)
                plan = self._plans[step]
                if want_waves and waves is None:
                    waves = self._waves.get(step)
        return plan, waves

    def stop(self, join_timeout: float = 5.0) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
