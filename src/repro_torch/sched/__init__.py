"""Lookahead scheduling service (copied from the reference package).

`sched.lookahead` is the window planner; `sched.service` the
`SchedulerService` that owns templates, load and rank speeds and answers
the serving engine's `plan_pool`.  The online calibrator waits for the
training slice."""
from repro_torch.sched.lookahead import plan_window, wave_key, window_stats
from repro_torch.sched.service import SchedulerService

__all__ = ["SchedulerService", "plan_window", "wave_key", "window_stats"]
