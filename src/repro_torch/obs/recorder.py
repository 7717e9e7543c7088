"""Flight recorder: a bounded ring of recent events, dumped on failure.

Postmortems after an elastic event used to reconstruct the timeline from
nothing — the controller knew a worker died, but not what the fleet was
doing in the seconds before.  The recorder keeps the last ``capacity``
structured events (dispatches, plans, heartbeat stream summaries,
membership changes) in memory at all times, stamped with the monotonic
AND wall clock, and `dump()` writes them — plus the tracer's recent span
tail and a metrics snapshot — to a JSON file when something dies:

* the controller dumps on `MembershipChange` (a worker was declared
  dead) before entering elastic recovery;
* a worker agent dumps on any uncaught exception escaping its loop;
* `install_excepthook()` catches anything else at interpreter level.

Dump location: ``$REPRO_OBS_DIR`` (created if needed), defaulting to
``obs_out/`` so postmortems never litter the working tree; filenames
are ``flightrec_<reason>_<pid>_<n>.json``.  Recording is always on —
the ring is a few hundred small dicts.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import List, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.trace import monotime


class FlightRecorder:
    def __init__(self, capacity: int = 512, process: str = "main"):
        self.process = process
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._n_dumps = 0
        self.meta: dict = {}

    def set_meta(self, key: str, value) -> None:
        """Attach sticky run-level context (e.g. the trainer's
        ``run_manifest`` — obs/numerics.py) included in every dump;
        unlike ring events, meta never rotates out."""
        with self._lock:
            self.meta[key] = _trace._jsonsafe(value)

    def record(self, kind: str, **payload) -> None:
        ev = {"kind": kind, "t_mono": monotime(), "t_wall": time.time()}
        if payload:
            ev.update(_trace._jsonsafe(payload))
        with self._lock:
            self._ring.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- dumping -------------------------------------------------------
    def dump(self, reason: str, path: Optional[str] = None,
             trace_tail: int = 256) -> str:
        """Write the ring (+ recent spans + metrics snapshot) to disk and
        return the path.  Never raises — a postmortem writer that throws
        during teardown would mask the original failure."""
        with self._lock:
            events = list(self._ring)
            meta = dict(self.meta)
            self._n_dumps += 1
            n = self._n_dumps
        rotate_dir = None
        if path is None:
            d = os.environ.get("REPRO_OBS_DIR", "obs_out")
            try:
                os.makedirs(d, exist_ok=True)
            except OSError:
                d = "."
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in reason)[:48]
            path = os.path.join(
                d, f"flightrec_{safe}_{os.getpid()}_{n}.json")
            rotate_dir = d
        doc = {"reason": reason, "process": self.process,
               "pid": os.getpid(),
               "dumped_t_wall": time.time(),
               "dumped_t_mono": monotime(),
               "meta": meta,
               "events": events,
               "trace_tail": _trace.get_tracer().tail(trace_tail),
               "metrics": _trace._jsonsafe(
                   _metrics.get_metrics().snapshot())}
        try:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
        except OSError as e:
            sys.stderr.write(f"[obs] flight-recorder dump failed: {e!r}\n")
            return ""
        sys.stderr.write(f"[obs] flight record ({reason}) -> {path}\n")
        if rotate_dir is not None:
            _rotate_dumps(rotate_dir)
        return path

    def install_excepthook(self) -> None:
        """Dump on any uncaught exception, then chain to the previous
        hook (idempotent per recorder)."""
        prev = sys.excepthook

        def hook(exc_type, exc, tb):
            if getattr(hook, "_fired", False):     # re-entrancy guard
                return prev(exc_type, exc, tb)
            hook._fired = True
            self.record("uncaught_exception",
                        exc=repr(exc),
                        tb="".join(traceback.format_exception(
                            exc_type, exc, tb))[-4000:])
            self.dump("uncaught_exception")
            return prev(exc_type, exc, tb)

        sys.excepthook = hook


def _rotate_dumps(d: str) -> None:
    """Retention: repeated anomalies used to accumulate dumps in
    ``$REPRO_OBS_DIR`` without bound.  Keep the newest
    ``$REPRO_OBS_MAX_DUMPS`` (default 16) ``flightrec_*.json`` files,
    unlinking oldest-first by mtime.  Never raises — retention must not
    mask the failure being dumped."""
    try:
        cap = int(os.environ.get("REPRO_OBS_MAX_DUMPS", "16"))
        if cap <= 0:
            return
        names = [os.path.join(d, f) for f in os.listdir(d)
                 if f.startswith("flightrec_") and f.endswith(".json")]
        if len(names) <= cap:
            return
        names.sort(key=lambda p: (os.path.getmtime(p), p))
        for p in names[:len(names) - cap]:
            try:
                os.unlink(p)
            except OSError:
                pass
    except Exception:
        pass


_global = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _global
