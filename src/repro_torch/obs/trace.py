"""Structured span tracing with Chrome/Perfetto ``trace_event`` export.

One `Tracer` per process.  Spans are nested intervals on (pid, tid)
lanes — pid is the process/worker/rank lane, tid the OS thread — and
export as Chrome "X" (complete) events, so a dump opens directly in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Clock discipline: every span timestamp comes from ONE monotonic clock
(`monotime`, an alias of ``time.perf_counter``) so durations and
orderings are immune to wall-clock steps; one wall-clock anchor pair is
recorded per tracer (``otherData.wall_anchor``) so traces from multiple
processes can be aligned on their wall clocks without per-event wall
reads.

Disabled-by-default zero-overhead contract: when tracing is off,
``span()`` returns one shared no-op singleton — no span object, no event
record, no lock acquisition is ever allocated or taken on the hot path.
Enable per process with ``REPRO_TRACE=1`` (env, read at import), or
programmatically via `repro_torch.obs.configure(trace=True)`.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: The repo-wide monotonic clock for telemetry and span timing.  All
#: span/metric/telemetry timestamps use this; wall clock (``time.time``)
#: appears only as a separate human-readable/alignment field.
monotime = time.perf_counter


class _NullSpan:
    """Shared no-op span: the entire disabled-tracing path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key: str, value) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "pid", "tid", "t0", "args")

    def __init__(self, tracer: "Tracer", name: str, pid: int,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.pid = pid
        self.tid = threading.get_ident()
        self.args = args
        self.t0 = 0.0

    def set(self, key: str, value) -> None:
        if self.args is None:
            self.args = {}
        self.args[key] = value

    def __enter__(self):
        self.t0 = monotime()
        return self

    def __exit__(self, *exc):
        self._tracer._complete(self)
        return False


class Tracer:
    """Thread-safe span recorder with bounded memory.

    ``max_events`` bounds the buffer (oldest events drop); traces meant
    for offline inspection should export before wraparound, while the
    flight recorder deliberately relies on the tail-keeping behaviour.
    """

    def __init__(self, enabled: bool = False, process: str = "main",
                 pid: int = 0, max_events: int = 200_000):
        self.enabled = bool(enabled)
        self.process = process
        self.pid = int(pid)
        self.max_events = int(max_events)
        self._events: List[dict] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._thread_names: Dict[int, str] = {}
        self._proc_names: Dict[int, str] = {pid: process}
        # wall anchor: one (monotonic, wall) pair taken together, so any
        # event's wall time is wall_anchor + (ts - mono_anchor)
        self._anchor_mono = monotime()
        self._anchor_wall = time.time()

    # -- recording -----------------------------------------------------
    def span(self, name: str, pid: Optional[int] = None,
             **args):
        """Context manager timing a nested span.  Returns the shared
        no-op singleton when tracing is disabled (zero allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, self.pid if pid is None else int(pid),
                     args or None)

    def instant(self, name: str, pid: Optional[int] = None,
                ts: Optional[float] = None, **args) -> None:
        """A zero-duration marker event (ph "i")."""
        if not self.enabled:
            return
        self._append({"name": name, "ph": "i", "s": "t",
                      "ts": self._us(ts if ts is not None else monotime()),
                      "pid": self.pid if pid is None else int(pid),
                      "tid": threading.get_ident(),
                      **({"args": args} if args else {})})

    def complete(self, name: str, t0: float, t1: float,
                 pid: Optional[int] = None, tid: Optional[int] = None,
                 **args) -> None:
        """Record an already-measured interval on `monotime`'s timeline
        (telemetry replay: the controller materializes spans for ranks
        it never ran itself)."""
        if not self.enabled:
            return
        self._append({"name": name, "ph": "X", "ts": self._us(t0),
                      "dur": max(0.0, (t1 - t0) * 1e6),
                      "pid": self.pid if pid is None else int(pid),
                      "tid": threading.get_ident() if tid is None
                      else int(tid),
                      **({"args": args} if args else {})})

    def _complete(self, sp: _Span) -> None:
        t1 = monotime()
        ev = {"name": sp.name, "ph": "X", "ts": self._us(sp.t0),
              "dur": max(0.0, (t1 - sp.t0) * 1e6),
              "pid": sp.pid, "tid": sp.tid}
        if sp.args:
            ev["args"] = sp.args
        self._append(ev)

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self.max_events:
                drop = len(self._events) - self.max_events
                del self._events[:drop]
                self._dropped += drop

    def _us(self, t_mono: float) -> float:
        return t_mono * 1e6

    # -- lanes ---------------------------------------------------------
    def set_thread_name(self, name: str,
                        tid: Optional[int] = None) -> None:
        with self._lock:
            self._thread_names[tid if tid is not None
                               else threading.get_ident()] = name

    def set_process_name(self, pid: int, name: str) -> None:
        with self._lock:
            self._proc_names[int(pid)] = name

    # -- export --------------------------------------------------------
    def tail(self, n: int = 64) -> List[dict]:
        """The most recent ``n`` events (flight-recorder dumps)."""
        with self._lock:
            return [dict(e) for e in self._events[-n:]]

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def to_chrome(self, path: Optional[str] = None) -> dict:
        """The Chrome ``trace_event`` JSON object (and write it to
        ``path`` when given).  Loads directly in Perfetto."""
        with self._lock:
            events = [dict(e) for e in self._events]
            thread_names = dict(self._thread_names)
            proc_names = dict(self._proc_names)
            dropped = self._dropped
        meta: List[dict] = []
        pids = sorted({e["pid"] for e in events} | set(proc_names))
        for pid in pids:
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "ts": 0,
                         "args": {"name": proc_names.get(
                             pid, f"{self.process}/{pid}")}})
        tids = {(e["pid"], e["tid"]) for e in events}
        for pid, tid in sorted(tids):
            name = thread_names.get(tid)
            if name:
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid, "ts": 0, "args": {"name": name}})
        doc = {"traceEvents": meta + [_jsonsafe_event(e) for e in events],
               "displayTimeUnit": "ms",
               "otherData": {"process": self.process,
                             "clock": "perf_counter",
                             "wall_anchor": {
                                 "mono_us": self._anchor_mono * 1e6,
                                 "wall_s": self._anchor_wall},
                             "dropped_events": dropped}}
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
                f.write("\n")
        return doc


def _jsonsafe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonsafe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonsafe(x) for k, x in v.items()}
    try:                              # numpy scalars quack like floats
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def _jsonsafe_event(e: dict) -> dict:
    if "args" in e:
        e = dict(e, args=_jsonsafe(e["args"]))
    return e


# ---------------------------------------------------------------------------
# schema validation (shared by tests, the bench gate, and CI)
# ---------------------------------------------------------------------------

_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def validate_chrome_trace(doc: dict,
                          require_names: Tuple[str, ...] = ()
                          ) -> Tuple[bool, List[str]]:
    """Validate a Chrome ``trace_event`` JSON object: every event carries
    name/ph/ts/pid/tid, "X" events carry a numeric ``dur``, and within
    each (pid, tid) lane complete events strictly NEST (no partial
    overlap — the invariant Perfetto's track builder needs).  Returns
    ``(ok, problems)``; ``require_names`` additionally demands at least
    one event per listed name."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return False, ["traceEvents missing or empty"]
    lanes: Dict[Tuple[int, int], List[Tuple[float, float, str]]] = {}
    seen = set()
    for i, e in enumerate(events):
        for k in _REQUIRED:
            if k not in e:
                problems.append(f"event {i} missing {k!r}: {e}")
                break
        else:
            ph = e["ph"]
            if not isinstance(e["ts"], (int, float)):
                problems.append(f"event {i} non-numeric ts: {e}")
            elif ph == "X":
                if not isinstance(e.get("dur"), (int, float)):
                    problems.append(f"event {i} X without dur: {e}")
                else:
                    lanes.setdefault((e["pid"], e["tid"]), []).append(
                        (float(e["ts"]), float(e["dur"]), e["name"]))
                    seen.add(e["name"])
            elif ph in ("i", "I"):
                seen.add(e["name"])
        if len(problems) > 16:
            problems.append("... (truncated)")
            break
    for lane, spans in lanes.items():
        # sort by start asc, then duration desc so an enclosing span
        # precedes the spans it contains
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, float, str]] = []
        for ts, dur, name in spans:
            while stack and ts >= stack[-1][0] + stack[-1][1] - 1e-6:
                stack.pop()
            if stack:
                top_end = stack[-1][0] + stack[-1][1]
                if ts + dur > top_end + 1e-6:
                    problems.append(
                        f"lane {lane}: span {name!r} [{ts},{ts + dur}] "
                        f"overlaps {stack[-1][2]!r} ending {top_end}")
            stack.append((ts, dur, name))
    for name in require_names:
        if name not in seen:
            problems.append(f"required span {name!r} absent")
    return not problems, problems


# ---------------------------------------------------------------------------
# process-global default tracer
# ---------------------------------------------------------------------------

_global = Tracer(enabled=os.environ.get("REPRO_TRACE", "") not in
                 ("", "0", "false"))


def get_tracer() -> Tracer:
    return _global


def set_tracer(tracer: Tracer) -> Tracer:
    global _global
    _global = tracer
    return tracer
