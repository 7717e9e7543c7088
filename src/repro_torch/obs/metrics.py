"""Metrics registry: counters, gauges, histograms with JSONL export.

One `MetricsRegistry` per process; instruments are get-or-created by
name and safe to update from any thread (the trainer's step loop, the
scheduler's planner thread, the worker's heartbeat thread and the
controller's per-worker readers all write concurrently).  Everything is
stdlib-only and cheap enough to leave on unconditionally — a counter
increment is one lock acquisition.

Export: `snapshot()` is a flat JSON-safe dict; `export_step(step)`
appends one JSONL line per training step when a sink path is configured
(`configure_sink`), producing a per-step time series next to the BENCH
snapshots.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, List, Optional, Union

from repro_torch.obs.trace import monotime


class Counter:
    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge:
    """Last-value instrument; accepts a float or a small vector (e.g.
    per-rank speeds)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v: Union[float, List[float], None] = None
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            if hasattr(v, "__len__"):
                self._v = [float(x) for x in v]
            else:
                self._v = float(v)

    @property
    def value(self):
        with self._lock:
            return self._v


class Histogram:
    """count/sum/min/max plus log2 buckets — enough for p50/p99-ish
    summaries without storing samples."""

    __slots__ = ("name", "count", "sum", "min", "max", "_buckets", "_lock")

    # bucket i holds values in [2^(i-20), 2^(i-19)) seconds — from ~1us
    # up to ~2^12 s; out-of-range clamps to the edge buckets
    _N_BUCKETS = 32
    _OFFSET = 20

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets = [0] * self._N_BUCKETS
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if v > 0:
                i = int(math.log2(v)) + self._OFFSET
            else:
                i = 0
            self._buckets[min(max(i, 0), self._N_BUCKETS - 1)] += 1

    def quantile(self, q: float) -> float:
        """Quantile estimate interpolated within the log2 bucket holding
        the q-th sample (rank-fraction linear between the bucket edges),
        clamped to the observed [min, max] so degenerate distributions
        (all samples equal) answer exactly."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = min(max(q, 0.0), 1.0) * self.count
            acc = 0
            for i, n in enumerate(self._buckets):
                if n == 0:
                    continue
                if acc + n >= target:
                    lo = 2.0 ** (i - self._OFFSET)
                    hi = 2.0 ** (i + 1 - self._OFFSET)
                    est = lo + (hi - lo) * (target - acc) / n
                    return float(min(max(est, self.min), self.max))
                acc += n
            return float(self.max)

    def summary(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max,
                    "mean": self.sum / self.count}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._sink_path: Optional[str] = None
        self._sink_lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                                f"not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- export --------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat JSON-safe view: counters/gauges by name, histograms as
        ``name.count`` / ``name.mean`` / ``name.max`` etc."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {}
        for name, m in sorted(items):
            if isinstance(m, Histogram):
                s = m.summary()
                for k, v in s.items():
                    out[f"{name}.{k}"] = v
                if s.get("count"):
                    out[f"{name}.p50"] = m.quantile(0.5)
                    out[f"{name}.p99"] = m.quantile(0.99)
            else:
                v = m.value
                if v is not None:
                    out[name] = v
        return out

    def configure_sink(self, path: Optional[str]) -> None:
        """Set (or clear) the JSONL series file `export_step` appends to."""
        with self._sink_lock:
            self._sink_path = path

    def export_step(self, step: int) -> None:
        """Append one per-step JSONL record — a no-op without a sink."""
        with self._sink_lock:
            path = self._sink_path
        if path is None:
            return
        rec = {"step": int(step), "t_mono": monotime(),
               "t_wall": time.time(), **self.snapshot()}
        line = json.dumps(rec, sort_keys=True)
        with self._sink_lock:
            with open(path, "a") as f:
                f.write(line + "\n")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_global = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    return _global
