"""Request lifecycle and the thread-safe open pool.

A request moves WAITING → RUNNING → DONE.  The pool is the single
synchronization point between whatever feeds traffic in (the router's
reader thread, a benchmark's arrival schedule) and the engine loop that
drains it; every mutation happens under one lock and `wait_done` lets a
caller block on an individual request's completion.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

WAITING = "waiting"
RUNNING = "running"
DONE = "done"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # int32 [plen]
    max_new_tokens: int
    state: str = WAITING
    slot: Optional[int] = None            # decode-slab slot while RUNNING
    generated: List[int] = field(default_factory=list)
    # latency accounting (seconds on the engine's clock)
    t_submit: float = 0.0
    t_admit: Optional[float] = None       # prefill started
    t_first: Optional[float] = None       # first token out of prefill
    t_done: Optional[float] = None
    # engine-attributed compute seconds (per-request telemetry)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # per-step logits rows, kept only when the engine is asked to
    # (parity tests) — [n_generated, vocab] worth of rows
    logits: Optional[List[np.ndarray]] = None
    # set when the engine failed the request instead of dying with it
    # (e.g. "nonfinite_logits" from the numerics guard)
    error: Optional[str] = None

    @property
    def plen(self) -> int:
        return int(len(self.prompt))

    def telemetry(self) -> dict:
        return {"rid": self.rid, "plen": self.plen,
                "n_tokens": len(self.generated),
                "t_submit": self.t_submit, "t_admit": self.t_admit,
                "t_first": self.t_first, "t_done": self.t_done,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "error": self.error}


class RequestPool:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._ids = itertools.count()
        self._all: Dict[int, Request] = {}
        self._waiting: List[int] = []     # FIFO admission order
        self._cv = threading.Condition()

    def submit(self, prompt, max_new_tokens: int, *,
               collect_logits: bool = False) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        with self._cv:
            rid = next(self._ids)
            self._all[rid] = Request(
                rid=rid, prompt=prompt,
                max_new_tokens=int(max_new_tokens),
                t_submit=self._clock(),
                logits=[] if collect_logits else None)
            self._waiting.append(rid)
            self._cv.notify_all()
            return rid

    def take_waiting(self, limit: int) -> List[Request]:
        """Pop up to ``limit`` waiting requests (FIFO) and mark them
        RUNNING — the engine's admission step."""
        with self._cv:
            take, self._waiting = (self._waiting[:limit],
                                   self._waiting[limit:])
            now = self._clock()
            out = []
            for rid in take:
                r = self._all[rid]
                r.state = RUNNING
                r.t_admit = now
                out.append(r)
            return out

    def finish(self, req: Request) -> None:
        with self._cv:
            req.state = DONE
            req.t_done = self._clock()
            req.slot = None
            self._cv.notify_all()

    def get(self, rid: int) -> Request:
        with self._cv:
            return self._all[rid]

    def wait_done(self, rid: int, timeout: Optional[float] = None) -> Request:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._all[rid].state != DONE:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(f"request {rid} not done")
                self._cv.wait(timeout=left)
            return self._all[rid]

    @property
    def n_waiting(self) -> int:
        with self._cv:
            return len(self._waiting)

    @property
    def n_open(self) -> int:
        """Requests not yet DONE (waiting + running)."""
        with self._cv:
            return sum(1 for r in self._all.values() if r.state != DONE)
