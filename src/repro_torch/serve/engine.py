"""ServeEngine: continuous batching over the HDP planner.

Port of `repro/serve/engine.py`.  One engine owns one model replica and
two regimes:

* **Prefill** — waiting prompts are planned by
  `SchedulerService.plan_pool` into waves (the same planner the trainer
  uses), materialized into flat packed buffers and run through
  `make_prefill_kv_step`, which returns the per-layer KV rows.  The engine
  gathers each request's rows by the wave's piece layout and writes them
  into that request's decode-slab slot — the prefill→decode handoff.
  One prefill callable is kept per composition, so
  ``compiled_compositions`` and the ``serve.compile_hit/miss`` counters
  keep the reference's meaning (PyTorch runs eagerly: nothing compiles).
* **Decode** — a fixed-width slab of ``max_slots`` cache slots; every
  wave decodes all live slots one token at their own depths.  A slot
  frees the moment its request finishes and the next admission round
  refills it without touching the running batch.  ``admission:
  "static"`` admits only into an empty slab (the baseline).

The slab lives on the runtime's device and is updated IN PLACE (prefill
rows, decode writes, scrubs).  Hidden states and logits stay on the
device; only the [n, V] logit rows the host needs (finiteness, argmax,
``collect_logits``) are copied back, as fp32.

Over several HDP ranks (``rt.comm``, one process or `ThreadRanks` thread
each) every rank runs the same engine: the same ``submit`` calls, the
same pool, the same plans, whose fingerprints the ranks check against
each other before the first wave of every admission round.  Rank r runs
rows ``[r·c, (r+1)·c)`` of each wave (c = ``prefill_capacity · c_mult``)
under the wave's composition, through the ring.  Each rank holds its
`train/serve_step.py::slab_shard` of the slab (whole slots, or every
slot's share of the positions; of each layer's own positions, a local
layer's ring buffer of ``min(window, max_context)`` included), so the KV
rows a rank computed mostly
belong to other ranks' shards: one all-gather per layer of the wave's K
and V rows, after which every rank writes the rows it owns.  The first
token of a request comes from the rank that holds its last prompt row,
the decode logits of whole-slot shards from their owners; one all-gather
hands every rank the owner's rows, so every rank takes the same tokens
and the same finiteness decisions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.planner import PlanSpec
from repro_torch.data.loader import WaveMaterializer
from repro_torch.models.transformer import (check_supported, logits_head,
                                            require_attention_only)
from repro_torch.obs import get_metrics, get_recorder, get_tracer
from repro_torch.obs.numerics import fingerprints_by_rank
from repro_torch.parallel.sharding import Runtime
from repro_torch.serve.pool import Request, RequestPool
from repro_torch.train.serve_step import (init_decode_cache, make_decode_step,
                                          layer_shards, make_prefill_kv_step,
                                          slab_shard)


@dataclass(frozen=True)
class ServeConfig:
    max_slots: int = 8            # decode-slab width (live batch ceiling)
    max_context: int = 256        # per-slot cache length (prompt + gen)
    prefill_capacity: int = 256   # per-rank capacity tokens for planning
    admission: str = "continuous"  # or "static" (drain-then-refill)
    collect_logits: bool = False  # keep per-token logits rows (tests)


class _PromptProvider:
    """Duck-typed dataset for the materializer: token reads slice the
    admitted prompts (zero-padded past the end, which only the unused
    labels ever read)."""

    def __init__(self, prompts: List[np.ndarray]):
        self.prompts = prompts

    def tokens(self, step: int, seq_id: int, start: int,
               end: int) -> np.ndarray:
        p = self.prompts[seq_id]
        out = np.zeros(end - start, np.int32)
        n = max(0, min(end, len(p)) - start)
        if n > 0:
            out[:n] = p[start:start + n]
        return out


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, rt: Optional[Runtime] = None,
                 scfg: Optional[ServeConfig] = None, *, device=None,
                 service=None, clock=time.monotonic):
        """``rt`` defaults to ``Runtime(device=device)``: the engine runs on
        ``cuda`` unless asked for ``device="cpu"``, and raises when no GPU
        is present and none was asked for.  An RWKV pattern raises
        `NotImplementedError`, as the reference's engine does: its decode
        state cannot be captured from the packed prefill."""
        check_supported(cfg)
        require_attention_only(cfg, "serving")
        rt = Runtime(device=device) if rt is None else rt
        scfg = ServeConfig() if scfg is None else scfg
        if params["embed"].device != rt.device:
            raise ValueError(f"parameters live on {params['embed'].device}, "
                             f"the runtime on {rt.device}")
        self.params = params
        self.cfg = cfg
        self.rt = rt
        self.scfg = scfg
        self.clock = clock
        self.pool = RequestPool(clock=clock)
        if service is None:
            from repro_torch.sched.service import SchedulerService
            spec = PlanSpec.for_config(
                cfg, capacity=scfg.prefill_capacity, hdp=rt.hdp_size,
                use_offload=False)
            service = SchedulerService(None, spec)
        self.service = service

        b, s = scfg.max_slots, scfg.max_context
        self.shard = slab_shard(rt, b, s)
        self.shards = layer_shards(cfg, rt, b, s)
        self.cache = init_decode_cache(cfg, rt, b, s)
        self._decode = make_decode_step(cfg, rt, b, s)
        self._prefill_fns: Dict[Tuple[int, ...], object] = {}
        self._rank = 0 if rt.comm is None else rt.comm.rank

        # slab bookkeeping (host side)
        self._req: List[Optional[Request]] = [None] * b
        self._pos = np.zeros(b, np.int64)   # next position each slot feeds
        self._tok = np.zeros(b, np.int64)   # next token each slot feeds
        self.records: List[dict] = []       # per-request telemetry
        self.prefill_log: List[dict] = []   # per wave: composition, s
        self.stats = {"prefill_waves": 0, "decode_waves": 0,
                      "compiled_compositions": 0}

    def _dev(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.rt.device)

    # -- submission ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size >= self.scfg.max_context:
            raise ValueError(
                f"prompt ({prompt.size}) must fit the per-slot cache "
                f"(max_context={self.scfg.max_context}) with room to "
                f"generate")
        rid = self.pool.submit(prompt, max_new_tokens,
                               collect_logits=self.scfg.collect_logits)
        get_tracer().instant("submit", rid=rid, plen=int(prompt.size))
        mx = get_metrics()
        mx.counter("serve.submitted").inc()
        mx.gauge("serve.queue_depth").set(self.pool.n_waiting)
        return rid

    # -- engine loop ---------------------------------------------------
    def step(self) -> List[Request]:
        """One engine iteration: admit into free slots, then decode one
        token on every live slot.  Returns the requests finished now."""
        with torch.inference_mode():
            self._admit()
            return self._decode_wave()

    def drain(self, max_steps: int = 1_000_000) -> List[Request]:
        out: List[Request] = []
        for _ in range(max_steps):
            if self.pool.n_open == 0:
                return out
            out.extend(self.step())
        raise RuntimeError(f"pool not drained after {max_steps} steps")

    # -- admission (prefill) -------------------------------------------
    def _admit(self) -> None:
        free = [i for i, r in enumerate(self._req) if r is None]
        if not free:
            return
        if self.scfg.admission == "static" and len(free) != len(self._req):
            return                       # static: drain, then refill
        reqs = self.pool.take_waiting(len(free))
        if not reqs:
            return
        with get_tracer().span("admit", n=len(reqs),
                               rids=[r.rid for r in reqs]):
            plan = self.service.plan_pool([r.plen for r in reqs])
            self._check_plan(plan)
            slot_of = {i: free[i] for i in range(len(reqs))}
            provider = _PromptProvider([r.prompt for r in reqs])
            mat = WaveMaterializer(provider, self.cfg,
                                   self.scfg.prefill_capacity)
            for wave in plan.waves:
                self._prefill_wave(wave, mat, reqs, slot_of)
            for r in reqs:               # max_new_tokens == 1 finishes at
                if len(r.generated) >= r.max_new_tokens:  # prefill already
                    self._retire(r)
        get_metrics().gauge("serve.queue_depth").set(self.pool.n_waiting)

    def _check_plan(self, plan) -> None:
        """Every rank must prefill the same plan: on a fingerprint mismatch
        every rank raises (one rank raising while the others wait inside
        a wave's ring would hang them)."""
        if self.rt.hdp_size == 1:
            return
        got = fingerprints_by_rank(self.rt.comm.all_gather, plan,
                                   self.rt.device)
        if len(set(got)) > 1:
            raise RuntimeError(
                f"the HDP ranks planned different prefills (plan "
                f"fingerprint prefixes by rank {got})")

    def _prefill_fn(self, comp: Tuple[int, ...]):
        fn = self._prefill_fns.get(comp)
        if fn is None:
            with get_tracer().span("compile", composition=comp):
                fn = make_prefill_kv_step(self.cfg,
                                          self.rt.with_composition(comp))
            self._prefill_fns[comp] = fn
            self.stats["compiled_compositions"] += 1
            get_metrics().counter("serve.compile_miss").inc()
        else:
            get_metrics().counter("serve.compile_hit").inc()
        return fn

    def _prefill_wave(self, wave, mat: WaveMaterializer,
                      reqs: List[Request], slot_of: Dict[int, int]) -> None:
        t0 = self.clock()
        tr = get_tracer()
        comp = tuple(wave.composition)
        with tr.span("prefill", composition=comp,
                     rids=[reqs[p.seq_id].rid
                           for s in wave.slots for p in s]):
            with tr.span("materialize"):
                lw = mat.materialize(0, wave)
            fn = self._prefill_fn(comp)
            c = self.scfg.prefill_capacity * wave.c_mult
            r0 = self._rank * c               # this rank's rows of the wave
            batch = {k: self._dev(lw.batch[k][r0:r0 + c])
                     for k in ("tokens", "seg", "pos")}
            hidden, head_kv, block_kv = fn(self.params, batch)

            # flat-buffer row of every (seq, abs position) — the same
            # cursor walk `WaveMaterializer.materialize` packs with
            flat: Dict[int, np.ndarray] = {}
            for r, pieces in enumerate(wave.slots):
                cursor = r * c
                for p in pieces:
                    fl = flat.setdefault(p.seq_id,
                                         np.full(reqs[p.seq_id].plen, -1,
                                                 np.int64))
                    fl[p.start:p.end] = np.arange(cursor,
                                                  cursor + p.length)
                    cursor += p.length

            mx = get_metrics()
            sids = sorted(flat)
            covered = [reqs[sid] for sid in sids]
            total = sum(r.plen for r in covered)
            # first generated tokens come straight out of the prefill: the
            # last prompt row of every request
            rows = self._first_rows(hidden, np.array(
                [flat[sid][reqs[sid].plen - 1] for sid in sids]), c)
            self._scatter_kv([(slot_of[sid], flat[sid]) for sid in sids],
                             head_kv, block_kv)
            for n, sid in enumerate(sids):
                req = reqs[sid]
                slot = slot_of[sid]
                req.slot = slot
                row = rows[n]
                if not np.isfinite(row).all():
                    self._req[slot] = req
                    self._fail_numerics(req, where="prefill")
                    continue
                tok = int(row.argmax())
                req.generated.append(tok)
                req.t_first = self.clock()
                mx.histogram("serve.ttft_s").observe(
                    req.t_first - req.t_submit)
                if req.logits is not None:
                    req.logits.append(row.copy())
                self._req[slot] = req
                self._pos[slot] = req.plen
                self._tok[slot] = tok
            dt = self.clock() - t0
            for req in covered:          # attribute by token share
                req.prefill_s += dt * req.plen / max(total, 1)
        self.prefill_log.append({"composition": comp,
                                 "c_mult": int(wave.c_mult), "s": dt})
        self.stats["prefill_waves"] += 1
        mx.counter("serve.prefill_waves").inc()

    def _first_rows(self, hidden, last: np.ndarray, c: int) -> np.ndarray:
        """fp32 logits of the wave rows ``last`` (global), each computed by
        the rank that holds it (row // c)."""
        owner = last // c
        mine = np.flatnonzero(owner == self._rank)
        out = logits_head(self.params, self.cfg, hidden.index_select(
            0, self._dev(last[mine] - self._rank * c, torch.int64))).float()
        if self.rt.hdp_size > 1:
            # one all-gather, then every rank picks row n of rank owner[n]:
            # no arithmetic, so every rank holds the same rows
            full = out.new_zeros((len(last), out.shape[1]))
            full[self._dev(mine, torch.int64)] = out
            out = self.rt.comm.all_gather(full)[
                self._dev(owner, torch.int64),
                torch.arange(len(last), device=full.device)]
        return out.cpu().numpy()

    def _scatter_kv(self, entries, head_kv, block_kv) -> None:
        """Write the wave's requests' KV rows (``k`` and ``v``, or an MLA
        layer's latent ``kv_lat``) into their slab slots, in place.
        ``entries``: (slot, flat rows of positions 0..plen-1) per
        request.  A layer of ``S_l`` cache positions keeps the last
        ``S_l`` positions of each prompt at ``p % S_l``, as decode writes
        them: all of them in a global layer, the last window in a local
        layer's ring buffer.  Over several ranks the wave's rows of each
        layer come from one all-gather of every rank's rows, and each
        rank writes the (slot, position) pairs its shard of the layer
        holds."""
        index = {}

        def indices(sh):
            """(local slots, local cache positions, wave rows) of the
            pairs this rank's shard ``sh`` holds, once per shard."""
            if sh not in index:
                keep = [(slot, fl[max(0, len(fl) - sh.length):],
                         np.arange(max(0, len(fl) - sh.length), len(fl)))
                        for slot, fl in entries]
                slots = np.concatenate([np.full(len(fl), slot)
                                        for slot, fl, _ in keep])
                pos = np.concatenate([p % sh.length for _, _, p in keep])
                rows = np.concatenate([fl for _, fl, _ in keep])
                own = sh.owns(slots, pos)
                index[sh] = (self._dev(slots[own] - sh.slot0, torch.int64),
                             self._dev(pos[own] - sh.base, torch.int64),
                             self._dev(rows[own], torch.int64))
            return index[sh]

        def wave_rows(kv):
            """{name: this rank's rows} -> {name: the wave's rows}."""
            if self.rt.hdp_size == 1:
                return kv
            cat = self.rt.comm.all_gather(torch.cat(
                list(kv.values()), dim=-1)).flatten(0, 1)
            out, c = {}, 0               # cat: [ranks·c, G, Σ widths]
            for name, x in kv.items():
                out[name] = cat[..., c:c + x.shape[-1]]
                c += x.shape[-1]
            return out

        def write(cache_layer, kv, sh):
            ls, lp, rows = indices(sh)
            for name, src in wave_rows(kv).items():
                buf = cache_layer[name]
                buf[ls, lp] = src[rows].to(buf.dtype)

        for i, kv in enumerate(head_kv):
            write(self.cache["head_layers"][i], kv,
                  self.shards["head_layers"][i])
        for j, kv in enumerate(block_kv):
            n_layers = next(iter(kv.values())).shape[0]
            for i in range(n_layers):    # one layer at a time
                write({n: b[i] for n, b in self.cache["blocks"][j].items()},
                      {n: a[i] for n, a in kv.items()},
                      self.shards["blocks"][j])

    # -- decode --------------------------------------------------------
    def _decode_wave(self) -> List[Request]:
        active = [i for i, r in enumerate(self._req) if r is not None]
        if not active:
            return []
        t0 = self.clock()
        with get_tracer().span("decode", n_live=len(active),
                               rids=[self._req[i].rid for i in active]):
            logits, self.cache = self._decode(
                self.params, self.cache, self._dev(self._tok, torch.int64),
                self._dev(self._pos, torch.int64))
            if self.shard.layout == "batch" and self.rt.hdp_size > 1:
                logits = self.rt.comm.all_gather(logits).flatten(0, 1)
            live = logits.index_select(0, self._dev(np.array(active),
                                                    torch.int64))
            lognp = live.float().cpu().numpy()
        dt = self.clock() - t0
        self.stats["decode_waves"] += 1
        get_metrics().counter("serve.decode_waves").inc()
        finished: List[Request] = []
        for n, i in enumerate(active):
            req = self._req[i]
            row = lognp[n]
            if not np.isfinite(row).all():
                self._fail_numerics(req, where="decode")
                finished.append(req)
                continue
            tok = int(row.argmax())
            req.generated.append(tok)
            req.decode_s += dt / len(active)
            if req.logits is not None:
                req.logits.append(row.copy())
            self._pos[i] += 1
            self._tok[i] = tok
            if (len(req.generated) >= req.max_new_tokens
                    or int(self._pos[i]) >= self.scfg.max_context):
                finished.append(req)
                self._retire(req)
        return finished

    def _fail_numerics(self, req: Request, *, where: str) -> None:
        """Non-finite logits fail the REQUEST, not the engine: the slab
        slot frees, the pool completes the request with ``error`` set,
        and the flight recorder keeps the postmortem trail.  The slot's
        KV rows are scrubbed back to zero so a NaN row cannot poison the
        slot's next tenant through the masked-attention sum."""
        req.error = "nonfinite_logits"
        if req.slot is not None:
            self._scrub_slot(req.slot)
        get_metrics().counter("serve.numerics_failed").inc()
        get_recorder().record("serve_numerics", rid=req.rid, where=where,
                              n_tokens=len(req.generated))
        self._retire(req)

    def _scrub_slot(self, slot: int) -> None:
        """Zero this rank's share of ``slot``."""
        local = slot - self.shard.slot0
        if not 0 <= local < self.shard.slots:
            return                       # another rank's whole slot
        for layer in self.cache["head_layers"]:
            for buf in layer.values():
                buf[local].zero_()
        for layer in self.cache["blocks"]:
            for buf in layer.values():
                buf[:, local].zero_()

    def _retire(self, req: Request) -> None:
        if req.slot is not None:
            self._req[req.slot] = None
        self.pool.finish(req)
        get_tracer().instant("finish", rid=req.rid,
                             n_tokens=len(req.generated))
        mx = get_metrics()
        mx.counter("serve.finished").inc()
        if req.t_done is not None:
            mx.histogram("serve.e2e_s").observe(req.t_done - req.t_submit)
        self.records.append(req.telemetry())

    # -- introspection -------------------------------------------------
    @property
    def n_live(self) -> int:
        return sum(1 for r in self._req if r is not None)
