"""Per-wave predicted/measured bytes ledger (comm + memory observability).

Port of `repro/obs/ledger.py`.  ByteScale's claims are claims about
*bytes*: the communication optimizer "eliminates redundant communication
for short sequences" and "compresses communication for long sequences by
selective offloading".  For every dispatched wave the ledger holds a
**predicted** byte count derived purely from the plan and the model
config, and a **measured** one tallied at the instrumented hot paths, per
kind:

  kind           predicted from                    measured at (the port)
  -------------  --------------------------------  -------------------------
  ring           composition + KV payload model    core/ring.py::_RingShift
                 (zigzag ring: steps x edges)      kernels/ring_flash.py
                                                   forward rotations
  offload_d2h/   Eq. 3 ratio x residual-stream     parallel/host_offload.py
  offload_h2d    bytes (continuous r)              copies (whole periods)
  pp             wavefront ticks x stage roll      parallel/pipeline.py
                 (`pp_tick_bytes`)                 forward stage sends
  zero1_*        parallel/zero1.zero1_bytes        (analytic on both sides)

The predicted side, the totals and `Ledger` are copies of the
reference's, with the imports rewritten.

The measured side is eager.  The trainer opens `capture()` around each
wave's dispatch, on the thread that runs its forward, and every site adds
the bytes this rank sends each time it runs.  ``grad_step`` closes the
tally (`paused()`) around the backward, so neither the period recompute,
which re-runs the forward's ring hops inside the backward, nor
``ring_flash_bwd``'s re-rotated K/V blocks and dkv hops are counted:
**forward traffic only**, the reference's convention (there XLA
transposes the oracle ring and the Pallas reverse ring is skipped).  The
offload copies are counted by `HostOffload` where they are issued, d2h in
the forward and h2d in the backward.  Each rank tallies its own sends and
the trainer sums the ranks' tallies in the all-gather it already makes at
the end of every step (`Trainer._share_waves`), so the records hold
**fleet totals**, as the reference's do.

Exact relations between the two sides on the port (held by
`tests/test_torch_ledger.py`):

* ring: measured == predicted - `ring_meta_bytes`.  The reference rotates
  each block with its [4] i32 metadata (`ring_block_bytes`' 16 bytes);
  the port rotates (kv, seg, pos) only and decides liveness from one
  all-gather of every rank's metadata per ring call
  (`core/ring.py::ring_liveness`).  That all-gather is not priced: 32
  bytes a rank, a latency and not a bandwidth cost, with no counterpart in
  the reference to hold it against.  The prediction stays the
  reference's, so a plan is priced here exactly as there.
* offload: measured == k x (the wave's global tokens) x d_model x itemsize
  each way, with k = `core.offload.offload_periods(cfg, r)`; the
  prediction prices the continuous r x n_periods, so the two differ by at
  most half a period's residual.

A pipelined round of M waves over S stages (one record per round) is
priced as the reference's wavefront: M + S − 1 ticks, each running every
stage's rings and one roll in which all S stages send their [T, d]
buffer slice with its seg and pos (`pp_tick_bytes`).  The port sends no
padding ticks and no seg/pos (every rank materializes them), so its
measured side is exactly (`port_round_bytes`):

* pp: M x (S − 1) x (the wave's global tokens) x d_model x itemsize —
  each microbatch crosses S − 1 stage boundaries once;
* ring: M x (`wave_ring_bytes` − `ring_meta_bytes`) — each microbatch
  runs every layer's ring once, on the stage that holds the layer;
* offload: M x S x k x (global tokens) x d_model x itemsize each way, with
  the stage-local k = `core.offload.offload_periods(cfg, r, S)`.

Under tensor parallelism the reference's byte model has no tp term in
its offload and stage-roll prices: `offload_dispatch_bytes` is r x
n_periods x tokens_global x d_model x itemsize, `pp_tick_bytes` S x
tokens_global x (d_model x itemsize + 8), both over one copy of the
residual stream, which is replicated over the model axis.  Each model
rank offloads and sends its own copy, so the port's fleet totals are
one model rank's: the trainer keeps model rank 0's tallies
(`Trainer._share_waves`), summed over its HDP group and stages.  Its
measured offload and pp bytes then hold the formulas above (k x
tokens_global x d_model x itemsize each way; M x (S − 1) x
tokens_global x d_model x itemsize), and its ring bytes those of model
rank 0's heads (`wave_ring_bytes` at tp, less `ring_meta_bytes`).

Zero-overhead contract: with tracing and ``REPRO_LEDGER`` both off the
trainer builds no `Ledger`, opens no capture and resets no memory peak,
and each site costs one thread-local read.
"""
from __future__ import annotations

import contextlib
import os
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import offload as OF

#: Collective kinds the tally/ledger track (zero1_* stays analytic).
COMM_KINDS = ("ring", "pp", "offload_d2h", "offload_h2d")


# ---------------------------------------------------------------------------
# enablement
# ---------------------------------------------------------------------------

_enabled = os.environ.get("REPRO_LEDGER", "") not in ("", "0", "false")


def ledger_enabled() -> bool:
    """Standalone enable knob (``REPRO_LEDGER=1`` or
    `set_ledger_enabled`).  The trainer also activates the ledger whenever
    tracing is on, so traced runs are always byte-stamped."""
    return _enabled


def set_ledger_enabled(v: bool) -> bool:
    global _enabled
    _enabled = bool(v)
    return _enabled


# ---------------------------------------------------------------------------
# per-dispatch tally (the "measured" side)
# ---------------------------------------------------------------------------

_TLS = threading.local()


def tally_active() -> bool:
    """Fast guard for instrumented sites: is a capture open on this
    thread?  Sites check it before computing payload sizes."""
    return getattr(_TLS, "tally", None) is not None


@contextlib.contextmanager
def capture():
    """Open a tally on this thread and yield the dict it fills (kind ->
    bytes this rank sent).  Wrap one dispatch."""
    prev = getattr(_TLS, "tally", None)
    tally: Dict[str, float] = {}
    _TLS.tally = tally
    try:
        yield tally
    finally:
        _TLS.tally = prev


@contextlib.contextmanager
def paused():
    """Close the open tally for a region (the backward: its recompute and
    reverse ring are not forward traffic)."""
    prev = getattr(_TLS, "tally", None)
    _TLS.tally = None
    try:
        yield
    finally:
        _TLS.tally = prev


def record_comm(kind: str, nbytes) -> None:
    """Add ``nbytes`` to the open tally; no-op when no capture is open."""
    tally = getattr(_TLS, "tally", None)
    if tally is None:
        return
    tally[kind] = tally.get(kind, 0.0) + float(nbytes)


def tensor_bytes(*tensors) -> int:
    """Payload bytes of the tensors, as sent."""
    return sum(t.numel() * t.element_size() for t in tensors)


def ring_meta_bytes(cfg, composition: Sequence[int]) -> int:
    """Fleet bytes of the [4] i32 block metadata the reference rotates
    with every ring block of one wave's forward and the port does not:
    `wave_ring_bytes` less the port's measured ring bytes, exactly."""
    steps = max(composition) - 1 if composition else 0
    if steps <= 0 or getattr(cfg, "attention_free", False):
        return 0
    return attn_layer_count(cfg) * steps * ring_edges(composition) * 4 * 4


# ---------------------------------------------------------------------------
# predicted-side byte model
# ---------------------------------------------------------------------------

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def act_itemsize(cfg) -> int:
    """Itemsize of the activation dtype (numpy cannot parse bfloat16)."""
    return _ITEMSIZE.get(str(cfg.dtype), 4)


def attn_layer_count(cfg) -> int:
    """Layers that run ring attention (codes 'g'/'l'; SSM layers relay
    O(1) state through other collectives the ledger does not track)."""
    return sum(1 for i in range(cfg.num_layers)
               if cfg.layer_code(i) in ("g", "l"))


def ring_edges(composition: Sequence[int]) -> int:
    """ppermute edges per ring rotation: every group g > 1 contributes g
    send edges (the union-of-rings perm of `core.ring.ring_perm`)."""
    return sum(g for g in composition if g > 1)


def ring_block_bytes(cfg, tokens_per_rank: int, *, tp: int = 1,
                     kv_sharded: Optional[bool] = None) -> int:
    """Per-rank bytes of ONE carried ring block — exactly the tree both
    ring backends rotate: fused KV (or the MLA latent) [C, G_loc, W],
    k_seg [C] i32, k_pos [C] i32, and the [4] i32 block metadata.

    Must mirror the tensors `core.ring._ring_attention_local` /
    `kernels.ring_flash.ring_flash_fwd` actually build — the CPU oracle
    exactness gate (tests/test_ledger.py) pins the two together."""
    c = int(tokens_per_rank)
    if getattr(cfg, "mla", None) is not None:
        g_loc, width = 1, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    else:
        g = cfg.num_kv_heads
        if kv_sharded is None:
            kv_sharded = tp > 1 and g % tp == 0
        g_loc = g // tp if (kv_sharded and tp > 1) else g
        width = 2 * cfg.resolved_head_dim          # fused k+v
    kv_b = c * g_loc * width * act_itemsize(cfg)
    seg_b = c * 4
    pos_b = c * 4
    meta_b = 4 * 4
    return kv_b + seg_b + pos_b + meta_b


def wave_ring_bytes(cfg, composition: Sequence[int], tokens_per_rank: int,
                    *, tp: int = 1,
                    kv_sharded: Optional[bool] = None) -> int:
    """Fleet forward-ring bytes of ONE wave dispatch: every attention
    layer runs ``max(comp) - 1`` rotations, each moving `ring_edges`
    per-rank blocks.  Zero for all-singleton compositions (short
    sequences: the redundant communication HDP eliminates)."""
    steps = max(composition) - 1 if composition else 0
    if steps <= 0 or getattr(cfg, "attention_free", False):
        return 0
    blk = ring_block_bytes(cfg, tokens_per_rank, tp=tp,
                           kv_sharded=kv_sharded)
    return attn_layer_count(cfg) * steps * ring_edges(composition) * blk


def pp_tick_bytes(cfg, num_stages: int, tokens_global: int) -> int:
    """Fleet bytes of one wavefront tick's stage roll in the reference:
    every stage sends its [T, d_model] activation slice plus seg/pos
    metadata (one int32 each, the rope width) to its neighbour."""
    per_stage = tokens_global * (cfg.d_model * act_itemsize(cfg) + 4 + 4)
    return num_stages * per_stage


def port_round_bytes(cfg, composition: Sequence[int], n_waves: int,
                     num_stages: int, tokens_per_rank: int, hdp: int,
                     offload_periods: int = 0, *, tp: int = 1,
                     kv_sharded: Optional[bool] = None) -> Dict[str, float]:
    """The port's measured fleet bytes of one pipelined round (at one
    stage, of ``n_waves`` waves), exactly (module docstring): what it
    sends where the reference's wavefront prediction counts padding
    ticks, seg/pos and the ring's metadata.  At ``tp`` > 1, one model
    rank's (module docstring)."""
    tokens_global = hdp * tokens_per_rank
    resid = tokens_global * cfg.d_model * act_itemsize(cfg)
    ring1 = wave_ring_bytes(cfg, composition, tokens_per_rank, tp=tp,
                            kv_sharded=kv_sharded)
    moved = float(n_waves * num_stages * offload_periods * resid)
    return {"ring": float(n_waves * (ring1
                                     - ring_meta_bytes(cfg, composition))),
            "pp": float(n_waves * (num_stages - 1) * resid),
            "offload_d2h": moved, "offload_h2d": moved}


def offload_dispatch_bytes(cfg, offload_ratio: float, tokens_global: int,
                           num_stages: int = 1) -> Tuple[float, float]:
    """Predicted (d2h, h2d) bytes of one dispatch at the *continuous*
    Eq. 3 ratio: r x stage-local periods x residual-stream bytes per
    period.  Execution quantizes the window to whole periods
    (`core.offload.offload_periods`), so |predicted - measured| is the
    genuine ratio->period quantization error."""
    if offload_ratio <= 0:
        return 0.0, 0.0
    n = OF.scan_periods(cfg)
    if num_stages > 1:
        n //= num_stages
    resid = tokens_global * cfg.d_model * act_itemsize(cfg)
    moved = float(offload_ratio) * n * resid
    if num_stages > 1:
        moved *= num_stages                       # every stage's window
    return moved, moved


def predicted_hbm_bytes(cfg, coeffs: OF.CostCoeffs, tokens_per_rank: int,
                        offload_ratio: float, hdp: int,
                        num_stages: int = 1) -> int:
    """Coarse per-rank peak-HBM watermark: bf16 params + fp32 grad
    accumulators + ZeRO-1-sharded optimizer state (12 B/param over hdp) +
    the activation footprint of `tokens_per_rank` at the wave's Eq. 3
    offload discount (only the first/last layers stay fully resident at
    r = 1 — the D(s) numerator of core/offload.py)."""
    p = cfg.param_count()
    ell = max(cfg.num_layers, 3)
    params_b = p * act_itemsize(cfg)
    grads_b = 4 * p
    opt_b = 12.0 * p / max(hdp, 1)
    discount = 1.0 - offload_ratio * (ell - 2) / ell
    act_b = OF.act_bytes(coeffs, tokens_per_rank) * ell * discount
    if num_stages > 1:
        act_b /= num_stages
    return int(params_b + grads_b + opt_b + act_b)


# ---------------------------------------------------------------------------
# plan-level pricing (benchmarks: no mesh, no tensors)
# ---------------------------------------------------------------------------

def plan_comm_bytes(plan, cfg, *, tp: int = 1) -> Dict[str, float]:
    """Price a `StepPlan`'s total forward ring traffic from the plan
    alone (benchmarks/comm_bench.py: HDP vs static-CP on one batch).
    Offload transfer bytes are priced at each wave's planned ratio."""
    ring = 0.0
    d2h = 0.0
    hdp = len(plan.waves[0].costs) if plan.waves else 1
    for w in plan.waves:
        tokens_per_rank = w.c_mult * plan.capacity
        ring += wave_ring_bytes(cfg, w.composition, tokens_per_rank, tp=tp)
        d2h += offload_dispatch_bytes(cfg, w.offload_ratio,
                                      hdp * tokens_per_rank)[0]
    return {"ring": ring, "offload_d2h": d2h, "offload_h2d": d2h,
            "total": ring + 2 * d2h}


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

def _rel_residual(pred: float, meas: float) -> float:
    return abs(pred - meas) / max(abs(pred), abs(meas), 1.0)


def new_totals() -> Dict:
    """Empty aggregate (also the controller's fleet-ledger shape)."""
    return {"n": 0,
            "pred": {k: 0.0 for k in COMM_KINDS},
            "meas": {k: 0.0 for k in COMM_KINDS},
            "hbm_pred_peak": 0.0, "hbm_meas_peak": 0.0}


def merge_record(totals: Dict, rec: Dict) -> Dict:
    """Fold one ledger record (local or off the telemetry wire) into an
    aggregate from `new_totals` — the controller's fleet accumulator."""
    totals["n"] += 1
    for k in COMM_KINDS:
        totals["pred"][k] += float(rec.get("pred", {}).get(k, 0.0))
        totals["meas"][k] += float(rec.get("meas", {}).get(k, 0.0))
    if rec.get("hbm_pred"):
        totals["hbm_pred_peak"] = max(totals["hbm_pred_peak"],
                                      float(rec["hbm_pred"]))
    if rec.get("hbm_meas"):
        totals["hbm_meas_peak"] = max(totals["hbm_meas_peak"],
                                      float(rec["hbm_meas"]))
    return totals


def totals_summary(totals: Dict) -> Dict:
    """Residual view of an aggregate: per-kind relative residual plus the
    combined comm residual (the CI gate quantity)."""
    pred, meas = totals["pred"], totals["meas"]
    residual = {k: _rel_residual(pred[k], meas[k])
                for k in COMM_KINDS if pred[k] or meas[k]}
    p_tot = sum(pred.values())
    m_tot = sum(meas.values())
    return {"n": totals["n"],
            "pred_total": p_tot, "meas_total": m_tot,
            "residual": residual,
            "comm_residual": _rel_residual(p_tot, m_tot)
            if (p_tot or m_tot) else 0.0,
            "hbm_pred_peak": totals["hbm_pred_peak"],
            "hbm_meas_peak": totals["hbm_meas_peak"]}


class Ledger:
    """Per-process predicted/measured ledger the trainer feeds once per
    dispatch.  Bounded memory: raw records keep the most recent
    ``max_records``; the running totals cover everything."""

    def __init__(self, cfg, *, capacity: int, hdp: int,
                 num_stages: int = 1, tp: int = 1,
                 coeffs: Optional[OF.CostCoeffs] = None,
                 offload_active: bool = False,
                 kv_sharded: Optional[bool] = None,
                 max_records: int = 4096):
        self.cfg = cfg
        self.capacity = int(capacity)
        self.hdp = int(hdp)
        self.num_stages = int(num_stages)
        self.tp = int(tp)
        self.coeffs = coeffs if coeffs is not None else \
            OF.analytic_coeffs(cfg)
        self.offload_active = bool(offload_active)
        self.kv_sharded = kv_sharded
        self.records: deque = deque(maxlen=int(max_records))
        self.totals = new_totals()
        self.step_bytes: Dict[str, float] = {}   # zero1 analytic (per step)

    # -- predicted side ------------------------------------------------
    def predict_dispatch(self, composition: Sequence[int], c_mult: int,
                         offload_ratio: float, n_waves: int = 1) -> Dict:
        """Predicted fleet bytes of one dispatch: a single wave, or a
        pipelined round of ``n_waves`` microbatches (every tick of the
        M + S - 1 wavefront runs all stages' rings and one stage roll)."""
        tokens_per_rank = int(c_mult) * self.capacity
        tokens_global = self.hdp * tokens_per_rank
        s = self.num_stages
        ring1 = wave_ring_bytes(self.cfg, composition, tokens_per_rank,
                                tp=self.tp, kv_sharded=self.kv_sharded)
        pred = {k: 0.0 for k in COMM_KINDS}
        if s > 1:
            ticks = n_waves + s - 1
            pred["ring"] = float(ticks * ring1)
            pred["pp"] = float(ticks * pp_tick_bytes(self.cfg, s,
                                                     tokens_global))
            mult = ticks
        else:
            pred["ring"] = float(n_waves * ring1)
            mult = n_waves
        if self.offload_active and offload_ratio > 0:
            d2h, h2d = offload_dispatch_bytes(self.cfg, offload_ratio,
                                              tokens_global, s)
            pred["offload_d2h"] = d2h * mult
            pred["offload_h2d"] = h2d * mult
        return pred

    def predict_hbm(self, c_mult: int, offload_ratio: float) -> int:
        r = offload_ratio if self.offload_active else 0.0
        return predicted_hbm_bytes(self.cfg, self.coeffs,
                                   int(c_mult) * self.capacity, r,
                                   self.hdp, self.num_stages)

    # -- recording -----------------------------------------------------
    def record_dispatch(self, *, step: int, idx: int, kind: str,
                        composition: Sequence[int], c_mult: int,
                        offload_ratio: float, n_waves: int = 1,
                        fresh: bool = False,
                        measured: Optional[Dict] = None,
                        hbm_peak: Optional[float] = None) -> Dict:
        """Build, aggregate, and return one dispatch record.  ``measured``
        is the trace-time tally (cached per executable); ``hbm_peak`` the
        sampled device watermark (None on backends without memory_stats)."""
        pred = self.predict_dispatch(composition, c_mult, offload_ratio,
                                     n_waves)
        meas = {k: float(measured.get(k, 0.0)) for k in COMM_KINDS} \
            if measured is not None else None
        rec = {"step": int(step), "idx": int(idx), "kind": str(kind),
               "comp": list(int(g) for g in composition),
               "c_mult": int(c_mult), "n_waves": int(n_waves),
               "fresh": bool(fresh), "pred": pred,
               "hbm_pred": self.predict_hbm(c_mult, offload_ratio)}
        if meas is not None:
            rec["meas"] = meas
        if hbm_peak is not None:
            rec["hbm_meas"] = float(hbm_peak)
        self.records.append(rec)
        merge_record(self.totals, rec)
        return rec

    def set_step_bytes(self, bytes_by_kind: Dict[str, float]) -> None:
        """Attach per-optimizer-step analytic collectives (ZeRO-1 grad
        reduce + param all-gather — `parallel.zero1.zero1_bytes`)."""
        self.step_bytes = dict(bytes_by_kind)

    # -- consumer view -------------------------------------------------
    def comm_residual(self) -> float:
        return totals_summary(self.totals)["comm_residual"]

    def summary(self) -> Dict:
        out = totals_summary(self.totals)
        if self.step_bytes:
            out["step_bytes"] = dict(self.step_bytes)
        return out

    def recent(self, n: int = 64) -> List[Dict]:
        return list(self.records)[-n:]
