"""The port's bytes ledger (`repro_torch/obs/ledger.py`).

* The predicted side (a copy) equals the reference's `repro.obs.ledger`
  on the same configs, plans and records (properties, as
  `tests/test_ledger.py` draws them).
* On 4 gloo ranks (`_torch_hdp_train_worker.py --ledger`: the multi-rank
  `Trainer` at ``use_offload=True`` with the ledger on, 3 steps of plans
  that hold a (4,) ring wave and offloading waves), the measured ring and
  offload bytes of every wave equal the prediction under the relations
  the ledger's docstring states, exactly: ring = predicted -
  `ring_meta_bytes`; offload = k whole periods of the wave's residuals
  each way, within half a period of the continuous prediction.  Forward
  traffic only: neither the recompute nor the reverse ring counts.
* With tracing and the ledger off, the trainer builds no `Ledger` and
  opens no tally.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import _torch_hdp_train_worker as W
from repro.configs.registry import get_config as jax_config
from repro.core import offload as JOF
from repro.core.planner import PlanSpec as JPlanSpec
from repro.core.planner import plan as jax_plan
from repro.obs import ledger as jl
from repro_torch.configs.registry import get_config
from repro_torch.core import offload as OF
from repro_torch.core.planner import PlanSpec, plan
from repro_torch.data.distribution import LengthDistribution
from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
from repro_torch.obs import ledger
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import Runtime
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("llama3.2-3b", "llama-7b", "llama3.2-3b-reduced")


def _pair(name):
    return jax_config(name), get_config(name)


# ---------------------------------------------------------------------------
# the predicted side against the reference
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(name=st.sampled_from(NAMES),
       comp=st.lists(st.integers(1, 8), min_size=1, max_size=8),
       cap=st.sampled_from([256, 4096, 8192]), c_mult=st.integers(1, 4),
       r=st.floats(0.0, 1.0), active=st.booleans())
def test_predictions_equal_the_reference(name, comp, cap, c_mult, r, active):
    jcfg, cfg = _pair(name)
    hdp = sum(comp)
    assert ledger.ring_edges(comp) == jl.ring_edges(comp)
    assert ledger.ring_block_bytes(cfg, cap) == jl.ring_block_bytes(jcfg, cap)
    assert ledger.wave_ring_bytes(cfg, comp, cap) == \
        jl.wave_ring_bytes(jcfg, comp, cap)
    assert ledger.offload_dispatch_bytes(cfg, r, hdp * cap) == \
        jl.offload_dispatch_bytes(jcfg, r, hdp * cap)
    assert ledger.predicted_hbm_bytes(
        cfg, OF.analytic_coeffs(cfg), cap, r, hdp) == \
        jl.predicted_hbm_bytes(jcfg, JOF.analytic_coeffs(jcfg), cap, r, hdp)
    mine = ledger.Ledger(cfg, capacity=cap, hdp=hdp, offload_active=active)
    ref = jl.Ledger(jcfg, capacity=cap, hdp=hdp, offload_active=active)
    assert mine.predict_dispatch(comp, c_mult, r) == \
        ref.predict_dispatch(comp, c_mult, r)
    assert mine.predict_hbm(c_mult, r) == ref.predict_hbm(c_mult, r)
    # the metadata the port does not rotate: 16 bytes a rotated block
    steps = max(comp) - 1
    assert ledger.ring_meta_bytes(cfg, comp) == (
        0 if steps == 0 else ledger.attn_layer_count(cfg) * steps
        * ledger.ring_edges(comp) * 16)


@settings(max_examples=12, deadline=None)
@given(lens=st.lists(st.integers(64, 32768), min_size=4, max_size=48),
       hdp=st.sampled_from([1, 4, 8]), offload=st.booleans())
def test_plan_pricing_equals_the_reference(lens, hdp, offload):
    """Both planners on the same lengths, each plan priced by its own
    package's ledger: the same bytes by kind."""
    jcfg, cfg = _pair("llama-7b")
    mine = plan(lens, PlanSpec.for_config(cfg, capacity=8192, hdp=hdp,
                                          use_offload=offload))
    ref = jax_plan(lens, JPlanSpec.for_config(jcfg, capacity=8192, hdp=hdp,
                                              use_offload=offload))
    assert ledger.plan_comm_bytes(mine, cfg) == \
        jl.plan_comm_bytes(ref, jcfg)


@settings(max_examples=20, deadline=None)
@given(recs=st.lists(st.tuples(st.floats(0, 1e9), st.floats(0, 1e9),
                               st.floats(0, 1e9), st.floats(0, 1e9)),
                     min_size=1, max_size=12))
def test_totals_and_summary_equal_the_reference(recs):
    mine, ref = ledger.new_totals(), jl.new_totals()
    for ring_p, ring_m, off, hbm in recs:
        rec = {"pred": {"ring": ring_p, "offload_d2h": off},
               "meas": {"ring": ring_m}, "hbm_pred": hbm, "hbm_meas": off}
        ledger.merge_record(mine, rec)
        jl.merge_record(ref, rec)
    assert mine == ref
    assert ledger.totals_summary(mine) == jl.totals_summary(ref)


# ---------------------------------------------------------------------------
# measured against predicted on 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo_ledger(tmp_path_factory):
    out = tmp_path_factory.mktemp("ledger")
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_hdp_train_worker.py"),
         "--ledger", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=subprocess_env(PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-4000:]
    return [dict(np.load(out / f"ledger_rank{k}.npz")) for k in range(W.R)]


@pytest.mark.parametrize("run", W.OFF_RUNS)
def test_measured_bytes_equal_the_prediction_on_gloo_ranks(gloo_ledger, run):
    cfg = W.config(layers=W.OFF_LAYERS)
    rk = gloo_ledger[0]
    comps = [eval(c) for c in rk[f"{run}/ledger/comp"].tolist()]
    c_mult, r, k = (rk[f"{run}/ledger/{x}"] for x in ("c_mult", "r", "k"))
    pred, meas = rk[f"{run}/ledger/pred"], rk[f"{run}/ledger/meas"]
    assert len(comps) == int(rk[f"{run}/ledger/n"]) == \
        sum(rk[f"{run}/waves"])
    # the plans drive both channels: a ring wave, offloading waves
    assert any(max(c) > 1 for c in comps) and (k >= 1).any()
    assert ((k >= 1) & (k < W.OFF_LAYERS)).any()
    meta = np.array([ledger.ring_meta_bytes(cfg, c) for c in comps])
    np.testing.assert_array_equal(meas[:, 0], pred[:, 0] - meta)
    assert (meas[:, 0] > 0).any()
    resid = W.R * W.CAP * c_mult * cfg.d_model * 4   # a period, fleet
    for col in (1, 2):
        np.testing.assert_array_equal(meas[:, col], k * resid)
        assert np.all(np.abs(pred[:, col] - meas[:, col]) <= resid / 2)
    for other in gloo_ledger[1:]:
        np.testing.assert_array_equal(other[f"{run}/ledger/meas"], meas)
        np.testing.assert_array_equal(other[f"{run}/ledger/pred"], pred)


# ---------------------------------------------------------------------------
# off means off
# ---------------------------------------------------------------------------

def test_no_ledger_is_built_when_the_ledger_is_off(monkeypatch):
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              dtype="float32")
    ds = SyntheticDataset(LengthDistribution(*W.DIST), cfg.vocab_size,
                          tokens_per_step=512, context=512)
    sched = GlobalScheduler(ds, cfg, capacity=256, hdp=1, use_offload=True)
    tr = Trainer(cfg, Runtime(device="cpu", attn_impl="ref"),
                 adamw.AdamWConfig(), sched,
                 TrainerConfig(capacity=256, calibrate=False,
                               use_offload=True))

    def refuse(*a, **k):
        raise AssertionError("the ledger was touched while off")
    try:
        with monkeypatch.context() as m:
            m.setattr(ledger, "_enabled", False)
            m.setattr(ledger, "Ledger", refuse)
            m.setattr(ledger, "capture", refuse)
            tr.train_step()
        assert tr.ledger is None and tr.last_ledger_record is None
        monkeypatch.setattr(ledger, "_enabled", True)
        rec = tr.train_step()
        assert tr.ledger is not None
        assert tr.ledger.summary()["n"] == rec["waves"]
        assert tr.last_ledger_record["step"] == 1
    finally:
        sched.stop()
