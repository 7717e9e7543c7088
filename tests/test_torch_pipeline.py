"""The port's pipeline parallelism against the reference's pipelined
`Trainer`.

* (a) The plan-side copies (`pipeline_rounds`, `round_key`,
  `pipeline_schedule_stats`) equal the reference's on planner plans in
  ``mode="pp"`` at S = 1, 2 and 4, with and without a ``max_round_waves``
  cap; `stage_window` gives the reference's `stage_stacked` rows; a
  stage's seeded init is those rows of the full init; the ledger's
  pipeline terms are the reference's.
* (b) Reduced llama3.2-3b in float32, PP-Balance plans (``mode="pp"``,
  ``num_stages=2``) at hdp = 2, 3 steps: the reference's `Trainer` on a
  4-host-device ``make_pipeline_mesh(2, 2, 1)`` (``attn_impl="ref"``,
  ``remat="none"``) and the port's on 4 gloo ranks, 2 stages × hdp 2
  (`_torch_pipeline_worker.py`), from the reference's initial weights.
  Plan fingerprints equal on every rank and on the reference; round
  losses, step losses and grad norms within 1e-4 relative; each step's
  update within 1e-3 relative L2 per leaf (the tolerances of
  `test_torch_hdp_train.py`, tighter than the reference's own PP test,
  `tests/test_pipeline.py`: 5e-2 and 2e-2); at ``attn_impl`` "ref" and
  "flash" (the kernels' plain versions here).  The same run within 1e-6
  of the port's own 1-stage hdp = 2 run on the same plans.
* (c) The tied embedding's reduced gradient equals the 1-stage run's; the
  replicated leaves are bit-identical across the stages after every
  apply.
* (d) ZeRO-1 at S = 2: `zero1_dim` with the stage's dim taken against the
  reference's `zero1_spec` under its stage spec (`params_pspecs`), leaf
  by leaf; the sharded apply at 2 × 2 against the unsharded apply.
* (e) An offloading round at 2 stages (4 layers): the stage-local k, bit
  for bit the same step as remat "full" on the same plans, and its ledger
  bytes: the reference's prediction, and the port's measured bytes
  exactly `obs/ledger.py::port_round_bytes`.
* (f) A ``nan_fault`` round skips the apply bit-exactly on all 4 ranks;
  rounds capped at 2 waves, planned and materialized ahead by the
  planner thread, give the synchronous history.
* (g) A checkpoint saved at 2 × 2 resumes at 1 stage × hdp 2 and at
  2 stages × hdp 1, each rank's restored state an exact slice of the
  file and the next step within 1e-4 of the uninterrupted run; the
  reference restores the file and steps on to the same loss; the 1 × 2
  run's own checkpoint resumes at 2 × 2.
* (h) The launcher's ``--mesh 1x1 --num-stages 2`` trains on 2 gloo
  ranks.
* (i) Reduced Mistral-8x7B (MoE) at 2 × 2 against its 1-stage run.

The reference, the gloo ranks and the launcher run as three subprocesses
started together by one module fixture.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_pipeline_worker as W
from repro.configs.registry import get_config as jax_config
from repro.core.planner import PlanSpec as JSpec, plan as jax_plan
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.obs import ledger as jledger
from repro.parallel import pipeline as JP
from repro.parallel import sharding as JS
from repro.parallel import zero1 as jzero1
from repro_torch.configs.registry import get_config
from repro_torch.core.offload import offload_periods
from repro_torch.core.planner import PlanSpec, plan as port_plan
from repro_torch.models.transformer import init_params, stage_periods
from repro_torch.obs import ledger
from repro_torch.parallel import pipeline as PP
from repro_torch.parallel import zero1
from repro_torch.tree import leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4                  # tests/test_torch_train.py
UPDATE_TOL = 1e-3               # post-step update, relative L2 per leaf
SELF_TOL = 1e-6                 # 2 stages against the port's 1 stage
APPLY_TOL = 1e-6                # sharded vs unsharded apply (fp32)

JAX_SCRIPT = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
from repro import compat
from repro.ckpt.checkpoint import CheckpointManager, _flatten
from repro.configs.registry import get_config
from repro.data.distribution import LengthDistribution
from repro.data.loader import GlobalScheduler, SyntheticDataset
from repro.launch.mesh import hdp_axes_of, make_pipeline_mesh
from repro.obs.numerics import plan_fingerprint
from repro.optim.adamw import AdamWConfig
from repro.parallel.sharding import Runtime
from repro.train.trainer import Trainer, TrainerConfig
sys.path.insert(0, "tests")
import _torch_pipeline_worker as W

out = sys.argv[1]
mesh = make_pipeline_mesh(W.S, W.H, 1)
compat.set_mesh(mesh)
cfg = dataclasses.replace(get_config(W.ARCH).reduced(), dtype="float32")
rt = Runtime(mesh=mesh, hdp_axes=hdp_axes_of(mesh), model_axis="model",
             stage_axis="stage", remat="none", kv_chunk=64)
ds = SyntheticDataset(LengthDistribution(*W.DIST), cfg.vocab_size,
                      tokens_per_step=W.TOKENS, context=W.CONTEXT)
sched = GlobalScheduler(ds, cfg, capacity=W.CAP, hdp=W.H, mode="pp",
                        num_stages=W.S, use_offload=False)
plans = []
plan_step = sched.plan_step
def recorded(step):
    plan = plan_step(step)
    plans.append(plan_fingerprint(plan))
    return plan
sched.plan_step = recorded
tr = Trainer(cfg, rt, AdamWConfig(lr=W.LR, total_steps=W.TOTAL_STEPS), sched,
             TrainerConfig(capacity=W.CAP, attn_impl="ref", calibrate=False,
                           mode="pp"))
np.savez(out + "/jax_params.tmp.npz", **_flatten(tr.params))
os.replace(out + "/jax_params.tmp.npz", out + "/jax_params.npz")
res = {}
rounds = []
observe_wave = tr.numerics.observe_wave
def observe(step, i, loss):
    rounds.append((step, float(loss)))
    return observe_wave(step, i, loss)
tr.numerics.observe_wave = observe
for s in range(W.STEPS):
    rec = tr.train_step()
    for k in ("loss", "grad_norm", "waves", "rounds",
              "bubble_frac_pipeline"):
        res.setdefault(k, []).append(rec[k])
    res[f"round_losses/{s}"] = [l for st, l in rounds if st == s]
    for key, v in _flatten(tr.params).items():
        res[f"p{s + 1}/{key}"] = v
res["fp"] = np.array(plans)

# the port's 2 x 2 checkpoint of step 2, restored here and stepped on
t0 = time.monotonic()
while not os.path.exists(out + "/ckpt22/step_2/manifest.json"):
    if time.monotonic() - t0 > 300:
        raise TimeoutError("ckpt22/step_2 did not appear")
    time.sleep(0.2)
tr.ckpt = CheckpointManager(out + "/ckpt22")
assert tr.resume_if_possible()
res["ckpt/resumed_at"] = tr.step
rec = tr.train_step()
res["ckpt/loss"] = rec["loss"]
res["ckpt/grad_norm"] = rec["grad_norm"]
sched.stop()
np.savez(out + "/jax_train.npz", **{k: np.asarray(v) for k, v in res.items()})
"""

LAUNCH_ARGS = ["--arch", "llama3.2-3b", "--reduced", "--steps", "2",
               "--capacity", "256", "--tokens-per-step", "1024",
               "--context", "512", "--dataset", "tiny", "--device", "cpu",
               "--attn-impl", "ref", "--mesh", "1x1", "--num-stages", "2"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Start the reference (4 host devices), the port (4 gloo ranks) and
    the launcher (2 gloo ranks) together; -> (reference results, per-rank
    port results, the launcher's stdout, the output directory)."""
    out = tmp_path_factory.mktemp("pipeline")
    env = subprocess_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs, logs = {}, {}
    for part, cmd in (
            ("jax", [sys.executable, "-c", JAX_SCRIPT, str(out)]),
            ("torch", [sys.executable,
                       str(ROOT / "tests" / "_torch_pipeline_worker.py"),
                       str(out)]),
            ("launch", [sys.executable, "-m", "repro_torch.launch.train",
                        *LAUNCH_ARGS])):
        logs[part] = out / f"{part}.log"
        with open(logs[part], "w") as log, \
                open(out / f"{part}.err", "w") as err:
            procs[part] = subprocess.Popen(
                cmd, cwd=out if part == "launch" else ROOT, env=env,
                stdout=log, stderr=err)
    try:
        for p in procs.values():
            p.wait(timeout=600)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for part, p in procs.items():
        assert p.returncode == 0, (part, logs[part].read_text()[-2000:],
                                   (out / f"{part}.err").read_text()[-4000:])
    ref = dict(np.load(out / "jax_train.npz"))
    ranks = [dict(np.load(out / f"torch_rank{r}.npz")) for r in range(W.R)]
    return ref, ranks, logs["launch"].read_text(), out


def _keys(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


def _global(ranks, prefix):
    """{key: global leaf} from the per-stage windows under ``prefix``
    (HDP position 0 of each stage: world ranks 0 and 2)."""
    first, second = ranks[0], ranks[W.H]
    out = {}
    for key in _keys(first, prefix):
        a = first[prefix + key]
        out[key] = np.concatenate([a, second[prefix + key]]) \
            if key.startswith("blocks/") else a
    return out


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------------------
# (a) the plan-side copies, the stage window, the ledger's terms
# ---------------------------------------------------------------------------

LENGTHS = [16384] * 6 + [512] * 300 + [3000, 7000, 1200] * 20


@pytest.mark.parametrize("mode", ["pp", "dp"])
@pytest.mark.parametrize("cap", [0, 3])
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_rounds_and_schedule_stats_match_the_reference(stages, cap, mode):
    """The same planner plans on both sides (PP-Balance's uniform stream,
    and DP-Balance's heterogeneous one, which fragments into rounds); the
    port's round split, round keys and analytic schedule equal the
    reference's."""
    kw = dict(capacity=8192, hdp=8, use_offload=True, mode=mode,
              num_stages=stages)
    mine = port_plan(LENGTHS, PlanSpec.for_config(get_config("llama-7b"),
                                                  **kw))
    ref = jax_plan(LENGTHS, JSpec.for_config(jax_config("llama-7b"), **kw))
    assert [PP.round_key(w) for w in mine.waves] == \
        [JP.round_key(w) for w in ref.waves]
    got, want = PP.pipeline_rounds(mine, cap), JP.pipeline_rounds(ref, cap)
    assert len(got) > 1 or (mode, cap) == ("pp", 0)
    assert [(r.wave_ids, r.composition, r.c_mult, r.offload_ratio)
            for r in got] == [(r.wave_ids, r.composition, r.c_mult,
                               r.offload_ratio) for r in want]
    assert [(r.wave_ids) for r in PP.rounds_splitter(cap)(mine)] == \
        [r.wave_ids for r in want]
    assert PP.pipeline_schedule_stats(mine, stages, cap) == \
        JP.pipeline_schedule_stats(ref, stages, cap)
    assert PP.num_scan_periods(get_config("llama-7b")) == \
        JP.num_scan_periods(jax_config("llama-7b"))


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_stage_window_gives_stage_stacked_rows(stages):
    rng = np.random.RandomState(0)
    blocks = [{"w": rng.randn(8, 3, 2).astype(np.float32),
               "n": {"scale": rng.randn(8, 3).astype(np.float32)}}]
    ref = JP.stage_stacked([jax.tree.map(jax.numpy.asarray, b)
                            for b in blocks], stages)
    mine = tree_map(torch.from_numpy, blocks)
    for s in range(stages):
        got = PP.stage_window(mine, s, stages)
        np.testing.assert_array_equal(got[0]["w"].numpy(),
                                      np.asarray(ref[0]["w"][s]))
        np.testing.assert_array_equal(got[0]["n"]["scale"].numpy(),
                                      np.asarray(ref[0]["n"]["scale"][s]))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mistral-8x7b"])
def test_a_stages_seeded_init_is_those_rows_of_the_full_init(arch):
    cfg = W.config(arch, layers=4)
    full = init_params(cfg, seed=3, device="cpu")
    for s in range(2):
        mine = init_params(cfg, seed=3, device="cpu", stage=(s, 2))
        w = stage_periods(PP.num_scan_periods(cfg), (s, 2))
        assert len(w) == 2
        for k in ("embed", "final_norm", "head_blocks"):
            for a, b in zip(leaves(mine[k]), leaves(full[k])):
                assert torch.equal(a, b)
        for a, b in zip(leaves(mine["blocks"]), leaves(full["blocks"])):
            assert torch.equal(a, b[w.start:w.stop])
    with pytest.raises(ValueError, match="do not split"):
        init_params(cfg, seed=3, device="cpu", stage=(0, 3))


@pytest.mark.parametrize("stages", [2, 4])
def test_ledger_pipeline_terms_are_the_references(stages):
    """`pp_tick_bytes`, the stage-aware offload and peak terms and the
    wavefront branch of `Ledger.predict_dispatch` against the
    reference's."""
    cfg, jcfg = get_config("llama3.2-3b"), jax_config("llama3.2-3b")
    mine = ledger.Ledger(cfg, capacity=4096, hdp=2, num_stages=stages,
                         offload_active=True)
    ref = jledger.Ledger(jcfg, capacity=4096, hdp=2, num_stages=stages,
                         offload_active=True)
    for comp, c_mult, r, n in (((2,), 1, 0.0, 3), ((1, 1), 2, 0.5, 1),
                               ((2,), 4, 1.0, 5)):
        assert mine.predict_dispatch(comp, c_mult, r, n) == \
            ref.predict_dispatch(comp, c_mult, r, n)
        assert mine.predict_hbm(c_mult, r) == ref.predict_hbm(c_mult, r)
    assert ledger.pp_tick_bytes(cfg, stages, 8192) == \
        jledger.pp_tick_bytes(jcfg, stages, 8192)
    assert ledger.offload_dispatch_bytes(cfg, 0.5, 8192, stages) == \
        jledger.offload_dispatch_bytes(jcfg, 0.5, 8192, stages)


# ---------------------------------------------------------------------------
# (b) three steps against the reference's pipelined Trainer
# ---------------------------------------------------------------------------

def test_plan_fingerprints_agree_on_every_rank_and_the_reference(results):
    ref, ranks, _, _ = results
    want = ref["fp"].tolist()
    assert len(want) == W.STEPS and len(set(want)) == W.STEPS
    for run in (*W.IMPLS, *(f"1stage-{impl}" for impl in W.IMPLS)):
        for rk in ranks:
            assert rk[f"{run}/fp"].tolist() == want, run


@pytest.mark.parametrize("impl", W.IMPLS)
def test_losses_and_grad_norms_match_the_reference(results, impl):
    """Round losses (the reference's numerics see one loss a round),
    step losses and grad norms within 1e-4 relative on every rank; the
    rounds are the reference's."""
    ref, ranks, _, _ = results
    assert ref["rounds"].tolist()[0] > 1            # step 0: two rounds
    for rk in ranks:
        assert rk[f"{impl}/waves"].tolist() == ref["waves"].tolist()
        assert rk[f"{impl}/applied"].tolist() == [1] * W.STEPS
        for s in range(W.STEPS):
            assert len(rk[f"{impl}/rounds/{s}"]) == ref["rounds"][s]
            np.testing.assert_allclose(rk[f"{impl}/round_losses/{s}"],
                                       ref[f"round_losses/{s}"],
                                       rtol=F32_TOL)
        np.testing.assert_allclose(rk[f"{impl}/loss"], ref["loss"],
                                   rtol=F32_TOL)
        np.testing.assert_allclose(rk[f"{impl}/grad_norm"],
                                   ref["grad_norm"], rtol=F32_TOL)
        np.testing.assert_allclose(rk[f"{impl}/bubble"],
                                   ref["bubble_frac_pipeline"], rtol=1e-12)


@pytest.mark.parametrize("impl", W.IMPLS)
def test_parameter_updates_match_the_reference(results, impl):
    """Every step's update (params after - params before) per leaf within
    1e-3 relative L2 of the reference's, from the stages' windows put
    together."""
    ref, ranks, _, _ = results
    p0 = _global(ranks, f"{impl}/p0/")
    assert len(p0) > 5 and sorted(p0) == _keys(ref, "p1/")
    before_mine = p0
    for s in range(W.STEPS):
        mine = _global(ranks, f"{impl}/p{s + 1}/")
        for key in p0:
            before = p0[key] if s == 0 else ref[f"p{s}/{key}"]
            want = ref[f"p{s + 1}/{key}"] - before
            got = mine[key] - before_mine[key]
            assert _rel(got, want) <= UPDATE_TOL, (s, key, _rel(got, want))
        before_mine = mine


@pytest.mark.parametrize("impl", W.IMPLS)
def test_pipelined_run_matches_the_one_stage_run(results, impl):
    """Against the port's own 1-stage hdp = 2 run on the same plans: wave
    losses, losses and grad norms within 1e-6 relative, and every leaf
    of every step within 1e-6 relative L2."""
    _, ranks, _, _ = results
    one, pre = ranks[0], f"1stage-{impl}"
    for rk in ranks:
        for s in range(W.STEPS):
            np.testing.assert_allclose(rk[f"{impl}/wave_losses/{s}"],
                                       one[f"{pre}/wave_losses/{s}"],
                                       rtol=SELF_TOL)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(rk[f"{impl}/{k}"], one[f"{pre}/{k}"],
                                       rtol=SELF_TOL)
    worst = {}
    for s in range(W.STEPS + 1):
        mine = _global(ranks, f"{impl}/p{s}/")
        for key, v in mine.items():
            worst[(s, key)] = _rel(v, one[f"{pre}/p{s}/{key}"])
    top = max(worst, key=worst.get)
    assert worst[top] <= SELF_TOL, (top, worst[top])


@pytest.mark.parametrize("impl", W.IMPLS)
def test_ranks_of_a_stage_hold_the_same_parameters(results, impl):
    _, ranks, _, _ = results
    for s in range(W.STEPS + 1):
        for st in range(W.S):
            a, b = ranks[st * W.H], ranks[st * W.H + 1]
            for key in _keys(a, f"{impl}/p{s}/"):
                np.testing.assert_array_equal(
                    b[f"{impl}/p{s}/{key}"], a[f"{impl}/p{s}/{key}"],
                    err_msg=f"stage {st} step {s} {key}")


# ---------------------------------------------------------------------------
# (c) the replicated leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", W.IMPLS)
def test_tied_embedding_gets_both_stages_gradients(results, impl):
    """The reduced gradient of the tied embedding (its lookup's on stage
    0, its logits' on the last stage, summed over the stage group) is the
    1-stage run's, and neither stage's part alone."""
    _, ranks, _, _ = results
    assert get_config(W.ARCH).tie_embeddings
    for s in range(W.STEPS):
        want = ranks[0][f"1stage-{impl}/embed_grad/{s}"]
        for rk in ranks:
            got = rk[f"{impl}/embed_grad/{s}"]
            assert _rel(got, want) <= SELF_TOL, (s, _rel(got, want))
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("impl", W.IMPLS)
def test_replicated_leaves_bit_identical_across_stages(results, impl):
    _, ranks, _, _ = results
    for s in range(W.STEPS + 1):
        for h in range(W.H):
            a, b = ranks[h], ranks[W.H + h]
            keys = [k for k in _keys(a, f"{impl}/p{s}/")
                    if not k.startswith("blocks/")]
            assert "embed" in keys and "final_norm/scale" in keys
            for key in keys:
                np.testing.assert_array_equal(
                    b[f"{impl}/p{s}/{key}"], a[f"{impl}/p{s}/{key}"],
                    err_msg=f"position {h} step {s} {key}")


# ---------------------------------------------------------------------------
# (d) ZeRO-1 under a stage axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hdp", [2, 4, 8])
@pytest.mark.parametrize("name", ["llama3.2-3b-reduced", "llama3.2-3b",
                                  "llama-7b", "mistral-8x7b-reduced"])
def test_zero1_dim_matches_zero1_spec_under_a_stage_spec(name, hdp, rt1):
    """The reference's `params_pspecs` puts its stage axis on the stacked
    leaves' dim 0, and `zero1_spec` shards the first free divisible
    dimension after it; the port's `zero1_dim` with `stage_taken` shards
    the same dimension of the stage's window."""
    cfg = jax_config(name)
    abstract = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg, rt1))
    rt = types.SimpleNamespace(
        hdp_size=hdp, hdp_axes=("data",), model_axis=None,
        stage_axis="stage", num_stages=2,
        layout=lambda c: JL.gqa_layout(c.num_heads, c.num_kv_heads, 1))
    specs = jax.tree.leaves(JS.params_pspecs(abstract, cfg, rt),
                            is_leaf=lambda x: isinstance(x, P))
    flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
    port = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}
    assert len(specs) == len(flat) > 5
    n_stage = 0
    for (path, leaf), spec in zip(flat, specs):
        stacked = str(getattr(path[0], "key", "")) == "blocks"
        assert (spec[0] == "stage") == stacked if len(spec) else not stacked
        n_stage += stacked
        got = jzero1.zero1_spec(spec, leaf.shape, rt)
        want = next((i for i, e in enumerate(got)
                     if e is not None and e != "stage"), None)
        shape = (leaf.shape[0] // 2, *leaf.shape[1:]) if stacked \
            else leaf.shape
        assert zero1.zero1_dim(shape, hdp, (0,) if stacked else ()) == \
            want, (path, leaf.shape)
    assert n_stage > 3 and len(port) == len(flat)


def test_sharded_apply_at_two_stages_equals_the_unsharded_apply(results):
    """The ZeRO-1 apply at 2 × 2 (stage sums, then reduce-scatter within
    each stage, the stage's dim 0 left to the stage) against the
    unsharded apply on the same gradients: every rank's parameters and
    master shard within 1e-6, the sentinels (grad, param and update
    norms, the non-finite count) too."""
    _, ranks, _, _ = results
    full = ranks[0]
    keys = _keys(full, "apply/full/params/")
    for r, rk in enumerate(ranks):
        stage, h = divmod(r, W.H)
        np.testing.assert_allclose(rk["apply/sharded/om"],
                                   full["apply/full/om"], rtol=APPLY_TOL)
        assert rk["apply/om_keys"].tolist() == full["apply/om_keys"].tolist()
        for key in keys:
            want = full[f"apply/full/params/{key}"]
            master = full[f"apply/full/master/{key}"]
            if key.startswith("blocks/"):
                w = stage_periods(want.shape[0], (stage, W.S))
                want, master = want[w.start:w.stop], master[w.start:w.stop]
            np.testing.assert_allclose(rk[f"apply/sharded/params/{key}"],
                                       want, rtol=APPLY_TOL, atol=APPLY_TOL)
            dim = zero1.zero1_dim(want.shape, W.H,
                                  (0,) if key.startswith("blocks/") else ())
            if dim is not None:
                n = want.shape[dim] // W.H
                master = np.take(master, range(h * n, (h + 1) * n),
                                 axis=dim)
            np.testing.assert_allclose(rk[f"apply/sharded/master/{key}"],
                                       master, rtol=APPLY_TOL,
                                       atol=APPLY_TOL)


# ---------------------------------------------------------------------------
# (e) offload at 2 stages, (f) the guard
# ---------------------------------------------------------------------------

def test_offloading_round_uses_the_stage_local_count_bit_equal_to_full(
        results):
    _, ranks, _, _ = results
    cfg = W.config(layers=W.OFF_LAYERS)
    for rk in ranks:
        rs, ks = rk["off/ledger/r"], rk["off/ledger/k"]
        assert (rs > 0).any()
        assert ks.tolist() == [offload_periods(cfg, r, W.S) for r in rs]
        assert any(k != offload_periods(cfg, r) for k, r in zip(ks, rs)
                   if r > 0)                   # the global count differs
        assert rk["off/offload/loss"] == rk["off/full/loss"]
        np.testing.assert_array_equal(rk["off/offload/wave_losses"],
                                      rk["off/full/wave_losses"])
        for key in _keys(rk, "off/full/p1/"):
            np.testing.assert_array_equal(rk[f"off/offload/p1/{key}"],
                                          rk[f"off/full/p1/{key}"])
        assert rk["off/pinned"] > 0


def test_offloading_rounds_ledger_holds_its_stated_formula(results):
    """Every round's record: the prediction the reference's ledger makes
    (its wavefront of M + S − 1 ticks), and measured bytes exactly
    `port_round_bytes` (M·(S−1) stage sends, M rings less their
    metadata, M·S·k offloaded periods), the same fleet totals on every
    rank."""
    _, ranks, _, _ = results
    cfg, jcfg = W.config(layers=W.OFF_LAYERS), \
        jax_config("llama3.2-3b").reduced()
    import dataclasses
    jcfg = dataclasses.replace(jcfg, dtype="float32",
                               num_layers=W.OFF_LAYERS)
    ref = jledger.Ledger(jcfg, capacity=W.CAP, hdp=W.H, num_stages=W.S,
                         offload_active=True)
    rk = ranks[0]
    comps = [eval(c) for c in rk["off/ledger/comp"].tolist()]
    assert any(max(c) > 1 for c in comps)
    for i, comp in enumerate(comps):
        c_mult, n = int(rk["off/ledger/c_mult"][i]), \
            int(rk["off/ledger/n_waves"][i])
        r, k = float(rk["off/ledger/r"][i]), int(rk["off/ledger/k"][i])
        want = ref.predict_dispatch(comp, c_mult, r, n)
        assert rk["off/ledger/pred"][i].tolist() == \
            [want[x] for x in ("ring", "pp", "offload_d2h", "offload_h2d")]
        port = ledger.port_round_bytes(cfg, comp, n, W.S, c_mult * W.CAP,
                                       W.H, k)
        assert rk["off/ledger/meas"][i].tolist() == \
            [port[x] for x in ("ring", "pp", "offload_d2h", "offload_h2d")]
        assert port["pp"] > 0 and port["pp"] < want["pp"]
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["off/ledger/meas"],
                                      rk["off/ledger/meas"])


def test_capped_rounds_from_the_planner_thread_match_the_sync_run(results):
    """``max_round_waves=2`` splits the rounds (more of them than
    uncapped), and the planner thread's pre-built round buffers (its
    ``rounds_fn`` the executor's split) give the synchronous history."""
    _, ranks, _, _ = results
    for rk in ranks:
        sync, pre = rk["cap/sync/hist"], rk["cap/async/hist"]
        np.testing.assert_array_equal(pre, sync)
        assert (sync[:, 2] > [len(rk[f"ref/rounds/{s}"])
                              for s in range(2)]).any()
        np.testing.assert_allclose(sync[:, 0], rk["ref/loss"][:2],
                                   rtol=SELF_TOL)


@pytest.mark.parametrize("grid", ["grid", "stages"])
def test_async_planner_with_calibrate_is_refused_over_stages(results, grid):
    """Each stage process runs its own planner thread and calibrator, so
    the 2-stage Trainer refuses sched_async with calibrate when it is
    built, at hdp 2 and at hdp 1 alike."""
    _, ranks, _, _ = results
    for rk in ranks:
        assert "item 9" in str(rk[f"async/calibrate_refused/{grid}"])


def test_guard_skips_the_apply_on_every_rank(results):
    _, ranks, _, _ = results
    for rk in ranks:
        assert bool(rk["guard/unchanged"])
        assert int(rk["guard/applied"]) == 0
        assert int(rk["guard/nonfinite"]) > 0
        assert int(rk["guard/next_applied"]) == 1
        assert np.isfinite(rk["guard/next_loss"])


# ---------------------------------------------------------------------------
# (g) checkpoints across stage counts and HDP sizes
# ---------------------------------------------------------------------------

def test_checkpoint_resumes_at_another_stage_count_and_hdp_size(results):
    """Saved at 2 × 2 (step 2), resumed at 2 stages × hdp 1 (ranks 0, 2)
    and 1 stage × hdp 2 (ranks 1, 3): the next step's loss and grad norm
    within 1e-4 relative of the uninterrupted run's, on every rank."""
    _, ranks, _, _ = results
    runs = [str(rk["ckpt/run"]) for rk in ranks]
    assert runs == ["s2h1", "s1h2", "s2h1", "s1h2"]
    for rk in ranks:
        assert int(rk["ckpt/resumed_at"]) == 2
        assert int(rk["ckpt/opt_step"]) == 2
        assert int(rk["ckpt/uninterrupted/last_ckpt_step"]) == 2
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(rk[f"ckpt/{k}"],
                                       rk[f"ckpt/uninterrupted/{k}"],
                                       rtol=F32_TOL)


def test_one_stage_checkpoint_resumes_at_two_stages(results):
    """The 1 × 2 run's own checkpoint (step 3) resumed at 2 × 2: step 4
    within 1e-4 of the 1 × 2 run's step 4."""
    _, ranks, _, _ = results
    want = [float(rk["ckpt/s1h2_step4_loss"]) for rk in ranks[1::2]]
    assert want[0] == want[1]
    for rk in ranks:
        assert int(rk["ckpt/from_1stage/resumed_at"]) == 3
        np.testing.assert_allclose(rk["ckpt/from_1stage/loss"], want[0],
                                   rtol=F32_TOL)


def test_restored_state_is_an_exact_slice_of_the_file(results):
    """Each rank's restored parameters and master/m/v shards are its stage
    window, then its ZeRO-1 shard (which skips a stage's dim 0), of the
    file's global leaves."""
    _, ranks, _, out = results
    with np.load(out / "ckpt22" / "step_2" / "arrays.npz") as f:
        arrays = {k: f[k] for k in f.files}
    for rk in ranks:
        stage, num = rk["ckpt/stage"].tolist()
        h, hdp = rk["ckpt/hdp"].tolist()
        keys = _keys(rk, "ckpt/params/")
        assert len(keys) > 5
        for key in keys:
            want = arrays["params/" + key]
            stacked = key.startswith("blocks/")
            if stacked:
                w = stage_periods(want.shape[0], (stage, num))
                want = want[w.start:w.stop]
            np.testing.assert_array_equal(rk["ckpt/params/" + key], want)
            for part in ("master", "m", "v"):
                x = arrays[f"opt/{part}/{key}"]
                if stacked:
                    x = x[w.start:w.stop]
                dim = zero1.zero1_dim(x.shape, hdp,
                                      (0,) if stacked and num > 1 else ())
                if dim is not None:
                    n = x.shape[dim] // hdp
                    x = np.take(x, range(h * n, (h + 1) * n), axis=dim)
                np.testing.assert_array_equal(
                    rk[f"ckpt/state/{part}/{key}"], x)


def test_reference_restores_the_pipelined_checkpoint(results):
    """The reference's pipelined Trainer restores the port's 2 × 2 file
    (the single global layout) and steps on to the uninterrupted run's
    loss and grad norm."""
    ref, ranks, _, _ = results
    assert int(ref["ckpt/resumed_at"]) == 2
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(ref[f"ckpt/{k}"],
                                   ranks[0][f"ckpt/uninterrupted/{k}"],
                                   rtol=F32_TOL)


# ---------------------------------------------------------------------------
# (h) the launcher, (i) MoE
# ---------------------------------------------------------------------------

def test_launcher_trains_two_stages_on_two_gloo_ranks(results):
    _, _, log, _ = results
    lines = [ln for ln in log.splitlines() if ln.startswith("step")]
    assert len(lines) == 2
    rec = json.loads(log.strip().splitlines()[-1])
    assert rec["num_stages"] == 2 and rec["mesh"] == "1x1"
    assert all(np.isfinite(s["loss"]) for s in rec["steps"])
    pp = rec["pipeline"]
    assert sorted(pp["by_stage"]) == ["0", "1"]
    assert all(0.0 <= b < 1.0 for b in pp["bubble_analytic_by_step"])
    assert 0.0 <= pp["bubble_measured"] < 1.0
    assert rec["ledger"]["meas"]["pp"] > 0
    assert rec["ledger"]["pred"]["pp"] > rec["ledger"]["meas"]["pp"]


def test_moe_two_stages_match_its_one_stage_run(results):
    """Reduced Mistral-8x7B, seeded weights (a stage's init is its rows
    of the full init), one step at 2 × 2 against the 1-stage hdp = 2
    step: loss and grad norm within 1e-4 relative, the update per leaf
    within 1e-3 relative L2, ranks within a stage and replicated leaves
    across stages bit-identical."""
    _, ranks, _, _ = results
    one = ranks[0]
    for rk in ranks:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(rk[f"moe/{k}"], one[f"moe-1stage/{k}"],
                                       rtol=F32_TOL)
    p0, p1 = _global(ranks, "moe/p0/"), _global(ranks, "moe/p1/")
    assert "blocks/0/moe/router" in p0
    for key in p0:
        np.testing.assert_array_equal(p0[key], one[f"moe-1stage/p0/{key}"])
        want = one[f"moe-1stage/p1/{key}"] - p0[key]
        assert _rel(p1[key] - p0[key], want) <= UPDATE_TOL, key
    for h in range(W.H):
        a, b = ranks[h], ranks[W.H + h]
        for key in _keys(a, "moe/p1/"):
            if not key.startswith("blocks/"):
                np.testing.assert_array_equal(a[f"moe/p1/{key}"],
                                              b[f"moe/p1/{key}"])
