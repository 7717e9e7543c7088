"""The port's Trainer on the reference's whole grid: pipeline stages x HDP
ranks x model ranks, against the reference's pipelined `Trainer` on
``make_pipeline_mesh(2, 2, 2)`` (its own acceptance mesh,
`tests/test_pipeline.py`).

* (a) Reduced llama3.2-3b in float32 (4 heads, 2 KV heads, vocab 512, so
  tp 2 shards KV), PP-Balance plans (``mode="pp"``, ``num_stages=2``) at
  hdp 2, 3 steps: the reference on 8 host devices (``attn_impl="ref"``,
  ``remat="none"``) and the port on 8 gloo ranks, world rank s·4 + h·2 +
  m (`_torch_grid_worker.py`, `parallel/comm.py::grid`), from the
  reference's initial weights.  Plan fingerprints equal on every rank and
  on the reference; round, wave and step losses and grad norms within
  1e-4 relative; each step's update of every rank's window and slices
  within 1e-3 relative L2 per leaf (the tolerances of
  `tests/test_torch_pipeline.py`).
* (b) The tied embedding's gradient, summed over the stages and HDP
  ranks on each model rank's vocabulary rows, is the same on every rank
  that holds those rows and is neither stage's part alone; the replicated
  leaves are bit-identical across the stages and the model ranks, every
  leaf across the HDP ranks.
* (c) ZeRO-1 with both the stage's and the model's dimension taken:
  `zero1_dim` of a rank's window and slice against the reference's
  `zero1_spec` under `params_pspecs` with its stage and model axes, leaf
  by leaf.
* (d) The 2 x 2 x 2 checkpoint of step 2 resumed at 1 x 2 x 2 and at
  1 x 1 x 2: each rank's restored state its model slice, then its ZeRO-1
  shard, of the file's global leaves; the next step within 1e-4 of the
  uninterrupted run's.
* (e) An offloading step at 2 x 2 x 2 (4 layers, 2 periods a stage) and
  at one stage, hdp 2 x tp 2: bit-equal to the same step under remat
  ``"full"``; its ledger's predicted bytes the reference's (no tp term),
  its measured bytes one model rank's, exactly
  `obs/ledger.py::port_round_bytes` at tp 2.
* (f) ``launch/train.py --mesh 1x2 --num-stages 2 --offload`` on 4 gloo
  ranks.

The reference, the gloo ranks and the launcher run as three subprocesses
started together by one module fixture.
"""
import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_grid_worker as W
from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.obs import ledger as jledger
from repro.parallel import sharding as jsharding
from repro.parallel import zero1 as jzero1
from repro_torch.core.offload import offload_periods
from repro_torch.models.transformer import stage_periods
from repro_torch.obs import ledger
from repro_torch.parallel import zero1
from repro_torch.parallel.sharding import shard_param, tp_split_dim
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4                  # tests/test_torch_train.py
UPDATE_TOL = 1e-3               # post-step update, relative L2 per leaf
TIMEOUT = 600

JAX_SCRIPT = r"""
import os, sys
sys.path.insert(0, "tests")
import _torch_grid_worker as W
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           f"{W.R}")
import dataclasses
import numpy as np
from repro import compat
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config
from repro.data.distribution import LengthDistribution
from repro.data.loader import GlobalScheduler, SyntheticDataset
from repro.launch.mesh import hdp_axes_of, make_pipeline_mesh
from repro.obs.numerics import plan_fingerprint
from repro.optim.adamw import AdamWConfig
from repro.parallel.sharding import Runtime
from repro.train.trainer import Trainer, TrainerConfig

out = sys.argv[1]
mesh = make_pipeline_mesh(W.S, W.H, W.TP)
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
    for k in ("loss", "grad_norm", "waves", "rounds"):
        res.setdefault(k, []).append(rec[k])
    res[f"round_losses/{s}"] = [l for st, l in rounds if st == s]
    for key, v in _flatten(tr.params).items():
        res[f"p{s + 1}/{key}"] = v
sched.stop()
res["fp"] = np.array(plans)
np.savez(out + "/jax_grid.npz", **{k: np.asarray(v) for k, v in res.items()})
"""

LAUNCH_ARGS = ["--arch", "llama3.2-3b", "--reduced", "--steps", "2",
               "--capacity", "256", "--tokens-per-step", "1024",
               "--context", "512", "--dataset", "tiny", "--device", "cpu",
               "--attn-impl", "ref", "--mesh", "1x2", "--num-stages", "2",
               "--offload"]


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("grid")


@pytest.fixture(scope="module", autouse=True)
def procs(out_dir):
    """Start the reference (8 host devices), the port (8 gloo ranks) and
    the launcher (4 gloo ranks) together; kill what is left at the end
    of the module."""
    env = subprocess_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    started = {}
    for part, cmd in (
            ("jax", [sys.executable, "-c", JAX_SCRIPT, str(out_dir)]),
            ("torch", [sys.executable,
                       str(ROOT / "tests" / "_torch_grid_worker.py"),
                       str(out_dir)]),
            ("launch", [sys.executable, "-m", "repro_torch.launch.train",
                        *LAUNCH_ARGS])):
        with open(out_dir / f"{part}.log", "w") as log, \
                open(out_dir / f"{part}.err", "w") as err:
            started[part] = subprocess.Popen(
                cmd, cwd=out_dir if part == "launch" else ROOT, env=env,
                stdout=log, stderr=err)
    try:
        yield started
    finally:
        for p in started.values():
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.fixture(scope="module")
def results(procs, out_dir):
    """-> (reference results, per-rank port results, the launcher's
    stdout), once all three have ended."""
    try:
        for p in procs.values():
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for part, p in procs.items():
        assert p.returncode == 0, (
            part, (out_dir / f"{part}.log").read_text()[-2000:],
            (out_dir / f"{part}.err").read_text()[-4000:])
    ref = dict(np.load(out_dir / "jax_grid.npz"))
    ranks = [dict(np.load(out_dir / f"torch_rank{r}.npz"))
             for r in range(W.R)]
    return ref, ranks, (out_dir / "launch.log").read_text()


def _keys(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


def _split(key: str, ndim: int):
    return tp_split_dim(key.split("/"), ndim, True)


def _model_slice(arr: np.ndarray, key: str, m: int) -> np.ndarray:
    """A leaf cut to model rank ``m``'s slice."""
    dim = _split(key, arr.ndim)
    return arr if dim is None else shard_param(
        torch.from_numpy(np.ascontiguousarray(arr)), dim, m, W.TP).numpy()


def _local(arr: np.ndarray, key: str, stage: int, m: int) -> np.ndarray:
    """A global leaf cut to stage ``stage``'s window and model rank
    ``m``'s slice."""
    if key.startswith("blocks/"):
        w = stage_periods(arr.shape[0], (stage, W.S))
        arr = arr[w.start:w.stop]
    return _model_slice(arr, key, m)


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _where(rk):
    return int(rk["stage"]), int(rk["hdp_rank"]), int(rk["model_rank"])


# ---------------------------------------------------------------------------
# (a) three steps against the reference's pipelined Trainer
# ---------------------------------------------------------------------------

def test_grid_ranks_are_stage_major_and_model_fastest(results):
    _, ranks, _ = results
    for r, rk in enumerate(ranks):
        s, rest = divmod(r, W.H * W.TP)
        assert _where(rk) == (s, *divmod(rest, W.TP))


def test_plan_fingerprints_agree_on_every_rank_and_the_reference(results):
    ref, ranks, _ = results
    want = ref["fp"].tolist()
    assert len(want) == W.STEPS and len(set(want)) == W.STEPS
    for rk in ranks:
        assert rk["ref/fp"].tolist() == want


def test_losses_and_grad_norms_match_the_reference(results):
    """Round losses (the reference's numerics see one loss a round),
    step losses and grad norms within 1e-4 relative on every rank; the
    rounds and waves are the reference's."""
    ref, ranks, _ = results
    assert max(ref["rounds"].tolist()) > 1
    for rk in ranks:
        assert rk["ref/waves"].tolist() == ref["waves"].tolist()
        assert rk["ref/rounds"].tolist() == ref["rounds"].tolist()
        assert rk["ref/applied"].tolist() == [1] * W.STEPS
        for s in range(W.STEPS):
            np.testing.assert_allclose(rk[f"ref/round_losses/{s}"],
                                       ref[f"round_losses/{s}"],
                                       rtol=F32_TOL)
            np.testing.assert_allclose(
                np.sum(rk[f"ref/wave_losses/{s}"]), ref["loss"][s],
                rtol=F32_TOL)
        np.testing.assert_allclose(rk["ref/loss"], ref["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(rk["ref/grad_norm"], ref["grad_norm"],
                                   rtol=F32_TOL)


def test_parameter_updates_match_the_reference(results, out_dir):
    """Every rank's update of its stage window and model slices within
    1e-3 relative L2 per leaf of the same part of the reference's."""
    ref, ranks, _ = results
    p0 = dict(np.load(out_dir / "jax_params.npz"))
    keys = _keys(ranks[0], "ref/p0/")
    assert len(keys) > 5 and keys == _keys(ref, "p1/")
    for rk in ranks:
        stage, _, m = _where(rk)
        for key in keys:
            np.testing.assert_array_equal(rk[f"ref/p0/{key}"],
                                          _local(p0[key], key, stage, m))
        for s in range(W.STEPS):
            for key in keys:
                before = p0[key] if s == 0 else ref[f"p{s}/{key}"]
                got = rk[f"ref/p{s + 1}/{key}"] - rk[f"ref/p{s}/{key}"]
                want = _local(ref[f"p{s + 1}/{key}"] - before, key, stage, m)
                assert _rel(got, want) <= UPDATE_TOL, (_where(rk), s, key)


# ---------------------------------------------------------------------------
# (b) the tied embedding and the replicated leaves
# ---------------------------------------------------------------------------

def test_tied_embedding_sums_both_stages_on_each_model_ranks_rows(results):
    _, ranks, _ = results
    for s in range(W.STEPS):
        for m in range(W.TP):
            mine = [rk for rk in ranks if _where(rk)[2] == m]
            want = mine[0][f"ref/embed_grad/{s}"]
            assert np.abs(want).max() > 0
            for rk in mine:
                np.testing.assert_array_equal(rk[f"ref/embed_grad/{s}"],
                                              want)
                assert _rel(rk[f"ref/embed_grad_own/{s}"], want) > 1e-3
        assert not np.array_equal(ranks[0][f"ref/embed_grad/{s}"],
                                  ranks[1][f"ref/embed_grad/{s}"])


def test_replicated_leaves_bit_identical_across_stages_and_model_ranks(
        results):
    """A leaf the stages share is bit-identical across each stage group;
    a leaf the model ranks share across each model group; every leaf
    across each HDP group."""
    _, ranks, _ = results
    at = {_where(rk): rk for rk in ranks}
    for s in range(W.STEPS + 1):
        keys = _keys(ranks[0], f"ref/p{s}/")
        for (st, h, m), rk in at.items():
            for key in keys:
                arr = rk[f"ref/p{s}/{key}"]
                if not key.startswith("blocks/"):
                    np.testing.assert_array_equal(
                        at[(0, h, m)][f"ref/p{s}/{key}"], arr, err_msg=key)
                if _split(key, arr.ndim) is None:
                    np.testing.assert_array_equal(
                        at[(st, h, 0)][f"ref/p{s}/{key}"], arr, err_msg=key)
                np.testing.assert_array_equal(
                    at[(st, 0, m)][f"ref/p{s}/{key}"], arr, err_msg=key)


# ---------------------------------------------------------------------------
# (c) ZeRO-1 with the stage's and the model's dimension taken
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("hdp", [2, 4])
@pytest.mark.parametrize("name", ["llama3.2-3b-reduced", "llama3.2-3b",
                                  "llama-7b"])
def test_zero1_dim_with_both_dims_taken_matches_zero1_spec(name, hdp, tp):
    """The reference's `params_pspecs` puts its stage axis on a stacked
    leaf's dim 0 and its model axis on the split dimension; `zero1_spec`
    shards the first free divisible dimension; the port's `zero1_dim` of
    a rank's window and slice, both taken, shards the same one."""
    cfg = jax_config(name)
    rt = types.SimpleNamespace(
        hdp_size=hdp, hdp_axes=("data",), model_axis="model",
        stage_axis="stage", num_stages=2,
        layout=lambda c: JL.gqa_layout(c.num_heads, c.num_kv_heads, tp))
    abstract = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg, rt))
    specs = jax.tree.leaves(jsharding.params_pspecs(abstract, cfg, rt),
                            is_leaf=lambda x: isinstance(x, P))
    flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
    kvs = JL.gqa_layout(cfg.num_heads, cfg.num_kv_heads, tp).kv_sharded
    assert len(specs) == len(flat) > 5
    both = 0
    for (path, leaf), spec in zip(flat, specs):
        key = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        stacked = key[0] == "blocks"
        split = tp_split_dim(key, leaf.ndim, kvs)
        assert (split is None) == ("model" not in tuple(spec)), key
        got = jzero1.zero1_spec(spec, leaf.shape, rt)
        want = next((i for i, e in enumerate(got)
                     if e not in (None, "stage", "model")), None)
        local = list(leaf.shape)
        taken = ()
        if stacked:
            local[0] //= 2
            taken += (0,)
        if split is not None:
            local[split] //= tp
            taken += (split,)
        both += stacked and split is not None
        assert zero1.zero1_dim(local, hdp, taken) == want, (key, leaf.shape)
    assert both > 3


# ---------------------------------------------------------------------------
# (d) the 2 x 2 x 2 checkpoint at other grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", ["g122", "g112"])
def test_checkpoint_resumes_at_another_grid(results, run):
    """Resumed at 1 x 2 x 2 (each stage's ranks) and at 1 x 1 x 2 (each
    model group): step 3's loss and grad norm within 1e-4 relative of the
    uninterrupted 2 x 2 x 2 run's, on every rank."""
    _, ranks, _ = results
    for rk in ranks:
        assert int(rk[f"ckpt/{run}/resumed_at"]) == W.CKPT_STEP
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(rk[f"ckpt/{run}/{k}"],
                                       rk[f"ref/{k}"][W.CKPT_STEP],
                                       rtol=F32_TOL)


def test_restored_state_is_an_exact_slice_of_the_file(results, out_dir):
    """At 1 x 2 x 2 each rank's restored parameters are its model slices
    of the file's global leaves, and its master, m and v its ZeRO-1 shard
    (over the HDP group, the split dimension taken) of those slices."""
    _, ranks, _ = results
    with np.load(out_dir / "ckpt" / f"step_{W.CKPT_STEP}" /
                 "arrays.npz") as f:
        arrays = {k: f[k] for k in f.files}
    sharded = 0
    for rk in ranks:
        _, h, m = _where(rk)
        keys = _keys(rk, "ckpt/g122/params/")
        assert len(keys) > 5
        for key in keys:
            want = arrays["params/" + key]
            dim = _split(key, want.ndim)
            mine = _model_slice(want, key, m)     # one stage: every period
            np.testing.assert_array_equal(rk[f"ckpt/g122/params/{key}"],
                                          mine, err_msg=key)
            zd = zero1.zero1_dim(mine.shape, W.H,
                                 () if dim is None else (dim,))
            sharded += zd is not None
            for part in ("master", "m", "v"):
                x = _model_slice(arrays[f"opt/{part}/{key}"], key, m)
                if zd is not None:
                    n = x.shape[zd] // W.H
                    x = np.take(x, range(h * n, (h + 1) * n), axis=zd)
                np.testing.assert_array_equal(
                    rk[f"ckpt/g122/state/{part}/{key}"], x,
                    err_msg=f"{part} {key}")
    assert sharded > 0


# ---------------------------------------------------------------------------
# (e) offload on the grid
# ---------------------------------------------------------------------------

GRIDS = {"pp": W.S, "flat": 1}       # the offload runs' stage counts


@pytest.mark.parametrize("tag", sorted(GRIDS))
def test_offloading_step_is_bit_equal_to_full(results, tag):
    """The (stage-local) k, positive somewhere, the loss, the wave losses
    and every parameter bit for bit the same as the step under remat
    "full" on the same plans."""
    _, ranks, _ = results
    cfg = W.config(W.OFF_LAYERS)
    for rk in ranks:
        pre = f"off/{tag}"
        rs, ks = rk[f"{pre}/ledger/r"], rk[f"{pre}/ledger/k"]
        assert (ks > 0).any()
        assert ks.tolist() == [offload_periods(cfg, r, GRIDS[tag])
                               for r in rs]
        assert rk[f"{pre}/offload/loss"] == rk[f"{pre}/full/loss"]
        np.testing.assert_array_equal(rk[f"{pre}/offload/wave_losses"],
                                      rk[f"{pre}/full/wave_losses"])
        for key in _keys(rk, f"{pre}/full/p1/"):
            np.testing.assert_array_equal(rk[f"{pre}/offload/p1/{key}"],
                                          rk[f"{pre}/full/p1/{key}"])
        assert rk[f"{pre}/moved"][0] == rk[f"{pre}/moved"][1] > 0


@pytest.mark.parametrize("tag", sorted(GRIDS))
def test_offloading_ledger_holds_its_stated_formula(results, tag):
    """Every dispatch's record (a round on the grid, a wave at one
    stage): the reference's prediction at tp 2 (its offload and
    stage-roll prices have no tp term), and measured bytes one model
    rank's, exactly `port_round_bytes` at tp 2 (M·(S−1) stage sends, M
    rings of the rank's KV heads less their metadata, M·S·k offloaded
    periods), the same fleet totals on every rank."""
    _, ranks, _ = results
    stages = GRIDS[tag]
    cfg = W.config(W.OFF_LAYERS)
    jcfg = dataclasses.replace(jax_config(W.ARCH).reduced(), dtype="float32",
                               num_layers=W.OFF_LAYERS)
    ref = jledger.Ledger(jcfg, capacity=W.CAP, hdp=W.H, num_stages=stages,
                         tp=W.TP, offload_active=True)
    pre = f"off/{tag}/ledger"
    rk = ranks[0]
    comps = [eval(c) for c in rk[f"{pre}/comp"].tolist()]
    assert len(comps) == len(rk[f"{pre}/k"])
    assert any(max(c) > 1 for c in comps)
    for i, comp in enumerate(comps):
        c_mult, n = int(rk[f"{pre}/c_mult"][i]), int(rk[f"{pre}/n_waves"][i])
        r, k = float(rk[f"{pre}/r"][i]), int(rk[f"{pre}/k"][i])
        want = ref.predict_dispatch(comp, c_mult, r, n)
        assert rk[f"{pre}/pred"][i].tolist() == [want[x] for x in W.KINDS]
        port = ledger.port_round_bytes(cfg, comp, n, stages, c_mult * W.CAP,
                                       W.H, k, tp=W.TP, kv_sharded=True)
        assert rk[f"{pre}/meas"][i].tolist() == [port[x] for x in W.KINDS]
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[f"{pre}/meas"], rk[f"{pre}/meas"])


# ---------------------------------------------------------------------------
# (f) the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_tp_x_pp_with_offload(results):
    *_, stdout = results
    steps = [ln for ln in stdout.splitlines() if ln.startswith("step")]
    rec = json.loads([ln for ln in stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert len(steps) == 2
    assert rec["mesh"] == "1x2" and rec["num_stages"] == 2 and rec["offload"]
    assert all(np.isfinite(s["loss"]) for s in rec["steps"])
    assert rec["pinned_host_gb"] > 0
    assert sorted(rec["pipeline"]["by_stage"]) == ["0", "1"]
    assert rec["ledger"]["meas"]["pp"] > 0
    assert rec["ledger"]["meas"]["offload_d2h"] > 0
