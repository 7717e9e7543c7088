"""The port's multi-rank `Trainer` under ZeRO-1 against the reference's
`Trainer` at hdp = 4.

* Reduced llama3.2-3b in float32, 3 steps of the planner's hdp = 4 plans
  (2048 tokens a step, context 1024, capacity 256 a rank), calibration
  off: the reference's `Trainer` on a (4, 1) mesh of 4 host devices
  (``attn_impl="ref"``) and the port's on 4 gloo ranks, one process each
  (`_torch_hdp_train_worker.py`), from the reference's initial weights.
  Plan fingerprints equal on every rank and on the reference; per-wave
  losses, step losses and grad norms within 1e-4 relative
  (`test_torch_train.py`'s F32_TOL); every step's parameter update within
  1e-3 relative L2 per leaf; every rank's parameters bit-identical, at
  ``attn_impl`` "ref" and "flash" (the kernels' plain versions here).
* Selective offload: the same holds of both sides' `Trainer` at
  ``use_offload=True`` (4 layers, 2048 tokens a step, context 2048), whose
  plans hold offloading waves, one of them a (4,) ring; the bytes ledgers
  agree: the same predictions, the same measured offload bytes, and the
  port's measured ring bytes the reference's less the block metadata the
  port does not rotate (`obs/ledger.py`).
* MoE: reduced Mistral-8x7B on the same data and plans, each rank's rows
  of a wave routed as one group (the reference's per-rank vmap), with
  the same holds (the float32 router and the stacked expert leaves
  sharded by ZeRO-1).
* ZeRO-1: `zero1_dim` against the reference's `zero1_spec` leaf by leaf
  (reduced and full llama3.2-3b, LLaMA-7B; hdp 2, 4, 8), `zero1_bytes`
  against the reference's, each rank's optimiser state its shard, and
  the sharded apply against the unsharded apply on the same reduced
  gradients (fp32 within 1e-6, bf16 within one ulp or, for values under
  2.4e-4 whose ulp is finer, 1e-6).
* The guard, the plan check and the planner thread over 4 ranks: a
  guarded skip is bit-exact on every rank; planted mismatched plans make
  every rank raise, none hanging; ``sched_async`` without calibration
  gives the synchronous history, with calibration it is refused.
* Checkpoints across HDP sizes: hdp = 4 saves (rank 0 writes the ZeRO-1
  state whole: the file's master, m and v are exactly the ranks' shards
  put together); the file resumes at hdp = 2 and 1, and an hdp = 1
  checkpoint at hdp = 4, each rank's restored shards exact slices of the
  file and the next step within 1e-4 relative (loss, grad norm) and
  1e-3 relative L2 per leaf (update) of the reference's `Trainer`
  resuming the same file at that size; ranks that restore different
  steps all raise.
* The launcher's ``--mesh 2x1`` on 2 gloo ranks, checkpointing, and its
  resume at ``--mesh 1x1``.

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

import _torch_hdp_train_worker as W
from repro.configs.registry import get_config as jax_config
from repro.models import transformer as JT
from repro.parallel import zero1 as jzero1
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as launch_train
from repro_torch.obs import ledger
from repro_torch.parallel import zero1
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
RUNS = W.IMPLS + W.OFF_RUNS     # the port's runs held to the reference
HELD = RUNS + W.MOE_RUNS        # and the MoE run (its updates: below)
F32_TOL = 1e-4                  # tests/test_torch_train.py
UPDATE_TOL = 1e-3               # post-step update, relative L2 per leaf
APPLY_TOL = 1e-6                # sharded vs unsharded apply: fp32; a bf16
                                # parameter within one ulp, or this much
                                # where one ulp is finer (the clip factor
                                # is summed from shards, and the masters'
                                # own hold admits more there)

JAX_SCRIPT = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import numpy as np
from repro import compat
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config
from repro.data.distribution import LengthDistribution
from repro.data.loader import GlobalScheduler, SyntheticDataset
from repro.obs import set_ledger_enabled
from repro.obs.numerics import plan_fingerprint
from repro.optim.adamw import AdamWConfig
from repro.parallel.sharding import Runtime
from repro.train.trainer import Trainer, TrainerConfig
sys.path.insert(0, "tests")
import _torch_hdp_train_worker as W

out = sys.argv[1]
mesh = compat.make_mesh((W.R, 1), ("data", "model"),
                        axis_types=compat.auto_axis_types(2))
compat.set_mesh(mesh)
cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                          dtype="float32")
rt = Runtime(mesh=mesh, hdp_axes=("data",), model_axis="model")

# a Trainer recording its plans; its initial weights are saved first, as
# the gloo ranks wait for them
def trainer(cfg, tokens, context, offload, name):
    ds = SyntheticDataset(LengthDistribution(*W.DIST), cfg.vocab_size,
                          tokens_per_step=tokens, context=context)
    sched = GlobalScheduler(ds, cfg, capacity=W.CAP, hdp=W.R,
                            use_offload=offload)
    plans = []
    plan_step = sched.plan_step
    def recorded(step):
        plan = plan_step(step)
        plans.append(plan_fingerprint(plan))
        return plan
    sched.plan_step = recorded
    tr = Trainer(cfg, rt, AdamWConfig(lr=W.LR, total_steps=W.TOTAL_STEPS),
                 sched, TrainerConfig(capacity=W.CAP, attn_impl="ref",
                                      calibrate=False, use_offload=offload))
    tr.plans = plans
    np.savez(out + f"/{name}.tmp.npz", **_flatten(tr.params))
    os.replace(out + f"/{name}.tmp.npz", out + f"/{name}.npz")
    return tr

def train(tr, res, pre):
    wave_losses = []
    observe_wave = tr.numerics.observe_wave
    def observe(step, i, loss):
        wave_losses.append((step, float(loss)))
        return observe_wave(step, i, loss)
    tr.numerics.observe_wave = observe
    for s in range(W.STEPS):
        rec = tr.train_step()
        res.setdefault(pre + "loss", []).append(rec["loss"])
        res.setdefault(pre + "grad_norm", []).append(rec["grad_norm"])
        res.setdefault(pre + "waves", []).append(rec["waves"])
        res[pre + f"wave_losses/{s}"] = [l for st, l in wave_losses
                                         if st == s]
        for key, v in _flatten(tr.params).items():
            res[pre + f"p{s + 1}/{key}"] = v
    tr.sched.stop()
    res[pre + "fp"] = np.array(tr.plans)

tr = trainer(cfg, W.TOKENS, W.CONTEXT, False, "jax_params")
tr_off = trainer(dataclasses.replace(cfg, num_layers=W.OFF_LAYERS),
                 W.OFF_TOKENS, W.OFF_CONTEXT, True, "jax_params_offload")
tr_moe = trainer(dataclasses.replace(get_config(W.MOE_ARCH).reduced(),
                                     dtype="float32"),
                 W.TOKENS, W.CONTEXT, False, "jax_params_moe")
res = {}
train(tr, res, "")
train(tr_moe, res, "moe/")
set_ledger_enabled(True)
train(tr_off, res, "off/")
recs = tr_off.ledger.recent(1024)
for side in ("pred", "meas"):
    res["off/ledger/" + side] = [[r[side][k] for k in W.LEDGER_KINDS]
                                 for r in recs]
res["off/offload_ok"] = tr_off.offload_ok

# the port's checkpoints, resumed at the port's sizes: one step each
def resume_step(hdp, ckpt_dir, run):
    t0 = time.monotonic()
    while not os.path.exists(ckpt_dir + "/step_2/manifest.json"):
        if time.monotonic() - t0 > 300:
            raise TimeoutError(ckpt_dir + "/step_2 did not appear")
        time.sleep(0.2)
    m = compat.make_mesh((hdp, 1), ("data", "model"),
                         axis_types=compat.auto_axis_types(2),
                         devices=jax.devices()[:hdp])
    compat.set_mesh(m)
    ds = SyntheticDataset(LengthDistribution(*W.DIST), cfg.vocab_size,
                          tokens_per_step=W.TOKENS, context=W.CONTEXT)
    sched = GlobalScheduler(ds, cfg, capacity=W.CAP, hdp=hdp,
                            use_offload=False)
    tr = Trainer(cfg, Runtime(mesh=m, hdp_axes=("data",), model_axis="model"),
                 AdamWConfig(lr=W.LR, total_steps=W.TOTAL_STEPS), sched,
                 TrainerConfig(capacity=W.CAP, attn_impl="ref",
                               calibrate=False, ckpt_dir=ckpt_dir,
                               ckpt_save=False))
    assert tr.resume_if_possible()
    res[f"ckpt/{run}/resumed_at"] = tr.step
    rec = tr.train_step()
    for k in ("loss", "grad_norm", "waves"):
        res[f"ckpt/{run}/{k}"] = rec[k]
    for key, v in _flatten(tr.params).items():
        res[f"ckpt/{run}/after/{key}"] = v
    sched.stop()

for hdp, d, run in ((2, "ckpt4", "h2"), (1, "ckpt4", "h1"),
                    (4, "ckpt1", "h4_from_h1")):
    resume_step(hdp, f"{out}/{d}", run)
np.savez(out + "/jax_train.npz", **{k: np.asarray(v) for k, v in res.items()})
"""

LAUNCH_ARGS = ["--arch", "llama3.2-3b", "--reduced", "--steps", "2",
               "--capacity", "256", "--tokens-per-step", "1024",
               "--context", "512", "--dataset", "tiny", "--device", "cpu",
               "--attn-impl", "ref"]
LAUNCH_CKPT = "launch_ckpt"     # the launcher's --ckpt-dir, in its cwd


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("hdp_train")


@pytest.fixture(scope="module")
def results(out_dir):
    """Start the reference (4 host devices), the port (4 gloo ranks) and
    the launcher (2 gloo ranks, checkpointing) together; -> (reference
    results, per-rank port results, the launcher's stdout)."""
    out = out_dir
    env = subprocess_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs, logs = {}, {}
    for part, cmd in (
            ("jax", [sys.executable, "-c", JAX_SCRIPT, str(out)]),
            ("torch", [sys.executable,
                       str(ROOT / "tests" / "_torch_hdp_train_worker.py"),
                       str(out)]),
            ("launch", [sys.executable, "-m", "repro_torch.launch.train",
                        *LAUNCH_ARGS, "--mesh", "2x1",
                        "--ckpt-dir", LAUNCH_CKPT])):
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
    return ref, ranks, logs["launch"].read_text()


def _leaf_keys(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


def _ref(run: str) -> str:
    """The reference's key prefix for one of the port's runs."""
    return "off/" if run in W.OFF_RUNS else \
        "moe/" if run in W.MOE_RUNS else ""


# ---------------------------------------------------------------------------
# (a) three steps against the reference's Trainer at hdp = 4
# ---------------------------------------------------------------------------

def test_plan_fingerprints_agree_on_every_rank_and_the_reference(results):
    ref, ranks, _ = results
    for run in HELD:
        want = ref[_ref(run) + "fp"].tolist()
        assert len(want) == W.STEPS and len(set(want)) == W.STEPS
        for rk in ranks:
            assert rk[f"{run}/fp"].tolist() == want, run


@pytest.mark.parametrize("impl", HELD)
def test_losses_and_grad_norms_match_the_reference(results, impl):
    ref, ranks, _ = results
    pre = _ref(impl)
    for rk in ranks:
        assert rk[f"{impl}/waves"].tolist() == ref[pre + "waves"].tolist()
        assert rk[f"{impl}/applied"].tolist() == [1] * W.STEPS
        for s in range(W.STEPS):
            np.testing.assert_allclose(rk[f"{impl}/wave_losses/{s}"],
                                       ref[f"{pre}wave_losses/{s}"],
                                       rtol=F32_TOL)
        np.testing.assert_allclose(rk[f"{impl}/loss"], ref[pre + "loss"],
                                   rtol=F32_TOL)
        np.testing.assert_allclose(rk[f"{impl}/grad_norm"],
                                   ref[pre + "grad_norm"], rtol=F32_TOL)


@pytest.mark.parametrize("impl", RUNS)
def test_parameter_updates_match_the_reference(results, impl):
    """Every step's update (params after - params before) per leaf within
    1e-3 relative L2 of the reference's."""
    ref, ranks, _ = results
    rk = ranks[0]
    pre = _ref(impl)
    keys = _leaf_keys(rk, f"{impl}/p0/")
    assert len(keys) > 5 and keys == _leaf_keys(ref, pre + "p1/")
    for s in range(W.STEPS):
        for key in keys:
            got = rk[f"{impl}/p{s + 1}/{key}"] - rk[f"{impl}/p{s}/{key}"]
            before = rk[f"{impl}/p0/{key}"] if s == 0 \
                else ref[f"{pre}p{s}/{key}"]
            want = ref[f"{pre}p{s + 1}/{key}"] - before
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= UPDATE_TOL, (s, key, rel)


@pytest.mark.parametrize("run", W.OFF_RUNS)
def test_offload_runs_and_its_ledger_matches_the_reference(results, run):
    """The port's offload run offloads (a wave with r > 0 and k >= 1, and
    one with a ring), and every wave's ledger record holds the reference's
    prediction exactly, its measured offload bytes exactly, and measures
    the predicted ring bytes less `ledger.ring_meta_bytes` exactly.  (The
    reference's own measured ring of a wave that offloads k < n periods
    counts the first k periods only, so the port is held to its
    prediction there.)"""
    ref, ranks, _ = results
    assert bool(ref["off/offload_ok"])
    cfg = W.config(layers=W.OFF_LAYERS)
    rk = ranks[0]
    rs, ks = rk[f"{run}/ledger/r"], rk[f"{run}/ledger/k"]
    assert ((rs > 0) & (ks >= 1)).any()
    comps = rk[f"{run}/ledger/comp"].tolist()
    assert any("4" in c for c in comps)
    pred, meas = rk[f"{run}/ledger/pred"], rk[f"{run}/ledger/meas"]
    np.testing.assert_array_equal(pred, ref["off/ledger/pred"])
    np.testing.assert_array_equal(meas[:, 1:], ref["off/ledger/meas"][:, 1:])
    meta = [ledger.ring_meta_bytes(cfg, eval(c)) for c in comps]
    assert max(meta) > 0
    np.testing.assert_array_equal(meas[:, 0], pred[:, 0] - meta)
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[f"{run}/ledger/meas"], meas)


@pytest.mark.parametrize("impl", HELD)
def test_every_rank_holds_the_same_parameters(results, impl):
    _, ranks, _ = results
    for s in range(W.STEPS + 1):
        for key in _leaf_keys(ranks[0], f"{impl}/p{s}/"):
            for r, rk in enumerate(ranks[1:], 1):
                np.testing.assert_array_equal(
                    rk[f"{impl}/p{s}/{key}"], ranks[0][f"{impl}/p{s}/{key}"],
                    err_msg=f"rank {r} step {s} {key}")


def _eps_band(before, after):
    """The elements of a leaf whose first AdamW update (bias-corrected m/
    (sqrt(v) + eps) = g/(|g| + eps)) has |g/(|g| + eps)| < 1/2, backed
    out of the update: a gradient below AdamW's eps."""
    from repro_torch.optim.adamw import AdamWConfig, schedule_lr
    cfg = AdamWConfig(lr=W.LR, total_steps=W.TOTAL_STEPS)
    lr = float(schedule_lr(cfg, torch.tensor(1)))
    ratio = -(after.astype(np.float64) - before) / lr \
        - cfg.weight_decay * before
    return np.abs(ratio) < 0.5


@pytest.mark.parametrize("run", W.MOE_RUNS)
def test_moe_parameter_updates_match_the_reference(results, run):
    """As `test_parameter_updates_match_the_reference`: every step's
    update within 1e-3 relative L2 per leaf, but for the step-1 elements
    whose reference gradient is below AdamW's eps (1e-8), at most one in
    10^4.  There the first update is lr·g/(|g| + eps), which turns a
    gradient at the level of summation roundoff into an update
    difference of up to lr: the two packages cannot agree on such a
    gradient (an embedding element of this run: g/(|g| + eps) 0.28 in
    the reference, 0.56 in the port), and the dense runs hold none."""
    ref, ranks, _ = results
    rk = ranks[0]
    pre = _ref(run)
    keys = _leaf_keys(rk, f"{run}/p0/")
    assert len(keys) > 5 and keys == _leaf_keys(ref, pre + "p1/")
    left_out = total = 0
    for s in range(W.STEPS):
        for key in keys:
            before = rk[f"{run}/p0/{key}"] if s == 0 \
                else ref[f"{pre}p{s}/{key}"]
            got = rk[f"{run}/p{s + 1}/{key}"] - rk[f"{run}/p{s}/{key}"]
            want = ref[f"{pre}p{s + 1}/{key}"] - before
            if s == 0:
                band = _eps_band(before, ref[f"{pre}p1/{key}"])
                left_out += int(band.sum())
                total += band.size
                got, want = got[~band], want[~band]
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= UPDATE_TOL, (s, key, rel)
    print(f"step-1 elements below AdamW's eps, left out: {left_out} of "
          f"{total}")
    assert left_out <= total * 1e-4


@pytest.mark.parametrize("run", W.MOE_RUNS)
def test_moe_run_trains_routers_and_sharded_experts(results, run):
    """The MoE run's tree holds the float32 routers and the stacked
    expert leaves, which ZeRO-1 shards on their expert dimension."""
    _, ranks, _ = results
    rk = ranks[0]
    assert rk[f"{run}/p0/blocks/0/moe/router"].dtype == np.float32
    w_in = rk[f"{run}/p0/blocks/0/moe/w_in"]
    assert w_in.shape == (2, 4, 64, 64)          # [n_periods, E, d, f]
    assert zero1.zero1_dim(w_in.shape, W.R) == 1
    moved = rk[f"{run}/p{W.STEPS}/blocks/0/moe/router"] \
        - rk[f"{run}/p0/blocks/0/moe/router"]
    assert np.abs(moved).max() > 0


# ---------------------------------------------------------------------------
# (b) ZeRO-1
# ---------------------------------------------------------------------------

def _abstract_params(name: str, rt1):
    """[(path, ShapeDtypeStruct)] of a config's parameter tree, from the
    reference's init traced abstractly (nothing is allocated)."""
    cfg = jax_config(name)
    abstract = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg, rt1))
    return abstract, jax.tree_util.tree_flatten_with_path(abstract)[0]


@pytest.mark.parametrize("hdp", [2, 4, 8])
@pytest.mark.parametrize("name", ["llama3.2-3b-reduced", "llama3.2-3b",
                                  "llama-7b"])
def test_zero1_dim_matches_zero1_spec(name, hdp, rt1):
    """Leaf by leaf, the dimension the port shards is the one the
    reference's `zero1_spec` gives an unsharded leaf at tp = 1."""
    abstract, leaves = _abstract_params(name, rt1)
    rt = types.SimpleNamespace(hdp_size=hdp, hdp_axes=("data",))
    assert len(leaves) > 5
    for path, leaf in leaves:
        spec = jzero1.zero1_spec(P(), leaf.shape, rt)
        want = next((i for i, e in enumerate(spec) if e is not None), None)
        assert zero1.zero1_dim(leaf.shape, hdp) == want, (path, leaf.shape)
    # and the analytic bytes, from the same shapes
    meta = [torch.empty(leaf.shape, dtype=getattr(torch, str(leaf.dtype)),
                        device="meta") for _, leaf in leaves]
    assert zero1.zero1_bytes(meta, hdp) == jzero1.zero1_bytes(abstract, rt)


def test_reduced_config_shards_every_divisible_leaf():
    """hdp = 4 on the reduced config: the stacked leaves (2 periods) shard
    on dim 1, the 1-D norm scales of 64 on dim 0, the embedding on dim 0."""
    cfg = get_config("llama3.2-3b").reduced()
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, device="cpu")
    assert zero1.zero1_dim(params["embed"].shape, 4) == 0
    assert zero1.zero1_dim(params["final_norm"]["scale"].shape, 4) == 0
    assert zero1.zero1_dim(params["blocks"][0]["mlp"]["w_in"].shape, 4) == 1


def test_state_holds_this_ranks_shard_only(results):
    """Every rank's master (and m, v, made alike) is the `zero1_dim` shard
    of its leaf at hdp = 4."""
    _, ranks, _ = results
    full = {k: ranks[0][f"ref/p0/{k}"].shape
            for k in _leaf_keys(ranks[0], "ref/p0/")}
    for rk in ranks:
        got = dict(s.split(":") for s in rk["state_shapes"].tolist())
        assert sorted(got) == sorted(full)
        for key, shape in full.items():
            dim = zero1.zero1_dim(shape, W.R)
            want = shape if dim is None else zero1.shard_shape(shape, dim,
                                                               W.R)
            assert got[key] == str(tuple(want)), key


def _ulp_bf16(x):
    """One bf16 unit in the last place at the magnitude of ``x``."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", W.APPLY_DTYPES)
def test_sharded_apply_equals_the_unsharded_apply(results, dtype):
    _, ranks, _ = results
    out = f"apply/{dtype}"
    full = ranks[0]
    keys = _leaf_keys(full, f"{out}/full/params/")
    assert len(keys) > 5
    for r, rk in enumerate(ranks):
        for key in keys:
            got = rk[f"{out}/sharded/params/{key}"]
            want = full[f"{out}/full/params/{key}"]
            if dtype == "float32":
                np.testing.assert_allclose(got, want, atol=APPLY_TOL,
                                           rtol=APPLY_TOL,
                                           err_msg=f"rank {r} {key}")
            else:
                hold = np.maximum(_ulp_bf16(want), APPLY_TOL)
                assert np.all(np.abs(got - want) <= hold), \
                    (r, key, np.abs(got - want).max())
            for k in ("master", "m", "v"):
                np.testing.assert_allclose(
                    rk[f"{out}/sharded/{k}/{key}"], full[f"{out}/full/{k}/{key}"],
                    atol=APPLY_TOL, rtol=APPLY_TOL, err_msg=f"rank {r} {k} {key}")
        np.testing.assert_allclose(rk[f"{out}/sharded/om"], full[f"{out}/full/om"],
                                   rtol=1e-5, err_msg=str(rk[f"{out}/om_keys"]))


# ---------------------------------------------------------------------------
# (c) guard, plan check, planner thread
# ---------------------------------------------------------------------------

def test_guarded_skip_is_bit_exact_on_every_rank(results):
    _, ranks, _ = results
    for r, rk in enumerate(ranks):
        assert int(rk["guard/applied"]) == 0, r
        assert int(rk["guard/nonfinite"]) > 0, r
        assert bool(rk["guard/unchanged"]), r
        assert int(rk["guard/next_applied"]) == 1, r
        assert np.isfinite(float(rk["guard/next_loss"])), r


def test_mismatched_plans_raise_on_every_rank(results):
    _, ranks, _ = results
    for r, rk in enumerate(ranks):
        assert "planned different steps" in str(rk["mismatch/error"]), r


def test_async_planning_gives_the_sync_history(results):
    _, ranks, _ = results
    for r, rk in enumerate(ranks):
        sync = np.stack([rk["ref/loss"], rk["ref/grad_norm"],
                         rk["ref/waves"]], axis=1)[:2]
        np.testing.assert_array_equal(rk["async/hist"], sync,
                                      err_msg=f"rank {r}")
        assert "item 9" in str(rk["async/calibrate_refused"]), r


# ---------------------------------------------------------------------------
# (d) the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_two_gloo_ranks(results):
    *_, stdout = results
    steps = [ln for ln in stdout.splitlines() if ln.startswith("step")]
    rec = json.loads([ln for ln in stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert len(steps) == 2 and rec["mesh"] == "2x1"
    assert [s["step"] for s in rec["steps"]] == [1, 2]
    assert all(np.isfinite(s["loss"]) and s["tokens"] > 0
               for s in rec["steps"])
    assert rec["zero1_bytes"]["zero1_param_gather"] > 0


def test_launcher_checkpoints_and_resumes_at_another_mesh(results, out_dir,
                                                         capsys):
    """The 2x1 run's checkpoint (its summary: not resumed, the gather,
    write and bytes of the save) resumes at 1x1 to train step 3."""
    *_, stdout = results
    rec = json.loads([ln for ln in stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert rec["resumed_at"] is None
    assert rec["ckpt"]["bytes"] > 0 and rec["ckpt"]["gather_s"] > 0
    assert rec["ckpt"]["gathered_bytes"] > 0 and rec["host_peak_rss_gb"] > 0
    args = LAUNCH_ARGS[:LAUNCH_ARGS.index("--steps")] + [
        "--steps", "3", *LAUNCH_ARGS[LAUNCH_ARGS.index("--steps") + 2:],
        "--mesh", "1x1", "--ckpt-dir", str(out_dir / LAUNCH_CKPT)]
    tr = launch_train.main(args)
    out = capsys.readouterr().out
    assert "resumed at step 2" in out
    assert [r["step"] for r in tr.history] == [3]
    assert np.isfinite(tr.history[0]["loss"])
    assert sorted(tr.ckpt.steps()) == [2, 3]


def test_launcher_refuses_tensor_parallelism():
    """``--mesh NxM`` trains the attention decoders and RWKV-6, with
    stages and offload too (`tests/test_torch_tp.py`,
    `tests/test_torch_ep.py`, `tests/test_torch_grid.py`,
    `tests/test_torch_rwkv_tp.py`); what tensor parallelism does not run
    raises before any rank starts: an expert count the model ranks do not
    divide (`ValueError`) and tensor-parallel serving (queue 1 item
    7b-iii)."""
    with pytest.raises(ValueError, match="do not split over"):
        launch_train.main(["--arch", "mistral-8x7b", "--reduced", "--mesh",
                           "1x8", "--device", "cpu"])
    from repro_torch.launch import profile_serve
    with pytest.raises(NotImplementedError, match="item 7b"):
        profile_serve.main(["--reduced", "--mesh", "2x2", "--device", "cpu"])
    with pytest.raises(ValueError, match="NxM"):
        launch_train.main(["--arch", "llama3.2-3b", "--mesh", "four"])


# ---------------------------------------------------------------------------
# (e) checkpoints across HDP sizes
# ---------------------------------------------------------------------------

def _file(out_dir, name, step=2):
    with np.load(out_dir / name / f"step_{step}" / "arrays.npz") as f:
        return {k: f[k] for k in f.files}


def _state_keys(rk, run):
    return _leaf_keys(rk, f"ckpt/{run}/state/master/")


def test_hdp4_checkpoint_holds_the_state_whole(results, out_dir):
    """Rank 0 wrote the file; its master, m and v are exactly the four
    ranks' shards put together on `zero1_dim`, its parameters those of
    the same two steps in the "ref" run, and the periodic saves wrote
    steps 1 and 2."""
    _, ranks, _ = results
    assert sorted(os.listdir(out_dir / "ckpt4")) == ["step_1", "step_2"]
    f = _file(out_dir, "ckpt4")
    keys = _state_keys(ranks[0], "h4")
    assert len(keys) > 5 and f["opt/step"] == 2
    sharded = 0
    for key in keys:
        full = f[f"params/{key}"]
        np.testing.assert_array_equal(full, ranks[0][f"ref/p2/{key}"],
                                      err_msg=key)
        dim = zero1.zero1_dim(full.shape, W.R)
        for k in ("master", "m", "v"):
            parts = [rk[f"ckpt/h4/state/{k}/{key}"] for rk in ranks]
            want = parts[0] if dim is None else np.concatenate(parts, dim)
            np.testing.assert_array_equal(f[f"opt/{k}/{key}"], want,
                                          err_msg=f"{k} {key}")
        sharded += (dim is not None) * full.size * 4 * 3
    assert float(ranks[0]["ckpt/h4/gathered_bytes"]) == sharded > 0
    assert all(int(rk["ckpt/h4/last_ckpt_step"]) == 2 for rk in ranks)


# (checkpoint, ranks that resumed it, their HDP size)
RESUMES = {"h2": ("ckpt4", (0, 1), 2), "h1": ("ckpt4", (2,), 1),
           "h4_from_h1": ("ckpt1", (0, 1, 2, 3), 4)}


@pytest.mark.parametrize("run", W.CKPT_RUNS)
def test_each_rank_restores_its_slice_of_the_file(results, out_dir, run):
    _, ranks, _ = results
    name, who, hdp = RESUMES[run]
    f = _file(out_dir, name)
    for r in who:
        rk = ranks[r]
        rank = who.index(r)
        assert int(rk[f"ckpt/{run}/resumed_at"]) == 2
        assert int(rk[f"ckpt/{run}/opt_step"]) == 2
        keys = _state_keys(rk, run)
        assert len(keys) > 5
        for key in keys:
            full = f[f"params/{key}"]
            dim = zero1.zero1_dim(full.shape, hdp)
            for k in ("master", "m", "v"):
                want = f[f"opt/{k}/{key}"]
                if dim is not None:
                    n = full.shape[dim] // hdp
                    want = np.take(want, range(rank * n, (rank + 1) * n),
                                   axis=dim)
                np.testing.assert_array_equal(
                    rk[f"ckpt/{run}/state/{k}/{key}"], want,
                    err_msg=f"rank {r} {k} {key}")


@pytest.mark.parametrize("run", W.CKPT_RUNS)
def test_resumed_step_matches_the_reference_resuming_the_file(
        results, out_dir, run):
    ref, ranks, _ = results
    name, who, _ = RESUMES[run]
    f = _file(out_dir, name)
    assert int(ref[f"ckpt/{run}/resumed_at"]) == 2
    for r in who:
        rk = ranks[r]
        assert int(rk[f"ckpt/{run}/waves"]) == int(ref[f"ckpt/{run}/waves"])
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(rk[f"ckpt/{run}/{k}"]),
                                       float(ref[f"ckpt/{run}/{k}"]),
                                       rtol=F32_TOL, err_msg=f"{r} {k}")
        keys = _leaf_keys(rk, f"ckpt/{run}/after/")
        assert len(keys) > 5 and keys == _leaf_keys(ref, f"ckpt/{run}/after/")
        for key in keys:
            base = f[f"params/{key}"]
            got = rk[f"ckpt/{run}/after/{key}"] - base
            want = ref[f"ckpt/{run}/after/{key}"] - base
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= UPDATE_TOL, (r, key, rel)


def test_ranks_restoring_different_steps_all_raise(results):
    _, ranks, _ = results
    for r, rk in enumerate(ranks):
        err = str(rk["ckpt/planted/error"])
        assert "restored different checkpoints" in err, r
        assert "[2, 1, 2, 2]" in err, (r, err)


# ---------------------------------------------------------------------------
# on the card: HostStagedComm, processes sharing one device
# ---------------------------------------------------------------------------

def _staged_rank(rank: int, store: str, out: str) -> None:
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel.comm import HostStagedComm
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        comm = HostStagedComm()
        dev = comm.device
        x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
        got = {"reduce_scatter": comm.reduce_scatter(x),
               "all_reduce": comm.all_reduce(x.clone()),
               "broadcast": comm.broadcast(x.clone()),
               "all_gather": comm.all_gather(x[:2])}
        gathered = torch.empty(4, device=dev)
        comm.all_gather_into(gathered, x[:2].contiguous())
        got["all_gather_into"] = gathered
        (got["ppermute"],) = comm.ppermute([x], [(0, 1), (1, 0)])
        assert all(v.device == dev for v in got.values())
        torch.save({k: v.cpu() for k, v in got.items()},
                   f"{out}/staged{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_host_staged_comm_moves_cuda_tensors(tmp_path):
    """Two processes on one card: every collective of `HostStagedComm`
    takes and returns CUDA tensors with gloo's results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.multiprocessing as mp
    mp.start_processes(_staged_rank, args=(str(tmp_path / "store"),
                                           str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    x = [torch.arange(8, dtype=torch.float32) + 10 * r for r in range(2)]
    for r in range(2):
        got = torch.load(tmp_path / f"staged{r}.pt")
        total = x[0] + x[1]
        torch.testing.assert_close(got["reduce_scatter"],
                                   total[4 * r:4 * r + 4])
        torch.testing.assert_close(got["all_reduce"], total)
        torch.testing.assert_close(got["broadcast"], x[0])
        torch.testing.assert_close(got["all_gather"],
                                   torch.stack([x[0][:2], x[1][:2]]))
        torch.testing.assert_close(got["all_gather_into"],
                                   torch.cat([x[0][:2], x[1][:2]]))
        torch.testing.assert_close(got["ppermute"], x[1 - r])
