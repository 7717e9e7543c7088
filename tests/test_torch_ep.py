"""The port's expert parallelism and the tensor-parallel rules of the MoE,
MLA and Gemma-style decoders against the reference's ``"model"`` mesh
axis, reduced configs in float32.

The port has one MoE route at tp > 1, the reference's expert-parallel
``moe_impl="manual"``; the reference's other route, ``"gather"``,
computes the same function, and each case that runs the MoE holds the
port against both.

* (a) The reference's `Trainer` on a (2, 2) mesh of 4 host devices,
  reduced Mistral-8x7B (4 experts, top-2, 4/2 heads), 2 steps at
  ``moe_impl`` "manual" and "gather"; against each the port's 2 x 2 grid
  of gloo ranks (`_torch_ep_worker.py`) from the reference's initial
  weights: plan fingerprints equal; wave losses,
  step losses and grad norms within 1e-4 relative; every step's update
  of every rank's slices within 1e-3 relative L2 per leaf; the
  replicated leaves bit-identical across each model group; every MoE
  call's top-k indices identical across the model group.
* (b) The reference's `loss_fn` on a (1, 2) mesh for reduced
  deepseek-v2-lite-16b (MLA, a shared expert, a dense head layer),
  qwen3-moe-30b-a3b (q/k norms), gemma2-9b (local layers, softcaps,
  post-block norms, the embedding scale) and gemma3-12b (the 5:1 pattern,
  q/k norms), and on (1, 4) for qwen3-moe-30b-a3b with KV replicated; the
  norm scales perturbed off zero.  Against it the port's `ThreadRanks`:
  the loss within 1e-4, every rank's gradient slices
  within 1e-4 relative L2, the replicated leaves' gradients bit-identical
  across the model group.
* (c) `models/moe.py` against the reference's `_moe_block` in both
  routes (`moe_forward_manual`, and ``"gather"``'s `moe_forward` over
  each HDP rank's rows) on a (2, 2) mesh at capacity factor 0.5 (every
  expert drops pairs), with and without a shared expert:
  output and gradients within 1e-5 in float32 (element-wise) and 2e-2 in
  bf16 (relative L2: where the routed and shared parts of y cancel, one
  bf16 ulp of either is more than 2e-2 of the sum).
* (d) The 2 x 2 run's checkpoint holds the expert leaves at their
  global [n_periods, E, d, f] shape, every rank's slices and ZeRO-1
  shards.
* (e) ``launch/train.py --arch mistral-8x7b --reduced --mesh 2x2`` on 4
  gloo ranks.
* (g) An expert or MLA head count that tp does not divide raises
  `ValueError`.

The three reference processes, the gloo ranks and the launcher start
together when the module starts, beside the in-process cases.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ep_worker as E
import _torch_tp_worker as W
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.loss import token_ce_loss
from repro_torch.data.distribution import LengthDistribution
from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.layers import gqa_layout
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import zero1
from repro_torch.parallel.comm import ThreadRanks
from repro_torch.parallel.sharding import Runtime, shard_param, tp_split_dim
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4                  # tests/test_torch_tp.py
UPDATE_TOL = 1e-3
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:41
LAUNCH_ARGS = ["--arch", "mistral-8x7b", "--reduced", "--steps", "2",
               "--capacity", "256", "--tokens-per-step", "512",
               "--context", "256", "--dataset", "tiny", "--device", "cpu",
               "--attn-impl", "ref", "--mesh", "2x2"]
TIMEOUT = 600

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from repro import compat
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config
from repro.data.distribution import LengthDistribution
from repro.data.loader import GlobalScheduler, SyntheticDataset
from repro.models import transformer as JT
from repro.obs.numerics import plan_fingerprint
from repro.optim.adamw import AdamWConfig
from repro.parallel.sharding import Runtime
from repro.train.train_step import loss_fn
from repro.train.trainer import Trainer, TrainerConfig
sys.path.insert(0, "tests")
import _torch_ep_worker as E
import _torch_tp_worker as W

out, part = sys.argv[1], sys.argv[2]

def config(arch, dtype="float32", **moe):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg

def mesh(hdp, tp, **kw):
    m = compat.make_mesh((hdp, tp), ("data", "model"),
                         axis_types=compat.auto_axis_types(2))
    compat.set_mesh(m)
    return Runtime(mesh=m, hdp_axes=("data",), model_axis="model", **kw)

def save(name, res):
    np.savez(f"{out}/{name}.tmp.npz",
             **{k: np.asarray(v) for k, v in res.items()})
    os.replace(f"{out}/{name}.tmp.npz", f"{out}/{name}.npz")

def history(impl):
    # (a) the Trainer on a (2, 2) mesh at moe_impl; "manual" writes the
    # initial weights first, which the port's ranks start from
    cfg = config(E.ARCH)
    ds = SyntheticDataset(LengthDistribution(*W.DIST), cfg.vocab_size,
                          tokens_per_step=W.TOKENS, context=W.CONTEXT)
    sched = GlobalScheduler(ds, cfg, capacity=W.CAP, hdp=E.HDP,
                            use_offload=False)
    plans = []
    plan_step = sched.plan_step
    def recorded(step):
        plan = plan_step(step)
        plans.append(plan_fingerprint(plan))
        return plan
    sched.plan_step = recorded
    tr = Trainer(cfg, mesh(E.HDP, E.TP, moe_impl=impl),
                 AdamWConfig(lr=W.LR, total_steps=W.TOTAL_STEPS), sched,
                 TrainerConfig(capacity=W.CAP, attn_impl="ref",
                               calibrate=False))
    if impl == "manual":
        save("jax_params", _flatten(tr.params))
    res, waves = {}, []
    observe_wave = tr.numerics.observe_wave
    def observe(step, i, loss):
        waves.append((step, float(loss)))
        return observe_wave(step, i, loss)
    tr.numerics.observe_wave = observe
    for s in range(E.STEPS):
        rec = tr.train_step()
        for k in ("loss", "grad_norm", "waves"):
            res.setdefault(k, []).append(rec[k])
        res[f"wave_losses/{s}"] = [l for st, l in waves if st == s]
        for key, v in _flatten(tr.params).items():
            res[f"p{s + 1}/{key}"] = v
    tr.sched.stop()
    res["fp"] = np.array(plans)
    save(f"jax_{impl}", res)

def losses():
    # (b) loss_fn and its grads, norm scales perturbed off zero
    res = {}
    for i, (arch, tp) in enumerate(E.LOSS_CASES):
        cfg = config(arch)
        rt = mesh(1, tp)
        p = JT.init_params(jax.random.PRNGKey(i), cfg, rt)
        rng = np.random.RandomState(i)
        p = jax.tree_util.tree_map_with_path(
            lambda path, x: x + jnp.asarray(0.1 * rng.randn(*x.shape),
                                            x.dtype)
            if "norm" in jax.tree_util.keystr(path) else x, p)
        tag = f"{arch}/{tp}"
        for key, v in _flatten(p).items():
            res[f"{tag}/p/{key}"] = v
        batch = {k: jnp.asarray(v)
                 for k, v in W.wave(cfg.vocab_size).items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda q: loss_fn(q, cfg, rt, batch)[0]))(p)
        res[f"{tag}/loss"] = float(loss)
        for key, v in _flatten(grads).items():
            res[f"{tag}/g/{key}"] = v
    save("jax_b", res)

def moe_module():
    # (c) _moe_block on a (2, 2) mesh in both routes
    res = {}
    for impl, arch in [(i, a) for i in E.REF_IMPLS for a in E.MOE_ARCHS]:
        rt = mesh(E.HDP, E.TP, moe_impl=impl)
        for dtype in ("float32", "bfloat16"):
            cfg = config(arch, dtype, capacity_factor=E.MOE_CF)
            inp = E.moe_inputs(cfg)
            dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
            p = {k: jnp.asarray(v, jnp.float32 if k == "router" else dt)
                 for k, v in inp["params"].items()}
            x = jnp.asarray(inp["x"], dt)
            dy = jnp.asarray(inp["dy"])
            def f(p, x):
                y = JT._moe_block(p, cfg, rt, x)
                return jnp.sum(y.astype(jnp.float32) * dy), y
            (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
            tag = f"{impl}/{arch}/{dtype}"
            res[f"{tag}/y"] = np.asarray(y.astype(jnp.float32))
            res[f"{tag}/gx"] = np.asarray(gx.astype(jnp.float32))
            for k, v in gp.items():
                res[f"{tag}/g/{k}"] = np.asarray(v.astype(jnp.float32))
    save("jax_c", res)

if part == "losses":
    losses()
else:
    history(part)
    if part == "manual":
        moe_module()
"""


# ---------------------------------------------------------------------------
# the subprocesses, started when the module starts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ep")


@pytest.fixture(scope="module", autouse=True)
def procs(out_dir):
    """Start the reference three times (4 host devices each: the
    "manual" run and the module case; the "gather" run; the loss cases),
    the port (2 x 2 gloo ranks) and the launcher together; kill what is
    left at the end of the module."""
    env = subprocess_env(PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
                         JAX_PLATFORMS="cpu")
    started = {}
    for part, cmd in (
            ("jax_manual", [sys.executable, "-c", JAX_SCRIPT, str(out_dir),
                            "manual"]),
            ("jax_gather", [sys.executable, "-c", JAX_SCRIPT, str(out_dir),
                            "gather"]),
            ("jax_losses", [sys.executable, "-c", JAX_SCRIPT, str(out_dir),
                            "losses"]),
            ("torch", [sys.executable,
                       str(ROOT / "tests" / "_torch_ep_worker.py"),
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


def _finished(procs, out_dir, parts):
    try:
        for part in parts:
            procs[part].wait(timeout=TIMEOUT)
    finally:
        for part in parts:
            if procs[part].poll() is None:
                procs[part].kill()
                procs[part].wait()
    for part in parts:
        assert procs[part].returncode == 0, (
            part, (out_dir / f"{part}.log").read_text()[-2000:],
            (out_dir / f"{part}.err").read_text()[-4000:])


@pytest.fixture(scope="module")
def results(procs, out_dir):
    """-> ({impl: the reference's history}, per-rank port results), once
    both reference runs and the gloo ranks have ended."""
    _finished(procs, out_dir, ("jax_manual", "jax_gather", "torch"))
    ref = {impl: dict(np.load(out_dir / f"jax_{impl}.npz"))
           for impl in E.REF_IMPLS}
    ranks = [dict(np.load(out_dir / f"torch_rank{r}.npz"))
             for r in range(E.R)]
    return ref, ranks


def _ref(procs, out_dir, part, name):
    _finished(procs, out_dir, (part,))
    return dict(np.load(out_dir / f"{name}.npz"))


def _keys(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


def _split(cfg, key: str, arr: np.ndarray, tp: int):
    """A flat key's split dimension in ``cfg``'s layout at ``tp``."""
    kvs = gqa_layout(cfg.num_heads, cfg.num_kv_heads, tp).kv_sharded
    return tp_split_dim(key.split("/"), arr.ndim, kvs)


def _slice(arr: np.ndarray, dim, m: int, tp: int) -> np.ndarray:
    return arr if dim is None else \
        shard_param(torch.from_numpy(np.ascontiguousarray(arr)), dim, m,
                    tp).numpy()


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------------------
# (a) two steps on a 2 x 2 grid against the reference's Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", E.REF_IMPLS)
def test_plan_fingerprints_agree_on_every_rank_and_the_reference(results,
                                                                 impl):
    ref, ranks = results
    want = ref[impl]["fp"].tolist()
    assert len(want) == E.STEPS and len(set(want)) == E.STEPS
    for r, rk in enumerate(ranks):
        assert (int(rk["hdp_rank"]), int(rk["model_rank"])) == divmod(r, 2)
        assert rk["fp"].tolist() == want


@pytest.mark.parametrize("impl", E.REF_IMPLS)
def test_losses_and_grad_norms_match_the_reference(results, impl):
    ref, ranks = results
    ref = ref[impl]
    for rk in ranks:
        assert rk["waves"].tolist() == ref["waves"].tolist()
        assert rk["applied"].tolist() == [1] * E.STEPS
        for s in range(E.STEPS):
            np.testing.assert_allclose(rk[f"wave_losses/{s}"],
                                       ref[f"wave_losses/{s}"], rtol=F32_TOL)
        np.testing.assert_allclose(rk["loss"], ref["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(rk["grad_norm"], ref["grad_norm"],
                                   rtol=F32_TOL)


@pytest.mark.parametrize("impl", E.REF_IMPLS)
def test_parameter_updates_match_the_reference(results, out_dir, impl):
    """Every rank's update of each of its slices (its experts among them)
    within 1e-3 relative L2 of the same slice of the reference's."""
    ref, ranks = results
    ref = ref[impl]
    cfg = E.config()
    p0 = dict(np.load(out_dir / "jax_params.npz"))
    keys = _keys(ranks[0], "p0/")
    assert "blocks/0/moe/w_in" in keys and keys == _keys(ref, "p1/")
    for rk in ranks:
        m = int(rk["model_rank"])
        for s in range(E.STEPS):
            for key in keys:
                before = p0[key] if s == 0 else ref[f"p{s}/{key}"]
                dim = _split(cfg, key, before, E.TP)
                got = rk[f"p{s + 1}/{key}"] - rk[f"p{s}/{key}"]
                want = _slice(ref[f"p{s + 1}/{key}"] - before, dim, m, E.TP)
                assert _rel(got, want) <= UPDATE_TOL, (m, s, key)


def test_replicas_hold_the_same_values(results):
    """The replicated leaves (the router among them) bit-identical across
    each model group, every slice across the HDP ranks that hold it."""
    _, ranks = results
    cfg = E.config()
    for s in range(E.STEPS + 1):
        for key in _keys(ranks[0], f"p{s}/"):
            arr = ranks[0][f"p{s}/{key}"]
            split = _split(cfg, key, arr, E.TP)
            for r in range(E.R):
                got = ranks[r][f"p{s}/{key}"]
                if split is None:
                    np.testing.assert_array_equal(got, arr, err_msg=key)
                np.testing.assert_array_equal(
                    got, ranks[r % E.TP][f"p{s}/{key}"], err_msg=key)


def test_model_group_routes_alike(results):
    """Every MoE call's top-k indices identical across the model group
    (forward and recompute)."""
    _, ranks = results
    for rk in ranks:
        assert int(rk["topk_calls"]) > 0
        assert bool(rk["topk_same"])


# ---------------------------------------------------------------------------
# (d) the 2 x 2 checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_holds_global_expert_leaves(results, out_dir):
    """The file's parameters are the global leaves after the last step,
    the experts at [n_periods, E, d, f]; each rank's master, m and v are
    its ZeRO-1 shard (over its HDP group, the split dimension taken) of
    its model slice of the file's."""
    _, ranks = results
    cfg = E.config()
    with np.load(out_dir / E.CKPT / f"step_{E.STEPS}" / "arrays.npz") as f:
        f = {k: f[k] for k in f.files}
    spec = cfg.moe
    n = cfg.num_layers // len(cfg.layer_pattern)
    assert f["params/blocks/0/moe/w_in"].shape == (
        n, spec.num_experts, cfg.d_model, spec.d_expert)
    assert f["params/blocks/0/moe/w_out"].shape == (
        n, spec.num_experts, spec.d_expert, cfg.d_model)
    sharded = 0
    for key in _keys(ranks[0], "p0/"):
        full = f[f"params/{key}"]
        dim = _split(cfg, key, full, E.TP)
        parts = [ranks[m][f"p{E.STEPS}/{key}"] for m in range(E.TP)]
        whole = parts[0] if dim is None else np.concatenate(parts, dim)
        np.testing.assert_array_equal(full, whole, err_msg=key)
        for rk in ranks:
            h, m = int(rk["hdp_rank"]), int(rk["model_rank"])
            mine = _slice(full, dim, m, E.TP)
            zd = zero1.zero1_dim(mine.shape, E.HDP,
                                 () if dim is None else (dim,))
            sharded += zd is not None and "moe/w_" in key
            for k in ("master", "m", "v"):
                want = _slice(f[f"opt/{k}/{key}"], dim, m, E.TP)
                if zd is not None:
                    want = _slice(want, zd, h, E.HDP)
                np.testing.assert_array_equal(rk[f"ckpt/state/{k}/{key}"],
                                              want, err_msg=f"{k} {key}")
    assert sharded > 0


# ---------------------------------------------------------------------------
# (b) loss and gradient slices against loss_fn at tp 2 and 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,tp", E.LOSS_CASES)
def test_loss_and_gradient_slices_match_the_reference(procs, out_dir, arch,
                                                      tp):
    ref = _ref(procs, out_dir, "jax_losses", "jax_b")
    tag = f"{arch}/{tp}"
    cfg = E.config(arch)
    flat = {k[len(tag) + 3:]: v for k, v in ref.items()
            if k.startswith(f"{tag}/p/")}
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in W.wave(cfg.vocab_size).items()}
    assert cfg.qk_norm or cfg.mla is not None or cfg.post_block_norm

    def rank(comm):
        params = bridge.params_from_flat(flat, cfg, "cpu",
                                         model=(comm.rank, tp))
        rt = Runtime(device="cpu", attn_impl="ref", tp_comm=comm)
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        h = T.forward_hidden(live, cfg, rt, batch)
        loss, _ = token_ce_loss(live, cfg, rt, h, batch["labels"],
                                batch["seg"], batch["denom"])
        grads = torch.autograd.grad(loss, leaves(live))
        it = iter(grads)
        return loss.item(), bridge.params_to_flat(
            tree_map(lambda _: next(it), live))

    keys = _keys(ref, f"{tag}/g/")
    got = ThreadRanks(tp).run(rank)
    for m, (loss, grads) in enumerate(got):
        np.testing.assert_allclose(loss, float(ref[f"{tag}/loss"]),
                                   rtol=F32_TOL)
        assert sorted(grads) == keys
        for key in keys:
            full = ref[f"{tag}/g/{key}"]
            want = _slice(full, _split(cfg, key, full, tp), m, tp)
            assert _rel(grads[key], want) <= F32_TOL, (m, key)
    for key in keys:
        if _split(cfg, key, ref[f"{tag}/g/{key}"], tp) is None:
            for _, g in got[1:]:
                np.testing.assert_array_equal(g[key], got[0][1][key],
                                              err_msg=key)


# ---------------------------------------------------------------------------
# (c) the module against the reference's _moe_block on a (2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", E.REF_IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", E.MOE_ARCHS)
def test_moe_forward_matches_the_reference_routes(procs, out_dir, arch,
                                                  dtype, impl):
    """Each HDP half of the rows on its own model group of 2
    (`ThreadRanks`): the output rows and the input gradient on every
    model rank, and the parameter gradients summed over the HDP halves,
    against the reference's route ``impl``; pairs dropped on every
    rank."""
    ref = _ref(procs, out_dir, "jax_manual", "jax_c")
    tag = f"{impl}/{arch}/{dtype}"
    cfg = E.config(arch, dtype, capacity_factor=E.MOE_CF)
    inp = E.moe_inputs(cfg)
    tdt = getattr(torch, dtype)
    full = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                      else tdt)
            for k, v in inp["params"].items()}
    c = E.MOE_ROWS // E.HDP
    tol = MOE_TOL[dtype]
    spec = cfg.moe
    assert M.moe_capacity(spec, c) < c * spec.top_k // spec.num_experts

    def rank(comm, h):
        p = {k: shard_param(v, tp_split_dim(("moe", k), v.dim(), True),
                            comm.rank, E.TP).clone().requires_grad_(True)
             for k, v in full.items()}
        x = torch.from_numpy(inp["x"][h * c:(h + 1) * c]).to(tdt) \
            .requires_grad_(True)
        y = M.moe_forward(p, cfg, x, comm)
        dy = torch.from_numpy(inp["dy"][h * c:(h + 1) * c])
        grads = torch.autograd.grad((y.float() * dy).sum(), [x, *p.values()])
        return y.detach().float().numpy(), [g.float().numpy() for g in grads]

    halves = [ThreadRanks(E.TP).run(lambda comm: rank(comm, h))
              for h in range(E.HDP)]
    for m in range(E.TP):
        y = np.concatenate([halves[h][m][0] for h in range(E.HDP)])
        gx = np.concatenate([halves[h][m][1][0] for h in range(E.HDP)])
        held = [("y", y, ref[f"{tag}/y"]), ("x", gx, ref[f"{tag}/gx"])]
        for i, k in enumerate(full):
            got = sum(halves[h][m][1][i + 1] for h in range(E.HDP))
            held.append((k, got, _slice(
                ref[f"{tag}/g/{k}"],
                tp_split_dim(("moe", k), full[k].dim(), True), m, E.TP)))
        for k, got, want in held:
            if dtype == "float32":
                np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                           err_msg=k)
            else:            # bf16 cancels in y: held in relative L2
                assert _rel(got, want) <= tol, (m, k)
    for h in range(E.HDP):          # the router's gradient: one value
        np.testing.assert_array_equal(halves[h][0][1][1], halves[h][1][1][1])


# ---------------------------------------------------------------------------
# (e) the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_a_2x2_mesh_expert_parallel(procs, out_dir):
    _finished(procs, out_dir, ("launch",))
    stdout = (out_dir / "launch.log").read_text()
    steps = [ln for ln in stdout.splitlines() if ln.startswith("step")]
    rec = json.loads([ln for ln in stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert len(steps) == 2 and rec["mesh"] == "2x2"
    assert rec["arch"] == "mistral-8x7b"
    assert [s["step"] for s in rec["steps"]] == [1, 2]
    assert all(np.isfinite(s["loss"]) and s["tokens"] > 0
               for s in rec["steps"])


# ---------------------------------------------------------------------------
# (f), (g): the wave runtime and what raises
# ---------------------------------------------------------------------------

def test_wave_runtime_keeps_the_runtime_fields():
    cfg = E.config()
    for offload in (False, True):
        ds = SyntheticDataset(LengthDistribution(*W.DIST), cfg.vocab_size,
                              tokens_per_step=512, context=256)
        sched = GlobalScheduler(ds, cfg, capacity=256, hdp=1,
                                use_offload=offload)
        tr = Trainer(cfg, Runtime(device="cpu"), AdamWConfig(), sched,
                     TrainerConfig(capacity=256, calibrate=False,
                                   attn_impl="ref", use_offload=offload))
        try:
            rt = tr._wave_rt((1,), 0.5)
            assert rt.attn_impl == "ref" and rt.device == tr.rt.device
            assert rt.remat == ("offload" if offload else "full")
        finally:
            tr.sched.stop()


def test_counts_tp_does_not_divide_raise():
    for arch in ("mistral-8x7b", "qwen3-moe-30b-a3b"):
        with pytest.raises(ValueError, match="4 experts"):
            T.check_supported(get_config(arch).reduced(), 8)
        T.check_supported(get_config(arch).reduced(), 4)
    mla = get_config("deepseek-v2-lite-16b").reduced()
    mla = dataclasses.replace(mla, moe=dataclasses.replace(mla.moe,
                                                           num_experts=8))
    with pytest.raises(ValueError, match="4 MLA heads"):
        T.check_supported(mla, 8)
    with pytest.raises(ValueError, match="4 experts"):
        launch_train.main(["--arch", "mistral-8x7b", "--reduced", "--mesh",
                           "1x8", "--device", "cpu"])
