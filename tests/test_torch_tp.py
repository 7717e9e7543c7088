"""The port's tensor parallelism (the dense decoders) against the
reference's ``"model"`` mesh axis.

* (a) The reference's `Trainer` on a (2, 2) mesh of 4 host devices
  (reduced llama3.2-3b in float32: 4 heads, 2 KV heads, vocab 512, so tp
  2 shards KV) and the port's on a 2 x 2 grid of gloo ranks
  (`_torch_tp_worker.py`), 3 steps from the reference's initial weights
  at ``attn_impl`` "ref" and "flash" (the kernels' plain versions here):
  plan fingerprints equal on every rank and on the reference; wave
  losses, step losses and grad norms within 1e-4 relative; every step's
  update of every rank's slices within 1e-3 relative L2 per leaf of the
  same slices of the reference's; the replicated leaves bit-identical
  across each model group and the slices across each HDP group.
* (b) tp 4 x hdp 1, where KV is replicated (2 KV heads over 4 model
  ranks): the forward loss and every rank's gradients (its slices)
  against the reference's `loss_fn` on a (1, 4) mesh; the replicated
  ``w_kv``'s gradient is the same on every model rank.  The port's four
  ranks are `ThreadRanks(4)` here.
* (c) The split table (`tp_split_dim`) against the reference's
  `param_spec` / `params_pspecs`, and `zero1_dim` with the split taken
  against `zero1_spec`, leaf by leaf: reduced and full llama3.2-3b,
  LLaMA-7B, Mistral-8x7B, qwen3-moe-30b-a3b, deepseek-v2-lite-16b,
  gemma2-9b and gemma3-12b at tp 2, 4, 8 and hdp 2, 4 (shapes only; the
  MoE and MLA models where tp divides their experts and heads, a
  `ValueError` where it does not).  The MoE, MLA and Gemma models'
  parity at tp > 1 is `tests/test_torch_ep.py`'s.
* (d) The vocab-parallel cross-entropy against the reference's
  `token_ce_from_logits`, float32 (1e-4) and bf16 (3e-2), nll and
  dlogits, with labels at each shard's first and last column.
* (e) The 2 x 2 ``ref`` run's checkpoint of step 2: its file holds every
  rank's slices and ZeRO-1 shards; the 4 ranks as a 4 x 1 grid resume it
  and train step 3 against the reference resuming the same file at
  (4, 1); a file whose layout pads the heads otherwise is refused.
* (f) ``launch/train.py --mesh 2x2`` on 4 gloo ranks.

The reference, the gloo ranks and the launcher start together as three
subprocesses when the module starts, beside the in-process cases.
"""
import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_tp_worker as W
from repro.configs.registry import get_config as jax_config
from repro.core.loss import token_ce_from_logits as jax_ce
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.parallel import sharding as jsharding
from repro.parallel import zero1 as jzero1
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import MambaSpec
from repro_torch.configs.registry import get_config
from repro_torch.core.loss import token_ce_from_logits, token_ce_loss
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel import zero1
from repro_torch.parallel.comm import ThreadRanks
from repro_torch.parallel.sharding import (Runtime, shard_param,
                                           tp_split_dim, tp_splits)
from repro_torch.tree import leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4                  # tests/test_torch_train.py
UPDATE_TOL = 1e-3               # post-step update, relative L2 per leaf
CE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}     # tests/test_kernels.py:82
LAUNCH_ARGS = ["--arch", "llama3.2-3b", "--reduced", "--steps", "2",
               "--capacity", "256", "--tokens-per-step", "512",
               "--context", "256", "--dataset", "tiny", "--device", "cpu",
               "--attn-impl", "ref", "--mesh", "2x2"]
TIMEOUT = 600

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
from repro.obs.numerics import plan_fingerprint
from repro.optim.adamw import AdamWConfig
from repro.parallel.sharding import Runtime
from repro.train.train_step import loss_fn
from repro.train.trainer import Trainer, TrainerConfig
sys.path.insert(0, "tests")
import _torch_tp_worker as W

out = sys.argv[1]
cfg = dataclasses.replace(get_config(W.ARCH).reduced(), dtype="float32")

def mesh(hdp, tp):
    m = compat.make_mesh((hdp, tp), ("data", "model"),
                         axis_types=compat.auto_axis_types(2))
    compat.set_mesh(m)
    return Runtime(mesh=m, hdp_axes=("data",), model_axis="model")

def trainer(rt, hdp, **kw):
    ds = SyntheticDataset(LengthDistribution(*W.DIST), cfg.vocab_size,
                          tokens_per_step=W.TOKENS, context=W.CONTEXT)
    sched = GlobalScheduler(ds, cfg, capacity=W.CAP, hdp=hdp,
                            use_offload=False)
    plans = []
    plan_step = sched.plan_step
    def recorded(step):
        plan = plan_step(step)
        plans.append(plan_fingerprint(plan))
        return plan
    sched.plan_step = recorded
    tr = Trainer(cfg, rt, AdamWConfig(lr=W.LR, total_steps=W.TOTAL_STEPS),
                 sched, TrainerConfig(capacity=W.CAP, attn_impl="ref",
                                      calibrate=False, **kw))
    tr.plans = plans
    return tr

# (a) the Trainer on a (2, 2) mesh; its initial weights first
tr = trainer(mesh(W.HDP, W.TP), W.HDP)
p0 = jax.tree.map(lambda x: x.copy(), tr.params)   # kept for (b)
np.savez(out + "/jax_params.tmp.npz", **_flatten(p0))
os.replace(out + "/jax_params.tmp.npz", out + "/jax_params.npz")
res = {}
waves = []
observe_wave = tr.numerics.observe_wave
def observe(step, i, loss):
    waves.append((step, float(loss)))
    return observe_wave(step, i, loss)
tr.numerics.observe_wave = observe
for s in range(W.STEPS):
    rec = tr.train_step()
    for k in ("loss", "grad_norm", "waves"):
        res.setdefault(k, []).append(rec[k])
    res[f"wave_losses/{s}"] = [l for st, l in waves if st == s]
    for key, v in _flatten(tr.params).items():
        res[f"p{s + 1}/{key}"] = v
tr.sched.stop()
res["fp"] = np.array(tr.plans)

# (b) loss and grads on a (1, 4) mesh: KV replicated
rt14 = mesh(1, 4)
batch = {k: jax.numpy.asarray(v) for k, v in W.wave(cfg.vocab_size).items()}
loss, grads = jax.jit(jax.value_and_grad(
    lambda p: loss_fn(p, cfg, rt14, batch)[0]))(p0)
res["b/loss"] = float(loss)
for key, v in _flatten(grads).items():
    res[f"b/grad/{key}"] = v

# (e) the port's 2 x 2 checkpoint resumed at (4, 1), one step
ckpt = out + "/ckpt22"
t0 = time.monotonic()
while not os.path.exists(ckpt + f"/step_{W.CKPT_STEP}/manifest.json"):
    if time.monotonic() - t0 > 300:
        raise TimeoutError("the port's checkpoint did not appear")
    time.sleep(0.2)
tr = trainer(mesh(4, 1), 4, ckpt_dir=ckpt, ckpt_save=False)
assert tr.resume_if_possible()
res["h4/resumed_at"] = tr.step
rec = tr.train_step()
for k in ("loss", "grad_norm", "waves"):
    res[f"h4/{k}"] = rec[k]
for key, v in _flatten(tr.params).items():
    res[f"h4/after/{key}"] = v
tr.sched.stop()
np.savez(out + "/jax_tp.npz", **{k: np.asarray(v) for k, v in res.items()})
"""


# ---------------------------------------------------------------------------
# the subprocesses, started when the module starts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp")


@pytest.fixture(scope="module", autouse=True)
def procs(out_dir):
    """Start the reference (4 host devices), the port (2 x 2 gloo ranks)
    and the launcher (``--mesh 2x2``) together; kill what is left at the
    end of the module."""
    env = subprocess_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    started = {}
    for part, cmd in (
            ("jax", [sys.executable, "-c", JAX_SCRIPT, str(out_dir)]),
            ("torch", [sys.executable,
                       str(ROOT / "tests" / "_torch_tp_worker.py"),
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
    ref = dict(np.load(out_dir / "jax_tp.npz"))
    ranks = [dict(np.load(out_dir / f"torch_rank{r}.npz"))
             for r in range(W.R)]
    return ref, ranks, (out_dir / "launch.log").read_text()


def _cfgs():
    return (dataclasses.replace(jax_config(W.ARCH).reduced(),
                                dtype="float32"), W.config())


def _keys(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


def _split(key: str, arr: np.ndarray, tp: int = W.TP):
    """A flat key's split dimension in the reduced config's layout at
    ``tp``."""
    cfg = W.config()
    kvs = cfg.num_kv_heads % tp == 0
    return tp_split_dim(key.split("/"), arr.ndim, kvs)


def _slice(arr: np.ndarray, dim, m: int, tp: int = W.TP) -> np.ndarray:
    return arr if dim is None else \
        shard_param(torch.from_numpy(np.ascontiguousarray(arr)), dim, m,
                    tp).numpy()


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------------------
# (c) the split table and ZeRO-1 against the reference (shapes only)
# ---------------------------------------------------------------------------

def _jax_specs(name: str, tp: int):
    """-> (its abstract tree, [(path, global shape, dtype, the
    reference's PartitionSpec)]) of a config at ``tp``, from its init
    traced abstractly."""
    cfg = jax_config(name)
    rt = types.SimpleNamespace(
        layout=lambda c: JL.gqa_layout(c.num_heads, c.num_kv_heads, tp),
        model_axis="model", stage_axis=None, num_stages=1)
    abstract = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg, rt))
    specs = jsharding.params_pspecs(abstract, cfg, rt)
    flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    return abstract, [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                for k in path), leaf.shape, str(leaf.dtype),
                       spec)
                      for (path, leaf), spec in zip(flat, spec_leaves)]


SPLIT_MODELS = ["llama3.2-3b", "llama-7b", "mistral-8x7b",
                "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "gemma2-9b",
                "gemma3-12b"]


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("name", ["llama3.2-3b-reduced", *SPLIT_MODELS,
                                  *[f"{m}-reduced" for m in SPLIT_MODELS[2:]]])
def test_split_table_and_zero1_match_the_reference(name, tp):
    """Leaf by leaf: the dimension the port splits over the model group is
    the one `param_spec` puts ``model`` on, and the dimension ZeRO-1
    shards a rank's slice on (the split taken) is the one `zero1_spec`
    shards the global leaf on, at hdp 2 and 4; the ZeRO-1 bytes, priced
    on the global tree, are the reference Trainer's.  Where tp does not
    divide the experts or MLA's heads (the reduced MoE models' 4 at tp
    8), the port raises `ValueError` instead."""
    cfg = get_config(name)
    if (cfg.moe and cfg.moe.num_experts % tp) or \
            (cfg.mla and cfg.num_heads % tp):
        with pytest.raises(ValueError, match="do not split over"):
            T.check_supported(cfg, tp)
        return
    T.check_supported(cfg, tp)
    abstract, specs = _jax_specs(name, tp)
    kvs = JL.gqa_layout(cfg.num_heads, cfg.num_kv_heads, tp).kv_sharded
    assert len(specs) > 5
    split_any = 0
    for key, shape, _, spec in specs:
        want = next((i for i, e in enumerate(spec) if e == "model"), None)
        got = tp_split_dim(key.split("/"), len(shape), kvs)
        assert got == want, (key, shape, spec)
        split_any += got is not None
        local = list(shape)
        if got is not None:
            local[got] //= tp
        for hdp in (2, 4):
            rt = types.SimpleNamespace(hdp_size=hdp, hdp_axes=("data",))
            z = jzero1.zero1_spec(spec, shape, rt)
            zwant = next((i for i, e in enumerate(z) if e == "data"), None)
            taken = () if got is None else (got,)
            assert zero1.zero1_dim(local, hdp, taken) == zwant, \
                (key, shape, hdp)
    assert split_any >= 6          # embed, w_q, w_o and the MLP at least
    meta = [torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
            for _, shape, dtype, _ in specs]
    for hdp in (2, 4):
        rt = types.SimpleNamespace(hdp_size=hdp, hdp_axes=("data",))
        assert zero1.zero1_bytes(meta, hdp) == jzero1.zero1_bytes(abstract,
                                                                 rt)


def test_split_table_refuses_what_this_slice_does_not_run():
    """Mamba's leaves have no rule yet (they come with its model, queue 1
    item 8); RWKV-6's have theirs (`tests/test_torch_rwkv_tp.py`)."""
    with pytest.raises(NotImplementedError, match="item 8"):
        tp_split_dim(("blocks", "0", "mamba", "w_in"), 3, True)
    with pytest.raises(NotImplementedError, match="item 8"):
        tp_split_dim(("blocks", "0", "mamba", "A_log"), 3, True)
    with pytest.raises(NotImplementedError, match="item 8"):
        tp_split_dim(("blocks", "0", "mamba", "conv_w"), 3, True)


# ---------------------------------------------------------------------------
# (d) the vocab-parallel cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vocab_parallel_ce_matches_the_reference(dtype, impl):
    """tp 4, V 1024: every shard's first and last column is some row's
    label.  The nll and the whole dlogits (each rank's columns put
    together) against the reference's `token_ce_from_logits` on the
    whole logits; every rank gets the same loss."""
    tp, t, v = 4, 64, 1024
    rng = np.random.RandomState(7)
    logits = (rng.randn(t, v) * 3).astype(np.float32)
    labels = rng.randint(0, v, t).astype(np.int32)
    edges = [m * (v // tp) + c for m in range(tp) for c in (0, v // tp - 1)]
    labels[:len(edges)] = edges
    valid = rng.rand(t) > 0.1
    denom = 50.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jlog = jnp.asarray(logits).astype(jdt)
    (want, jm), jgrad = jax.value_and_grad(
        lambda x: jax_ce(x, jnp.asarray(labels), jnp.asarray(valid),
                         jnp.float32(denom)), has_aux=True)(jlog)
    tdt = getattr(torch, dtype)
    full = torch.from_numpy(np.array(jlog.astype(jnp.float32))).to(tdt)

    def rank(comm):
        x = shard_param(full, 1, comm.rank, tp).clone().requires_grad_(True)
        loss, m = token_ce_from_logits(
            x, torch.from_numpy(labels), torch.from_numpy(valid),
            torch.tensor(denom), impl=impl, tp_comm=comm)
        (g,) = torch.autograd.grad(loss, [x])
        return loss.item(), m["nll_sum"].item(), g.float().numpy()

    got = ThreadRanks(tp).run(rank)
    tol = CE_TOL[dtype]
    for loss, nll_sum, _ in got:
        np.testing.assert_allclose(loss, float(want), rtol=tol)
        np.testing.assert_allclose(nll_sum, float(jm["nll_sum"]), rtol=tol)
    dl = np.concatenate([g for *_, g in got], axis=1)
    np.testing.assert_allclose(dl, np.asarray(jgrad.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the init, the refusals, a checkpoint of another layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_a_seed_gives_the_same_model_at_every_tp(tp):
    cfg = W.config()
    whole = bridge.params_to_flat(T.init_params(cfg, seed=3, device="cpu"))
    for m in range(tp):
        part = bridge.params_to_flat(T.init_params(cfg, seed=3, device="cpu",
                                                   model=(m, tp)))
        assert sorted(part) == sorted(whole)
        for key, arr in whole.items():
            np.testing.assert_array_equal(
                part[key], _slice(arr, _split(key, arr, tp), m, tp),
                err_msg=key)


def test_tensor_parallelism_refuses_what_this_slice_does_not_run():
    """At tp 2: Mamba and the non-token frontends (queue 1 item 8), TP
    serving (the engine, RWKV-6's decode step, the serving launcher) and
    an expert count tp does not divide still raise; pipeline stages,
    offload and RWKV-6's training run (`tests/test_torch_grid.py`,
    `tests/test_torch_rwkv_tp.py`)."""
    ranks = ThreadRanks(2)

    def rank(comm):
        rt = Runtime(device="cpu", tp_comm=comm)
        got = []
        for cfg in (dataclasses.replace(W.config(), layer_pattern="m",
                                        mamba=MambaSpec()),
                    dataclasses.replace(W.config(), layer_pattern="gm",
                                        mamba=MambaSpec()),
                    dataclasses.replace(W.config(), frontend="vision_stub"),
                    dataclasses.replace(W.config(), frontend="audio_stub")):
            with pytest.raises(NotImplementedError, match="item 8"):
                T.check_supported(cfg, rt.tp)
            got.append(cfg.name)
        T.check_supported(get_config("rwkv6-7b"), rt.tp)
        from repro_torch.serve import ServeEngine
        from repro_torch.train import serve_step
        cfg = W.config()
        params = T.init_params(cfg, device="cpu", model=(comm.rank, 2))
        with pytest.raises(NotImplementedError, match="TP serving"):
            ServeEngine(params, cfg, rt)
        with pytest.raises(NotImplementedError, match="TP serving"):
            serve_step.make_decode_step(get_config("rwkv6-7b").reduced(), rt,
                                        4, 64)
        return got

    assert all(len(r) == 4 for r in ranks.run(rank))
    from repro_torch.launch import profile_serve
    with pytest.raises(NotImplementedError, match="TP serving"):
        profile_serve.main(["--reduced", "--mesh", "2x2", "--device", "cpu"])
    with pytest.raises(ValueError, match="do not split over"):
        launch_train.main(["--arch", "mistral-8x7b", "--reduced", "--mesh",
                           "1x8", "--device", "cpu"])


def test_a_checkpoint_of_another_head_padding_is_refused(tmp_path):
    """Reduced llama3.2-3b at tp 8 pads its 4 heads to 8: a file of that
    layout does not restore at tp 1, and the refusal names the shape."""
    cfg = W.config()
    tp = 8
    parts = [T.init_params(cfg, device="cpu", model=(m, tp))
             for m in range(tp)]
    splits = tp_splits(parts[0], False, tp)
    it = iter([p if s is None else torch.cat(ps, s) for ps, p, s in zip(
        zip(*[leaves(q) for q in parts]), leaves(parts[0]), splits)])
    whole = tree_map(lambda _: next(it), parts[0])
    assert whole["blocks"][0]["attn"]["w_q"].shape == (2, 64, 128)
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, whole, adamw.init_state(whole), {"step": 1}, block=True)
    like = T.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match=r"attn/w_[qo] has shape "
                                         r"\(2, (64, 128|128, 64)\)"):
        ck.restore(1, like, adamw.init_state(like))


# ---------------------------------------------------------------------------
# (b) tp 4: replicated KV against the reference on a (1, 4) mesh
# ---------------------------------------------------------------------------

def test_replicated_kv_forward_and_grads_match_the_reference(results,
                                                            out_dir):
    ref, *_ = results
    cfg = W.config()
    flat = dict(np.load(out_dir / "jax_params.npz"))
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in W.wave(cfg.vocab_size).items()}
    tp = 4

    def rank(comm):
        params = bridge.params_from_flat(flat, cfg, "cpu",
                                         model=(comm.rank, tp))
        rt = Runtime(device="cpu", attn_impl="ref", tp_comm=comm)
        assert not rt.layout(cfg).kv_sharded
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        h = T.forward_hidden(live, cfg, rt, batch)
        loss, _ = token_ce_loss(live, cfg, rt, h, batch["labels"],
                                batch["seg"], batch["denom"])
        grads = torch.autograd.grad(loss, leaves(live))
        it = iter(grads)
        return loss.item(), bridge.params_to_flat(
            tree_map(lambda _: next(it), live))

    got = ThreadRanks(tp).run(rank)
    for m, (loss, grads) in enumerate(got):
        np.testing.assert_allclose(loss, float(ref["b/loss"]), rtol=F32_TOL)
        keys = _keys(ref, "b/grad/")
        assert sorted(grads) == keys
        for key in keys:
            full = ref[f"b/grad/{key}"]
            want = _slice(full, _split(key, full, tp), m, tp)
            assert _rel(grads[key], want) <= F32_TOL, (m, key)
    wkv = [g["blocks/0/attn/w_kv"] for _, g in got]
    for other in wkv[1:]:
        np.testing.assert_array_equal(other, wkv[0])


# ---------------------------------------------------------------------------
# (a) three steps on a 2 x 2 grid against the reference's Trainer
# ---------------------------------------------------------------------------

def test_grid_ranks_are_model_fastest(results):
    _, ranks, _ = results
    for r, rk in enumerate(ranks):
        assert (int(rk["hdp_rank"]), int(rk["model_rank"])) == divmod(r, 2)


def test_plan_fingerprints_agree_on_every_rank_and_the_reference(results):
    ref, ranks, _ = results
    want = ref["fp"].tolist()
    assert len(want) == W.STEPS and len(set(want)) == W.STEPS
    for impl in W.IMPLS:
        for rk in ranks:
            assert rk[f"{impl}/fp"].tolist() == want, impl


@pytest.mark.parametrize("impl", W.IMPLS)
def test_losses_and_grad_norms_match_the_reference(results, impl):
    ref, ranks, _ = results
    for rk in ranks:
        assert rk[f"{impl}/waves"].tolist() == ref["waves"].tolist()
        assert rk[f"{impl}/applied"].tolist() == [1] * W.STEPS
        for s in range(W.STEPS):
            np.testing.assert_allclose(rk[f"{impl}/wave_losses/{s}"],
                                       ref[f"wave_losses/{s}"], rtol=F32_TOL)
        np.testing.assert_allclose(rk[f"{impl}/loss"], ref["loss"],
                                   rtol=F32_TOL)
        np.testing.assert_allclose(rk[f"{impl}/grad_norm"], ref["grad_norm"],
                                   rtol=F32_TOL)


@pytest.mark.parametrize("impl", W.IMPLS)
def test_parameter_updates_match_the_reference(results, out_dir, impl):
    """Every rank's update of each of its slices within 1e-3 relative L2
    of the same slice of the reference's update."""
    ref, ranks, _ = results
    p0 = dict(np.load(out_dir / "jax_params.npz"))
    keys = _keys(ranks[0], f"{impl}/p0/")
    assert len(keys) > 5 and keys == _keys(ref, "p1/")
    for rk in ranks:
        m = int(rk["model_rank"])
        for s in range(W.STEPS):
            for key in keys:
                before = p0[key] if s == 0 else ref[f"p{s}/{key}"]
                dim = _split(key, before)
                got = rk[f"{impl}/p{s + 1}/{key}"] - rk[f"{impl}/p{s}/{key}"]
                want = _slice(ref[f"p{s + 1}/{key}"] - before, dim, m)
                assert _rel(got, want) <= UPDATE_TOL, (m, s, key)


@pytest.mark.parametrize("impl", W.IMPLS)
def test_replicas_hold_the_same_values(results, impl):
    """The replicated leaves are bit-identical across each model group,
    and every slice across the HDP ranks that hold it."""
    _, ranks, _ = results
    for s in range(W.STEPS + 1):
        for key in _keys(ranks[0], f"{impl}/p{s}/"):
            arr = ranks[0][f"{impl}/p{s}/{key}"]
            same = [r for r in range(W.R) if _split(key, arr) is None
                    or r % W.TP == 0]
            for r in same[1:]:
                np.testing.assert_array_equal(
                    ranks[r][f"{impl}/p{s}/{key}"], arr,
                    err_msg=f"rank {r} step {s} {key}")
            for r in range(W.TP, W.R):
                np.testing.assert_array_equal(
                    ranks[r][f"{impl}/p{s}/{key}"],
                    ranks[r % W.TP][f"{impl}/p{s}/{key}"])


# ---------------------------------------------------------------------------
# (e) the 2 x 2 checkpoint, resumed at 4 x 1
# ---------------------------------------------------------------------------

def _file(out_dir):
    with np.load(out_dir / "ckpt22" / f"step_{W.CKPT_STEP}" /
                 "arrays.npz") as f:
        return {k: f[k] for k in f.files}


def test_checkpoint_holds_every_ranks_slices_and_shards(results, out_dir):
    """The file's parameters are the global leaves after step 2; each
    rank's master, m and v are its ZeRO-1 shard (over the HDP group, the
    split dimension taken) of its model slice of the file's."""
    ref, ranks, _ = results
    f = _file(out_dir)
    assert int(f["opt/step"]) == W.CKPT_STEP
    keys = _keys(ranks[0], "ref/p0/")
    sharded = 0
    for key in keys:
        full = f[f"params/{key}"]
        dim = _split(key, full)
        parts = [ranks[m][f"ref/p{W.CKPT_STEP}/{key}"] for m in range(W.TP)]
        whole = parts[0] if dim is None else np.concatenate(parts, dim)
        np.testing.assert_array_equal(full, whole, err_msg=key)
        for rk in ranks:
            h, m = int(rk["hdp_rank"]), int(rk["model_rank"])
            mine = _slice(full, dim, m)
            zd = zero1.zero1_dim(mine.shape, W.HDP,
                                 () if dim is None else (dim,))
            sharded += zd is not None
            for k in ("master", "m", "v"):
                want = _slice(f[f"opt/{k}/{key}"], dim, m)
                if zd is not None:
                    want = _slice(want, zd, h, W.HDP)
                np.testing.assert_array_equal(rk[f"ckpt/state/{k}/{key}"],
                                              want, err_msg=f"{k} {key}")
    assert sharded > 0


def test_4x1_ranks_restore_their_shards_of_the_file(results, out_dir):
    _, ranks, _ = results
    f = _file(out_dir)
    for r, rk in enumerate(ranks):
        assert int(rk["h4/resumed_at"]) == W.CKPT_STEP
        keys = _keys(rk, "h4/state/master/")
        assert len(keys) > 5
        for key in keys:
            dim = zero1.zero1_dim(f[f"params/{key}"].shape, W.R)
            for k in ("master", "m", "v"):
                want = _slice(f[f"opt/{k}/{key}"], dim, r, W.R)
                np.testing.assert_array_equal(rk[f"h4/state/{k}/{key}"], want,
                                              err_msg=f"{r} {k} {key}")


def test_resumed_4x1_step_matches_the_reference_resuming_the_file(
        results, out_dir):
    ref, ranks, _ = results
    f = _file(out_dir)
    assert int(ref["h4/resumed_at"]) == W.CKPT_STEP
    for r, rk in enumerate(ranks):
        assert int(rk["h4/waves"]) == int(ref["h4/waves"])
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(rk[f"h4/{k}"]),
                                       float(ref[f"h4/{k}"]), rtol=F32_TOL,
                                       err_msg=f"{r} {k}")
        keys = _keys(rk, "h4/after/")
        assert len(keys) > 5 and keys == _keys(ref, "h4/after/")
        for key in keys:
            base = f[f"params/{key}"]
            got = rk[f"h4/after/{key}"] - base
            want = ref[f"h4/after/{key}"] - base
            assert _rel(got, want) <= UPDATE_TOL, (r, key)


# ---------------------------------------------------------------------------
# (f) the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_a_2x2_mesh(results):
    *_, stdout = results
    steps = [ln for ln in stdout.splitlines() if ln.startswith("step")]
    rec = json.loads([ln for ln in stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert len(steps) == 2 and rec["mesh"] == "2x2"
    assert [s["step"] for s in rec["steps"]] == [1, 2]
    assert all(np.isfinite(s["loss"]) and s["tokens"] > 0
               for s in rec["steps"])
    assert rec["zero1_bytes"]["zero1_param_gather"] > 0
