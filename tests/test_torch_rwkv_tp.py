"""RWKV-6 under tensor parallelism (`models/rwkv6.py` with the model
group, `parallel/sharding.py`'s RWKV rules) against the reference's
``"model"`` mesh axis, on reduced rwkv6-7b in float32 (d 64, 4 WKV heads
of 16, d_ff 128).

* (a) The split table (`tp_split_dim`) of every RWKV leaf against the
  reference's `param_spec` / `params_pspecs`, and `zero1_dim` with the
  split taken against `zero1_spec`, leaf by leaf, for rwkv6-7b and its
  reduced config at tp 2 and 4 (shapes only); a WKV head count or
  ``d_ff`` that tp does not divide raises `ValueError`.
* (b) One packed wave at hdp 1 x tp 2 (`ThreadRanks(2)`, in process):
  the loss and every rank's gradients (its slices) against the
  reference's ``loss_fn`` on a (1, 2) mesh of 2 host devices, at the
  gradient tolerance of `tests/test_torch_rwkv.py`; the replicated
  leaves' gradients equal on both ranks.
* (c) 2 `Trainer` steps at hdp 1 x tp 2 (`_torch_rwkv_tp_worker.py`, on
  both model groups of 4 gloo ranks) against the reference's `Trainer`
  on the (1, 2) mesh from its initial weights: plan fingerprints, step
  and wave losses and grad norms within 1e-4 relative, every step's
  update of every rank's slices within 1e-3 relative L2 per leaf.
* (d) 2 steps on a 2 x 2 grid against the port's own 2 x 1 run from the
  same weights (the reference relays a sharded sequence from its
  buffer's last row, the port from its last non-padding row, so at hdp
  2 the two packages differ wherever padding follows a piece: ROADMAP
  queue 3): losses and grad norms within 1e-4, updates within 1e-3 per
  leaf; the replicated leaves bit-identical across each model group.

The reference and the gloo ranks run as two subprocesses started
together when the module starts.
"""
import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_rwkv_tp_worker as W
from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.parallel import sharding as jsharding
from repro.parallel import zero1 as jzero1
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.loss import token_ce_loss
from repro_torch.models import transformer as T
from repro_torch.parallel import zero1
from repro_torch.parallel.comm import ThreadRanks
from repro_torch.parallel.sharding import Runtime, shard_param, tp_split_dim
from repro_torch.tree import leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4                  # tests/test_torch_train.py
GRAD_TOL = 1e-3                 # model gradients: tests/test_torch_rwkv.py
UPDATE_TOL = 1e-3               # post-step update, relative L2 per leaf
TIMEOUT = 600

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
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
import _torch_rwkv_tp_worker as W

out = sys.argv[1]
cfg = dataclasses.replace(get_config(W.ARCH).reduced(), dtype="float32")
mesh = compat.make_mesh((1, W.TP), ("data", "model"),
                        axis_types=compat.auto_axis_types(2))
compat.set_mesh(mesh)
rt = Runtime(mesh=mesh, hdp_axes=("data",), model_axis="model")
ds = SyntheticDataset(LengthDistribution(*W.DIST), cfg.vocab_size,
                      tokens_per_step=W.TOKENS, context=W.CONTEXT)
sched = GlobalScheduler(ds, cfg, capacity=W.CAP, hdp=1, use_offload=False)
plans = []
plan_step = sched.plan_step
def recorded(step):
    plan = plan_step(step)
    plans.append(plan_fingerprint(plan))
    return plan
sched.plan_step = recorded
tr = Trainer(cfg, rt, AdamWConfig(lr=W.LR, total_steps=W.TOTAL_STEPS), sched,
             TrainerConfig(capacity=W.CAP, attn_impl="ref", calibrate=False))
p0 = jax.tree.map(lambda x: x.copy(), tr.params)
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
res["fp"] = np.array(plans)

# (b) one wave's loss and gradients on the same (1, 2) mesh
batch = {k: jax.numpy.asarray(v) for k, v in W.wave(cfg.vocab_size).items()}
loss, grads = jax.jit(jax.value_and_grad(
    lambda p: loss_fn(p, cfg, rt, batch)[0]))(p0)
res["b/loss"] = float(loss)
for key, v in _flatten(grads).items():
    res[f"b/grad/{key}"] = v
np.savez(out + "/jax_rwkv_tp.npz", **{k: np.asarray(v) for k, v in res.items()})
"""


# ---------------------------------------------------------------------------
# the subprocesses, started when the module starts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("rwkv_tp")


@pytest.fixture(scope="module", autouse=True)
def procs(out_dir):
    """Start the reference (2 host devices) and the port (4 gloo ranks)
    together; kill what is left at the end of the module."""
    env = subprocess_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    started = {}
    for part, cmd in (
            ("jax", [sys.executable, "-c", JAX_SCRIPT, str(out_dir)]),
            ("torch", [sys.executable,
                       str(ROOT / "tests" / "_torch_rwkv_tp_worker.py"),
                       str(out_dir)])):
        with open(out_dir / f"{part}.log", "w") as log, \
                open(out_dir / f"{part}.err", "w") as err:
            started[part] = subprocess.Popen(cmd, cwd=ROOT, env=env,
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
    """-> (reference results, per-rank port results), once both have
    ended."""
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
    ref = dict(np.load(out_dir / "jax_rwkv_tp.npz"))
    ranks = [dict(np.load(out_dir / f"torch_rank{r}.npz"))
             for r in range(W.R)]
    return ref, ranks


def _keys(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


def _split(key: str, arr: np.ndarray):
    return tp_split_dim(key.split("/"), arr.ndim, True)


def _slice(arr: np.ndarray, dim, m: int, tp: int = W.TP) -> np.ndarray:
    return arr if dim is None else \
        shard_param(torch.from_numpy(np.ascontiguousarray(arr)), dim, m,
                    tp).numpy()


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------------------
# (a) the split table and ZeRO-1 against the reference (shapes only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["rwkv6-7b", "rwkv6-7b-reduced"])
def test_rwkv_split_table_and_zero1_match_the_reference(name, tp):
    """Leaf by leaf: the dimension the port splits an RWKV leaf on is the
    one `param_spec` puts ``model`` on (the time mix's projections and
    ``decay_b`` on their columns, ``w_o`` on its rows, ``decay_base``,
    ``bonus_u`` and ``ln_x`` on their heads, the LoRAs but ``decay_b`` and
    ``mix_k`` replicated, the channel mix column- then row-parallel), and
    ZeRO-1 shards a rank's slice on the dimension `zero1_spec` shards the
    global leaf on, at hdp 2 and 4."""
    cfg = jax_config(name)
    T.check_supported(get_config(name), tp)
    rt = types.SimpleNamespace(
        layout=lambda c: JL.gqa_layout(c.num_heads, c.num_kv_heads, tp),
        model_axis="model", stage_axis=None, num_stages=1)
    abstract = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg, rt))
    specs = jax.tree_util.tree_leaves(
        jsharding.params_pspecs(abstract, cfg, rt),
        is_leaf=lambda x: isinstance(x, P))
    flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
    assert len(specs) == len(flat) > 15
    seen = set()
    for (path, leaf), spec in zip(flat, specs):
        key = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        want = next((i for i, e in enumerate(spec) if e == "model"), None)
        got = tp_split_dim(key, leaf.ndim, True)
        assert got == want, (key, leaf.shape, spec)
        seen.add((*key[-2:], got is not None))
        local = list(leaf.shape)
        if got is not None:
            local[got] //= tp
        for hdp in (2, 4):
            z = jzero1.zero1_spec(spec, leaf.shape, types.SimpleNamespace(
                hdp_size=hdp, hdp_axes=("data",)))
            zwant = next((i for i, e in enumerate(z) if e == "data"), None)
            assert zero1.zero1_dim(local, hdp, () if got is None
                                   else (got,)) == zwant, (key, hdp)
    for leaf, split in (("w_r", True), ("w_o", True), ("decay_b", True),
                        ("bonus_u", True), ("decay_base", True),
                        ("mix_a", False), ("decay_a", False),
                        ("mix_base", False)):
        assert ("time_mix", leaf, split) in seen, leaf
    assert ("ln_x", "scale", True) in seen
    assert ("channel_mix", "w_k", True) in seen
    assert ("channel_mix", "mix_k", False) in seen


@pytest.mark.parametrize("what, change", [
    ("WKV heads", dict(d_model=96)),       # 6 heads of 16 over 4 ranks
    ("d_ff columns", dict(d_ff=130)),
])
def test_rwkv_widths_tp_does_not_divide_raise(what, change):
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(), **change)
    with pytest.raises(ValueError, match=what):
        T.check_supported(cfg, 4)


# ---------------------------------------------------------------------------
# (b) one wave at hdp 1 x tp 2 against the reference's loss_fn
# ---------------------------------------------------------------------------

def test_wave_loss_and_grads_at_tp2_match_the_reference(results, out_dir):
    ref, _ = results
    cfg = W.config()
    flat = dict(np.load(out_dir / "jax_params.npz"))
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in W.wave(cfg.vocab_size).items()}

    def rank(comm):
        params = bridge.params_from_flat(flat, cfg, "cpu",
                                         model=(comm.rank, W.TP))
        rt = Runtime(device="cpu", attn_impl="ref", tp_comm=comm)
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        h = T.forward_hidden(live, cfg, rt, batch)
        loss, _ = token_ce_loss(live, cfg, rt, h, batch["labels"],
                                batch["seg"], batch["denom"])
        grads = torch.autograd.grad(loss, leaves(live))
        it = iter(grads)
        return loss.item(), bridge.params_to_flat(
            tree_map(lambda _: next(it), live))

    got = ThreadRanks(W.TP).run(rank)
    keys = _keys(ref, "b/grad/")
    assert any("time_mix" in k for k in keys)
    for m, (loss, grads) in enumerate(got):
        np.testing.assert_allclose(loss, float(ref["b/loss"]), rtol=F32_TOL)
        assert sorted(grads) == keys
        for key in keys:
            full = ref[f"b/grad/{key}"]
            want = _slice(full, _split(key, full), m)
            np.testing.assert_allclose(grads[key], want, atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=f"{m} {key}")
    for key in keys:
        if _split(key, ref[f"b/grad/{key}"]) is None:
            np.testing.assert_array_equal(got[1][1][key], got[0][1][key],
                                          err_msg=key)


# ---------------------------------------------------------------------------
# (c) the Trainer at hdp 1 x tp 2 against the reference's (1, 2) mesh
# ---------------------------------------------------------------------------

def test_grid_ranks_are_model_fastest(results):
    _, ranks = results
    for r, rk in enumerate(ranks):
        assert (int(rk["hdp_rank"]), int(rk["model_rank"])) == divmod(r, 2)


def test_tp2_trainer_matches_the_reference(results):
    """Plan fingerprints, wave and step losses and grad norms within 1e-4
    relative on both model groups."""
    ref, ranks = results
    want = ref["fp"].tolist()
    assert len(want) == W.STEPS and len(set(want)) == W.STEPS
    for rk in ranks:
        assert rk["t12/fp"].tolist() == want
        assert rk["t12/waves"].tolist() == ref["waves"].tolist()
        assert rk["t12/applied"].tolist() == [1] * W.STEPS
        for s in range(W.STEPS):
            np.testing.assert_allclose(rk[f"t12/wave_losses/{s}"],
                                       ref[f"wave_losses/{s}"], rtol=F32_TOL)
        np.testing.assert_allclose(rk["t12/loss"], ref["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(rk["t12/grad_norm"], ref["grad_norm"],
                                   rtol=F32_TOL)


def test_tp2_parameter_updates_match_the_reference(results, out_dir):
    """Every rank's update of each of its slices within 1e-3 relative L2
    of the same slice of the reference's update."""
    ref, ranks = results
    p0 = dict(np.load(out_dir / "jax_params.npz"))
    keys = _keys(ranks[0], "t12/p0/")
    assert len(keys) > 15 and keys == _keys(ref, "p1/")
    for rk in ranks:
        m = int(rk["model_rank"])
        for s in range(W.STEPS):
            for key in keys:
                before = p0[key] if s == 0 else ref[f"p{s}/{key}"]
                dim = _split(key, before)
                got = rk[f"t12/p{s + 1}/{key}"] - rk[f"t12/p{s}/{key}"]
                want = _slice(ref[f"p{s + 1}/{key}"] - before, dim, m)
                assert _rel(got, want) <= UPDATE_TOL, (m, s, key)


# ---------------------------------------------------------------------------
# (d) 2 x 2 against the port's own 2 x 1
# ---------------------------------------------------------------------------

def test_2x2_grid_matches_the_ports_2x1_run(results):
    """The same plans; step and wave losses and grad norms within 1e-4
    relative; every step's update of each rank's slices within 1e-3
    relative L2 of the same slices of the 2 x 1 run's."""
    _, ranks = results
    for rk in ranks:
        assert rk["g22/fp"].tolist() == rk["g21/fp"].tolist()
        assert rk["g22/applied"].tolist() == [1] * W.STEPS
        for s in range(W.STEPS):
            np.testing.assert_allclose(rk[f"g22/wave_losses/{s}"],
                                       rk[f"g21/wave_losses/{s}"],
                                       rtol=F32_TOL)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(rk[f"g22/{k}"], rk[f"g21/{k}"],
                                       rtol=F32_TOL)
        m = int(rk["model_rank"])
        for s in range(W.STEPS):
            for key in _keys(rk, "g22/p0/"):
                whole = rk[f"g21/p{s + 1}/{key}"] - rk[f"g21/p{s}/{key}"]
                got = rk[f"g22/p{s + 1}/{key}"] - rk[f"g22/p{s}/{key}"]
                want = _slice(whole, _split(key, whole), m)
                assert _rel(got, want) <= UPDATE_TOL, (m, s, key)


def test_2x2_replicas_hold_the_same_values(results):
    """The replicated leaves bit-identical across each model group, and
    every slice across the HDP ranks that hold it."""
    _, ranks = results
    for s in range(W.STEPS + 1):
        for key in _keys(ranks[0], f"g22/p{s}/"):
            arr = ranks[0][f"g22/p{s}/{key}"]
            if _split(key, ranks[0][f"g21/p0/{key}"]) is None:
                np.testing.assert_array_equal(
                    ranks[1][f"g22/p{s}/{key}"], arr, err_msg=key)
            for r in range(W.TP, W.R):
                np.testing.assert_array_equal(
                    ranks[r][f"g22/p{s}/{key}"],
                    ranks[r % W.TP][f"g22/p{s}/{key}"], err_msg=key)
