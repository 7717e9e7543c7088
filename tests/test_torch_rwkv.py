"""RWKV-6 in the port (`repro_torch/models/rwkv6.py`, `core/ring.py`'s
token shift and state scan, the ``r`` layers of `models/transformer.py`
and `train/serve_step.py`) against the reference, on reduced rwkv6-7b
(d 64, head size 16, chunk 16, float32 unless stated).

* `wkv6_chunked`'s four outputs against the reference's `wkv6_chunked`
  and both packages' `wkv6_sequential` at the reference's 2e-4
  (`tests/test_ssm.py`), decays drawn as there, with an incoming state
  and carry segment, for several chunk sizes and segment counts; the
  state linearity the HDP exchange relies on.
* `rwkv_time_mix` and `rwkv_channel_mix` in float32 and bf16; the model's
  logits, loss and gradients against ``jax.grad``; teacher-forced decode
  against the packed forward at 0.08 (`tests/test_serve.py`) and the
  reference's decode step; the model's bf16 gradients against the
  reference's bf16 ones (the bonus off zero; at its init 0 both are
  ill-conditioned); every bridged leaf's dtype the reference's;
  `zero1_dim` and the ZeRO-1 bytes of every RWKV leaf the reference's.
* A sequence sharded over HDP ranks (`_torch_rwkv_worker.py`, 4 gloo
  ranks): at hdp 4 ((4,), (1, 2, 1)) and 2 ((2,)) the forward, the loss
  and every gradient equal hdp = 1 over the same sequences laid
  contiguously, the port's and the reference's, at the ring tolerances
  of `tests/test_ring_flash.py`; the measured ``"ring"`` bytes are 0.
  Against the reference's own sharded run (4 host devices): where each
  piece fills its rank's buffer the two agree; where the planner's
  layout leaves padding after a piece, the reference's boundary (the
  buffer's last row) cuts the sequence and it departs from hdp = 1,
  which the port's boundary (the last non-padding row) does not.
* 2 `Trainer` steps at hdp 1 (in process) and 2 (the worker) against the
  reference's `Trainer` at hdp 1; decode at hdp 2 under the ``"batch"``
  and ``"seq"`` slabs against hdp 1; a checkpoint of each package
  restored by the other.
* The port's `ServeEngine` and prefill KV capture refuse RWKV, as the
  reference's do; `check_supported` still refuses Mamba and the embeds
  frontends; the planner lays a sharded sequence contiguously in rank
  order.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rwkv_worker as W
from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config as jax_config
from repro.core.loss import token_ce_loss
from repro.data.distribution import LengthDistribution as JDist
from repro.data.loader import GlobalScheduler as JScheduler
from repro.data.loader import SyntheticDataset as JDataset
from repro.models import rwkv6 as JRW
from repro.models import transformer as JT
from repro.obs import ledger as jledger
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import serve_step as JS
from repro.train.train_step import loss_fn as jax_loss_fn
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.ckpt import CheckpointManager, flatten
from repro_torch.configs import base
from repro_torch.configs.registry import get_config
from repro_torch.models import rwkv6 as RW
from repro_torch.models import transformer as T
from repro_torch.obs import ledger
from repro_torch.parallel.sharding import Runtime
from repro_torch.train import serve_step as S
from repro_torch.train.train_step import loss_fn as port_loss_fn
from repro_torch.tree import leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
SSM_TOL = 2e-4                  # tests/test_ssm.py
MOD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
F32_TOL = 5e-5                  # model logits and loss, float32
GRAD_TOL = 1e-3                 # model gradients: tests/test_kernels.py
RING_TOL = 3e-4                 # tests/test_ring_flash.py:40-43
SERVE_TOL = 0.08                # tests/test_serve.py
TRAIN_TOL = 1e-4                # tests/test_torch_train.py
UPDATE_TOL = 1e-3               # post-step update, relative L2 per leaf
# the reference's own sharded runs: one compile per composition, so the
# (1, 2, 1) waves share one
JAX_HDP_WAVES = ("4-flush", "121-flush", "121-ragged")

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import numpy as np
from repro import compat
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config
from repro.models.transformer import forward_hidden, init_params
from repro.models.transformer import logits_head
from repro.core.loss import token_ce_loss
from repro.parallel.sharding import Runtime
sys.path.insert(0, "tests")
import _torch_rwkv_worker as W

out, names = sys.argv[1], sys.argv[2:]
cfg = dataclasses.replace(get_config(W.ARCH).reduced(), dtype="float32")
want = dict(np.load(out + "/jax_params.npz"))
res, fns = {}, {}
for name in names:
    comp, slots = W.WAVES[name]
    if comp not in fns:             # one compile per composition
        g = len(slots)
        mesh = compat.make_mesh((g, 1), ("data", "model"),
                                axis_types=compat.auto_axis_types(2),
                                devices=jax.devices()[:g])
        compat.set_mesh(mesh)
        rt = Runtime(mesh=mesh, hdp_axes=("data",), model_axis="model",
                     composition=comp, remat="none")
        # the test's initial parameters, on the tree of init_params
        paths, tdef = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
            lambda: init_params(jax.random.PRNGKey(0), cfg, rt)))
        params = jax.tree_util.tree_unflatten(tdef, [jax.numpy.asarray(
            want["/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                          for q in path)]) for path, _ in paths])

        def f(p, b, rt=rt):         # train_step.loss_fn, one forward
            h = forward_hidden(p, cfg, rt, b)
            loss, _ = token_ce_loss(p, cfg, rt, h, b["labels"], b["seg"],
                                    b["denom"])
            return loss, logits_head(p, cfg, h)

        fns[comp] = (jax.jit(jax.value_and_grad(f, has_aux=True)), params)
    fn, params = fns[comp]
    b = {k: jax.numpy.asarray(v)
         for k, v in W.wave_batch(name, cfg.vocab_size).items()}
    b["denom"] = jax.numpy.float32((np.asarray(b["seg"]) > 0).sum())
    (loss, logits), grads = fn(params, b)
    res[name + "/loss"] = np.float64(loss)
    res[name + "/logits"] = np.asarray(logits)
    for k, v in _flatten(grads).items():
        res[f"{name}/grad/{k}"] = v
np.savez(out + "/jax_hdp.tmp.npz", **res)
os.replace(out + "/jax_hdp.tmp.npz", out + "/jax_hdp.npz")
"""


def _jcfg(dtype="float32"):
    return dataclasses.replace(jax_config(W.ARCH).reduced(), dtype=dtype)


def _env():
    env = subprocess_env()
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory, rt1):
    """Writes the reference's initial float32 parameters, then starts the
    gloo ranks and the reference's sharded runs together."""
    out = tmp_path_factory.mktemp("rwkv")
    jp = JT.init_params(jax.random.PRNGKey(0), _jcfg(), rt1)
    np.savez(out / "jax_params.npz", **_flatten(jp))
    procs = {
        "torch": subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_rwkv_worker.py"),
             str(out)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True),
        "jax": subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, str(out), *JAX_HDP_WAVES],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True),
    }
    state = {"out": out, "jp": jp, "procs": procs, "done": {}}
    yield state
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def _result(runs, name):
    """Waits for subprocess ``name`` and returns its npz files."""
    if name not in runs["done"]:
        p = runs["procs"][name]
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
        out = runs["out"]
        if name == "torch":
            runs["done"][name] = [dict(np.load(out / f"torch_rank{r}.npz"))
                                  for r in range(W.R)]
        else:
            runs["done"][name] = dict(np.load(out / "jax_hdp.npz"))
    return runs["done"][name]


@pytest.fixture(scope="module")
def port_params(runs):
    return bridge.params_from_flat(_flatten(runs["jp"]), W.config(), "cpu")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _port_config(jcfg):
    d = dataclasses.asdict(jcfg)
    specs = {"moe": base.MoESpec, "mla": base.MLASpec,
             "rwkv": base.RWKVSpec, "mamba": base.MambaSpec}
    for k, cls in specs.items():
        d[k] = None if d[k] is None else cls(**d[k])
    return base.ModelConfig(**d)


def test_config_resolves_to_the_references():
    cfg = get_config(W.ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config(W.ARCH))
    assert cfg.attention_free and cfg.rwkv.chunk_size == 128
    T.check_supported(cfg)
    T.check_supported(cfg.reduced())
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(_jcfg(
        "bfloat16"))


@pytest.mark.parametrize("arch,what", [
    ("jamba-1.5-large-398b", "mamba"), ("qwen2-vl-2b", "frontend"),
    ("musicgen-medium", "frontend")])
def test_check_supported_still_refuses(arch, what):
    with pytest.raises(NotImplementedError, match=what):
        T.check_supported(_port_config(jax_config(arch)))


# ---------------------------------------------------------------------------
# the WKV-6 scan
# ---------------------------------------------------------------------------

def _seg(rng, t, n_seq, pad=4):
    """tests/test_ssm.py's segment layout."""
    body = t - pad
    cuts = sorted(rng.choice(np.arange(1, body), n_seq - 1, replace=False)) \
        if n_seq > 1 else []
    bounds = [0] + list(cuts) + [body]
    seg = np.zeros(t, np.int32)
    for i in range(len(bounds) - 1):
        seg[bounds[i]:bounds[i + 1]] = i + 1
    return seg


def _wkv_inputs(seed, n_seq, t=64, h=2, n=8):
    rng = np.random.RandomState(seed)
    d = h * n
    r, k, v = (rng.randn(t, d).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.randn(t, d) * 0.5 - 2).astype(np.float32)
    u = (rng.randn(h, n) * 0.3).astype(np.float32)
    seg = _seg(rng, t, n_seq)
    s0 = (rng.randn(h, n, n) * 0.5).astype(np.float32)
    return (r, k, v, logw, u, seg), s0, n


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("n_seq", [1, 3])
def test_wkv6_chunked_matches_the_reference(chunk, n_seq):
    args, s0, n = _wkv_inputs(10 * chunk + n_seq, n_seq)
    carry = int(args[-1][0])           # the incoming state's segment
    got = RW.wkv6_chunked(*map(torch.tensor, args), head_size=n, chunk=chunk,
                          s0=torch.tensor(s0), carry_seg=carry)
    want = JRW.wkv6_chunked(*map(jnp.asarray, args), head_size=n,
                            chunk=chunk, s0=jnp.asarray(s0),
                            carry_seg=jnp.int32(carry))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SSM_TOL,
                                   rtol=SSM_TOL)
    valid = args[-1] > 0
    y_seq, s_seq = RW.wkv6_sequential(*map(torch.tensor, args), head_size=n,
                                      s0=torch.tensor(s0), carry_seg=carry)
    jy, js = JRW.wkv6_sequential(*map(jnp.asarray, args), head_size=n,
                                 s0=jnp.asarray(s0),
                                 carry_seg=jnp.int32(carry))
    for y, s in ((y_seq.numpy(), s_seq.numpy()),
                 (np.asarray(jy), np.asarray(js))):
        np.testing.assert_allclose(got[0].numpy()[valid], y[valid],
                                   atol=SSM_TOL, rtol=SSM_TOL)
        np.testing.assert_allclose(got[1].numpy(), s, atol=SSM_TOL,
                                   rtol=SSM_TOL)


def test_wkv6_state_linearity():
    """y(s0) = y(0) + corr·s0 and s(s0) = A·s0 + s_local: the identity the
    cross-rank state scan relies on; and an unrelated carry segment lets
    nothing through (A = 0, corr = 0)."""
    args, s0, n = _wkv_inputs(9, 2)
    t_args = list(map(torch.tensor, args))
    carry = int(args[-1][0])
    y_dir, s_dir = RW.wkv6_sequential(*t_args, head_size=n,
                                      s0=torch.tensor(s0), carry_seg=carry)
    y0, s_loc, a_tot, corr = RW.wkv6_chunked(
        *t_args, head_size=n, chunk=16, s0=torch.zeros(s0.shape),
        carry_seg=carry)
    y_lin = y0 + torch.einsum("thn,hnm->thm", corr,
                              torch.tensor(s0)).reshape(y0.shape)
    valid = args[-1] > 0
    np.testing.assert_allclose(y_lin.numpy()[valid], y_dir.numpy()[valid],
                               atol=SSM_TOL, rtol=SSM_TOL)
    np.testing.assert_allclose((a_tot[..., None] * torch.tensor(s0)
                                + s_loc).numpy(), s_dir.numpy(),
                               atol=SSM_TOL, rtol=SSM_TOL)
    _, _, a99, c99 = RW.wkv6_chunked(*t_args, head_size=n, chunk=16,
                                     s0=torch.zeros(s0.shape), carry_seg=99)
    assert float(a99.abs().max()) == 0.0 and float(c99.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the mixes, the model and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_match_the_reference(rt1, dtype):
    """One layer's mixes on a buffer that continues a segment from a
    boundary row, the time mix with an incoming state composed in."""
    jcfg = _jcfg(dtype)
    cfg = W.config(dtype)
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg, rt1)
    p = bridge.params_from_flat(_flatten(jp), cfg, "cpu")
    rng = np.random.RandomState(2)
    x = rng.randn(48, 64).astype(np.float32)
    seg = np.array([1] * 20 + [2] * 20 + [0] * 8, np.int32)
    bx = rng.randn(64).astype(np.float32)
    h_in = (rng.randn(4, 16, 16) * 0.3).astype(np.float32)
    jx, jbx = (jnp.asarray(a, jcfg.dtype) for a in (x, bx))
    tdt = getattr(torch, dtype)
    tx, tbx = (torch.tensor(a).to(tdt) for a in (x, bx))
    jtm = jax.tree.map(lambda a: a[0], jp["blocks"][0]["time_mix"])
    want = jax.jit(lambda p_, x_, s_, b_: JRW.rwkv_time_mix(
        p_, jcfg, x_, s_, b_, jnp.int32(1),
        state_exchange=lambda s, a: jnp.asarray(h_in)))(
            jtm, jx, jnp.asarray(seg), jbx)
    got = RW.rwkv_time_mix(
        tree_map(lambda a: a[0], p["blocks"][0]["time_mix"]), cfg, tx,
        torch.tensor(seg), tbx, torch.tensor(1),
        state_exchange=lambda s, a: torch.tensor(h_in))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MOD_TOL[dtype], rtol=MOD_TOL[dtype])
    jcm = jax.tree.map(lambda a: a[0], jp["blocks"][0]["channel_mix"])
    want, _ = jax.jit(lambda p_, x_, s_, b_: JRW.rwkv_channel_mix(
        p_, jcfg, x_, s_, b_, jnp.int32(1)))(jcm, jx, jnp.asarray(seg), jbx)
    got = RW.rwkv_channel_mix(
        tree_map(lambda a: a[0], p["blocks"][0]["channel_mix"]), cfg, tx,
        torch.tensor(seg), tbx, torch.tensor(1))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=MOD_TOL[dtype], rtol=MOD_TOL[dtype])


_JAX_GRAD = {}


def _jax_wave(rt1, jp, batch):
    """The reference's hdp = 1 loss, logits and gradients of a buffer."""
    cfg = _jcfg()
    if "fn" not in _JAX_GRAD:
        def f(p, b):                # train_step.loss_fn, one forward
            h = JT.forward_hidden(p, cfg, rt1, b)
            loss, _ = token_ce_loss(p, cfg, rt1, h, b["labels"], b["seg"],
                                    b["denom"])
            return loss, JT.logits_head(p, cfg, h)
        _JAX_GRAD["fn"] = jax.jit(jax.value_and_grad(f, has_aux=True))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    b["denom"] = jnp.float32((batch["seg"] > 0).sum())
    (loss, logits), grads = _JAX_GRAD["fn"](jp, b)
    return float(loss), np.asarray(logits), _flatten(grads)


def _port_wave(params, batch):
    res: dict = {}
    W.wave_grads(params, W.config(), None, (1,), batch, slice(None), "w",
                 res)
    return (float(res["w/loss"]), res["w/logits"],
            {k[len("w/grad/"):]: v for k, v in res.items()
             if k.startswith("w/grad/")})


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def test_model_logits_loss_and_grads_match_jax_grad(runs, rt1, port_params):
    """Three packed sequences and padding at hdp = 1, remat on (the
    `_Period` route) against ``jax.grad``."""
    batch, _ = W.compacted(W.wave_batch("121-ragged", 512))
    loss, logits, grads = _port_wave(port_params, batch)
    j_loss, j_logits, j_grads = _jax_wave(rt1, runs["jp"], batch)
    valid = batch["seg"] > 0
    _close(loss, j_loss, F32_TOL)
    _close(logits[valid], j_logits[valid], F32_TOL)
    assert sorted(grads) == sorted(j_grads)
    for k in grads:
        _close(grads[k], j_grads[k], GRAD_TOL, k)


BF16_GRAD_TOL = 5e-2            # chip_smoke.py's TRAIN_GRAD_TOL


def _reference_params(rt1, jp32, dtype, embed_eps=0.0, bonus=None):
    """The reference's float32 parameters ``jp32`` cast to the dtypes of
    its ``dtype`` init, the embedding scaled by 1 + embed_eps·N(0, 1)
    before the cast, and every bonus set to ``bonus`` [H, N] when given."""
    like = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                 _jcfg(dtype), rt1))
    jp = jax.tree.map(lambda a, t: a.astype(t.dtype), jp32, like)
    e32 = np.asarray(jp32["embed"])
    noise = np.random.RandomState(1).randn(*e32.shape)
    jp["embed"] = jnp.asarray((e32 * (1 + embed_eps * noise))
                              .astype(np.float32), like["embed"].dtype)
    if bonus is not None:
        for blk in jp["blocks"]:
            tm = blk["time_mix"]
            tm["bonus_u"] = jnp.broadcast_to(jnp.asarray(bonus),
                                             tm["bonus_u"].shape)
    # placed as jp32's leaves, so that a jitted function of them is
    # compiled once
    return jax.tree.map(lambda a, r: jax.device_put(a, r.sharding), jp, jp32)


def _bf16_grads(rt1, batch, jp):
    """-> (the reference's, the port's) bf16 gradients of one wave's loss
    at the reference's parameters ``jp``, each {name: float64 array}."""
    if "bf16" not in _JAX_GRAD:
        cfg = _jcfg("bfloat16")
        _JAX_GRAD["bf16"] = jax.jit(jax.grad(
            lambda p, b: jax_loss_fn(p, cfg, rt1, b)[0]))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    b["denom"] = jnp.float32((batch["seg"] > 0).sum())
    want = {k: np.asarray(v, np.float64)
            for k, v in _flatten(_JAX_GRAD["bf16"](jp, b)).items()}
    cfg = W.config("bfloat16")
    p = bridge.params_from_flat(_flatten(jp), cfg, "cpu")
    live = tree_map(lambda a: a.detach().requires_grad_(True), p)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tb["denom"] = torch.tensor(float((batch["seg"] > 0).sum()))
    loss, _ = port_loss_fn(live, cfg, Runtime(device="cpu"), tb)
    it = iter(torch.autograd.grad(loss, leaves(live)))
    got = {k: np.asarray(v, np.float64) for k, v in bridge.params_to_flat(
        tree_map(lambda _: next(it).float(), p)).items()}
    return want, got


def _f32_grads(rt1, batch, jp):
    return {k: np.asarray(v, np.float64)
            for k, v in _jax_wave(rt1, jp, batch)[2].items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("bonus", ["off_zero", "init"])
def test_bf16_grads_follow_the_references(runs, rt1, bonus):
    """The reduced model's bf16 gradients of a wave of three sequences
    and padding against the reference's bf16 gradients, each against the
    reference's float32 ones.

    ``off_zero`` (every bonus drawn 0.5·N(0, 1)): each leaf of the port's
    within 5e-2 relative L2 of the reference's, and the bonus's distance
    from float32 within 25% of the reference's (both ~0.24: bf16 rounding
    puts it there in either package).

    ``init`` (the bonus at its init 0, as `chip_smoke.py` phase 15 (b)
    holds it): each sequence's first WKV output is 0, the group norm's
    slope there is 1/sqrt(eps), and the bf16 gradients are ill-conditioned
    in both packages: rounding some of the bf16 embedding's entries by one
    ulp (1e-4 relative before the cast) moves ``ln_x/bias``'s bf16
    gradient by over 10% in each, the float32 gradient by under 1%.  So
    at the init a bf16 gradient's distance from float32 measures the
    rounding, not the port."""
    batch, _ = W.compacted(W.wave_batch("121-ragged", 512))
    u = None if bonus == "init" else \
        (np.random.RandomState(5).randn(4, 16) * 0.5).astype(np.float32)
    jp32 = runs["jp"]
    f32 = _f32_grads(rt1, batch, _reference_params(rt1, jp32, "float32",
                                                   bonus=u))
    j16, p16 = _bf16_grads(rt1, batch, _reference_params(
        rt1, jp32, "bfloat16", bonus=u))
    key = next(k for k in f32 if k.endswith("bonus_u"))
    far = {"jax": _rel(j16[key], f32[key]), "port": _rel(p16[key], f32[key])}
    print(f"{bonus}: bonus_u bf16 from float32 {far}")
    if bonus == "off_zero":
        for k in f32:
            assert _rel(p16[k], j16[k]) <= BF16_GRAD_TOL, k
        assert abs(far["port"] / far["jax"] - 1) <= 0.25, far
        return
    bias = next(k for k in f32 if k.endswith("ln_x/bias"))
    f32e = _f32_grads(rt1, batch, _reference_params(rt1, jp32, "float32",
                                                    1e-4))
    j16e, p16e = _bf16_grads(rt1, batch, _reference_params(
        rt1, jp32, "bfloat16", 1e-4))
    moved = {"jax": _rel(j16e[bias], j16[bias]),
             "port": _rel(p16e[bias], p16[bias]),
             "float32": _rel(f32e[bias], f32[bias])}
    print(f"init: ln_x/bias moved by one-ulp embedding changes {moved}")
    assert moved["jax"] > 0.1 and moved["port"] > 0.1, moved
    assert moved["float32"] < 0.01, moved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_the_forward_and_the_reference(rt1, dtype):
    """tests/test_serve.py's case: two sequences of 24 tokens, the packed
    forward against 24 teacher-forced decode steps from an empty state
    (0.08), and each step's logits against the reference's decode step;
    the cache's bytes are the state's."""
    jcfg, cfg = _jcfg(dtype), W.config(dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
    p = bridge.params_from_flat(_flatten(jp), cfg, "cpu")
    t, b = 24, 2
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, t))
    batch = {"tokens": torch.tensor(tokens.reshape(-1), dtype=torch.int32),
             "seg": torch.tensor(np.repeat([1, 2], t), dtype=torch.int32),
             "pos": torch.tensor(np.tile(np.arange(t), b),
                                 dtype=torch.int32)}
    rt = Runtime(device="cpu")
    with torch.no_grad():
        fwd = T.logits_head(p, cfg, T.forward_hidden(p, cfg, rt, batch))
        cache = S.init_decode_cache(cfg, rt, b, t)
        assert S.cache_bytes(cache) == b * RW.state_bytes(cfg)
        assert cache["blocks"][0]["s"].dtype == torch.float32
        assert cache["blocks"][0]["x_cm"].dtype == getattr(torch, dtype)
        step = S.make_decode_step(cfg, rt, b, t)
        dec = []
        for i in range(t):
            lg, cache = step(p, cache, torch.tensor(tokens[:, i]), i)
            dec.append(lg.float().numpy())
    dec = np.stack(dec, 1)
    _close(dec, fwd.float().numpy().reshape(b, t, -1), SERVE_TOL)
    jcache = JS.init_decode_cache(jcfg, rt1, b, t)
    jstep = jax.jit(JS.make_decode_step(jcfg, rt1, b, t))
    jdec = []
    for i in range(t):
        lg, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, i]),
                           jnp.int32(i))
        jdec.append(np.asarray(lg, np.float32))
    _close(dec, np.stack(jdec, 1), MOD_TOL[dtype] if dtype == "float32"
           else SERVE_TOL)


@pytest.mark.parametrize("arch", [W.ARCH, "llama3.2-3b"])
def test_bridge_keeps_every_leaf_in_the_references_dtype(rt1, arch):
    """bf16 models: each bridged leaf's dtype is the reference leaf's
    (RWKV's float32 bases, bonus and group-norm leaves included), and the
    port's own init makes the same tree of dtypes."""
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jtree = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
    jp = _flatten(jtree)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        want[key] = str(leaf.dtype)
    assert sorted(want) == sorted(jp)
    port = bridge.params_from_flat(jp, cfg, "cpu")
    own = T.init_params(cfg, seed=0, device="cpu")
    for tree in (port, own):
        got = {k: str(v).replace("torch.", "")
               for k, v in _leaf_dtypes(tree).items()}
        assert got == want
    if arch == W.ARCH:
        assert want["blocks/0/time_mix/bonus_u"] == "float32"
        assert want["blocks/0/channel_mix/w_k"] == "bfloat16"


def _leaf_dtypes(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_dtypes(v, f"{pre}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaf_dtypes(v, f"{pre}{i}/"))
        return out
    return {pre[:-1]: tree.dtype}


@pytest.mark.parametrize("name", [W.ARCH + "-reduced", W.ARCH])
def test_zero1_dims_and_bytes_match_the_reference(rt1, name):
    """Every RWKV leaf (mix_b [5, R, d], bonus_u [H, N], decay_base [d],
    ln_x, ...; stacked [n, ...]) shards on the dimension the reference's
    `zero1_spec` gives an unsharded leaf at tp = 1, at hdp 2, 4 and 8, and
    the analytic ZeRO-1 bytes are the reference's."""
    from jax.sharding import PartitionSpec as P
    from repro.parallel import zero1 as jzero1
    from repro_torch.parallel import zero1
    cfg = jax_config(name)
    abstract = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg, rt1))
    flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
    assert any("bonus_u" in str(path) for path, _ in flat)
    meta = [torch.empty(leaf.shape, dtype=getattr(torch, str(leaf.dtype)),
                        device="meta") for _, leaf in flat]
    for hdp in (2, 4, 8):
        rt = SimpleNamespace(hdp_size=hdp, hdp_axes=("data",))
        for path, leaf in flat:
            spec = jzero1.zero1_spec(P(), leaf.shape, rt)
            want = next((i for i, e in enumerate(spec) if e is not None),
                        None)
            assert zero1.zero1_dim(leaf.shape, hdp) == want, (path, hdp)
        assert zero1.zero1_bytes(meta, hdp) == \
            jzero1.zero1_bytes(abstract, rt)


def test_serving_refuses_rwkv_as_the_reference_does(rt1):
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = W.config()
    with pytest.raises(NotImplementedError):
        JServeEngine({}, _jcfg(), rt1, JServeConfig())
    with pytest.raises(NotImplementedError, match="attention-only"):
        ServeEngine({}, cfg, Runtime(device="cpu"), ServeConfig())
    with pytest.raises(NotImplementedError, match="attention-only"):
        S.make_prefill_kv_step(cfg, Runtime(device="cpu"))


# ---------------------------------------------------------------------------
# the planner's layout
# ---------------------------------------------------------------------------

def test_planner_lays_a_sharded_sequence_contiguously_in_rank_order():
    """rwkv6-7b's plans at hdp 4 (zigzag off for an attention-free
    config): each group of g > 1 ranks holds one sequence, rank j of the
    group its j-th contiguous piece at the start of its buffer; an
    attention model's are zigzagged."""
    from repro_torch.data.loader import (GlobalScheduler, SyntheticDataset,
                                         WaveMaterializer)
    seen = 0
    for arch in (W.ARCH, "llama3.2-3b"):
        cfg = get_config(arch).reduced()
        ds = SyntheticDataset("github", cfg.vocab_size, tokens_per_step=4096,
                              context=1024)
        sched = GlobalScheduler(ds, cfg, capacity=256, hdp=4,
                                strategy="balance", use_offload=False)
        try:
            plan = sched.plan_step(1)
        finally:
            sched.stop()
        mat = WaveMaterializer(ds, cfg, 256)
        for w in plan.waves:
            c = 256 * w.c_mult
            start = 0
            for g in w.composition:
                slots = w.slots[start:start + g]
                start += g
                if g == 1:
                    continue
                pieces = [p for s in slots for p in s]
                contiguous = (len(pieces) == g and all(
                    len(s) == 1 for s in slots) and all(
                    a.end == b.start for a, b in zip(pieces, pieces[1:])))
                assert contiguous == (arch == W.ARCH), (arch, w.slots)
                if arch != W.ARCH:
                    continue
                seen += 1
                lw = mat.materialize(1, w)
                for j, p in enumerate(pieces):
                    r = start - g + j
                    rows = slice(r * c, r * c + p.length)
                    assert (lw.batch["seg"][rows] == p.seq_id + 1).all()
                    np.testing.assert_array_equal(
                        lw.batch["pos"][rows], np.arange(p.start, p.end))
    assert seen >= 2


# ---------------------------------------------------------------------------
# sequences sharded over HDP ranks (the gloo ranks)
# ---------------------------------------------------------------------------

def _ranks_of(name):
    return (0, 1) if name == "2-flush" else (2, 3) if name == "2-ragged" \
        else tuple(range(W.R))


def _gathered(ranks, name):
    logits = np.concatenate([ranks[r][f"{name}/logits"]
                             for r in _ranks_of(name)])
    loss = sum(float(ranks[r][f"{name}/loss"]) for r in _ranks_of(name))
    pre = f"{name}/grad/"
    keys = [k[len(pre):] for k in ranks[_ranks_of(name)[0]]
            if k.startswith(pre)]
    grads = {k: sum(ranks[r][pre + k] for r in _ranks_of(name))
             for k in keys}
    return loss, logits, grads


@pytest.mark.parametrize("name", list(W.WAVES))
def test_sharded_wave_matches_hdp1(runs, rt1, port_params, name):
    """The port at hdp g: each rank's logits, the summed loss shares and
    the summed gradients against hdp = 1 over the same sequences laid
    contiguously, the port's and the reference's; no ``"ring"`` bytes,
    and the ledger predicts none, as the reference's does."""
    ranks = _result(runs, "torch")
    batch = W.wave_batch(name, 512)
    compact, valid = W.compacted(batch)
    loss, logits, grads = _gathered(ranks, name)
    for ref_loss, ref_logits, ref_grads in (_port_wave(port_params, compact),
                                            _jax_wave(rt1, runs["jp"],
                                                      compact)):
        _close(loss, ref_loss, RING_TOL)
        _close(logits[valid], ref_logits[:len(valid)], RING_TOL)
        for k, g in grads.items():
            _close(g, ref_grads[k], RING_TOL, k)
    comp = W.WAVES[name][0]
    assert all(float(ranks[r][f"{name}/ring_bytes"]) == 0.0
               for r in _ranks_of(name))
    cfg = W.config()
    assert ledger.wave_ring_bytes(cfg, comp, W.C) == \
        jledger.wave_ring_bytes(_jcfg(), comp, W.C) == 0
    assert ledger.ring_meta_bytes(cfg, comp) == 0


@pytest.mark.parametrize("name", JAX_HDP_WAVES)
def test_sharded_wave_against_the_references_sharded_run(runs, name):
    """The reference's own run of the wave over g host devices.  Where
    every piece fills its rank's buffer it equals the port's.  Where the
    planner's layout leaves padding after a piece ("ragged"), the
    reference passes the buffer's last row (padding, segment 0) across
    the rank boundary and so restarts the sequence's token shift and
    state there: it departs from hdp = 1, and the port, which passes the
    last non-padding row, does not (test_sharded_wave_matches_hdp1)."""
    ranks = _result(runs, "torch")
    ref = _result(runs, "jax")
    loss, logits, grads = _gathered(ranks, name)
    valid = W.wave_batch(name, 512)["seg"] > 0
    j_logits = ref[f"{name}/logits"]
    if name.endswith("flush"):
        _close(loss, float(ref[f"{name}/loss"]), RING_TOL)
        _close(logits[valid], j_logits[valid], RING_TOL)
        for k, g in grads.items():
            _close(g, ref[f"{name}/grad/{k}"], RING_TOL, k)
    else:
        assert np.abs(logits[valid] - j_logits[valid]).max() > 1.0
        assert abs(loss - float(ref[f"{name}/loss"])) > 1e-3


# ---------------------------------------------------------------------------
# the Trainer, decode slabs and checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(runs, rt1):
    """The reference's `Trainer` at hdp = 1 (its initial parameters are
    the worker's) and the port's, `W.STEPS` steps each."""
    jcfg = _jcfg()
    ds = JDataset(JDist(*W.DIST), jcfg.vocab_size,
                  tokens_per_step=W.TRAIN_TOKENS, context=W.TRAIN_CONTEXT)
    sched = JScheduler(ds, jcfg, capacity=W.TRAIN_CAP, hdp=1,
                       use_offload=False)
    jtr = JTrainer(jcfg, rt1, JAdamWConfig(lr=W.LR,
                                           total_steps=W.TOTAL_STEPS),
                   sched, JTrainerConfig(capacity=W.TRAIN_CAP,
                                         calibrate=False))
    flat0 = _flatten(jtr.params)
    jax_hist = {"loss": []}
    try:
        for s in range(W.STEPS):
            jax_hist["loss"].append(jtr.train_step()["loss"])
            jax_hist[s + 1] = _flatten(jtr.params)
    finally:
        sched.stop()
    port: dict = {}
    ptr = W.train_steps(None, flat0, port)
    return {"flat0": flat0, "jax": jax_hist, "jtr": jtr, "port": port,
            "ptr": ptr}


@pytest.mark.parametrize("hdp", [1, 2])
def test_trainer_steps_match_the_reference(runs, trained, hdp):
    """2 steps from the reference's initial weights: losses within 1e-4
    relative and each step's update within 1e-3 relative L2 per leaf of
    the reference's `Trainer` at hdp = 1.  At hdp = 2 the planner shards
    sequences over both ranks, pieces shorter than the buffer among
    them."""
    flat0 = trained["flat0"]
    jp0 = _flatten(runs["jp"])
    assert all(np.array_equal(flat0[k], jp0[k]) for k in jp0)
    got = trained["port"] if hdp == 1 else _result(runs, "torch")[0]
    if hdp == 2:
        assert list(got["train/applied"]) == [1] * W.STEPS
        assert int(got["train/sharded_ragged"]) > 0
    _close(np.asarray(got["train/loss"]), np.asarray(
        trained["jax"]["loss"]), TRAIN_TOL)
    prev = flat0
    for s in range(1, W.STEPS + 1):
        want = trained["jax"][s]
        for k in flat0:
            up = np.asarray(got[f"train/p{s}/{k}"]) - prev[k]
            ref = want[k] - prev[k]
            rel = np.linalg.norm(up - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= UPDATE_TOL, (s, k, rel)
        prev = want


@pytest.mark.parametrize("layout", list(W.DECODE_SLOTS))
def test_decode_slabs_at_hdp2_match_hdp1(runs, port_params, layout):
    """Ranks 2 and 3: under ``"batch"`` each holds and decodes its slots'
    state, under ``"seq"`` both hold every slot's whole state and compute
    the same update; each step's logits equal hdp = 1's."""
    ranks = _result(runs, "torch")
    want = W.decode_logits(port_params, W.config(), None, layout)
    got = [ranks[r][f"decode/{layout}"] for r in (2, 3)]
    if layout == "batch":
        half = W.DECODE_SLOTS[layout] // 2
        assert got[0].shape[1] == half
        _close(np.concatenate(got, axis=1), want, 1e-6)
    else:
        assert got[0].shape == want.shape
        np.testing.assert_array_equal(got[0], got[1])
        _close(got[0], want, 1e-6)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_restores_in_the_other_package(tmp_path, trained, writer):
    """The trained Trainers' parameters and AdamW state: one package saves
    them, the other restores them exactly."""
    jtr, ptr = trained["jtr"], trained["ptr"]
    ds = {"step": W.STEPS}
    if writer == "torch":
        CheckpointManager(str(tmp_path), async_save=False).save(
            W.STEPS, ptr.params, ptr.opt_state, ds)
        jp, jo, jds = JManager(str(tmp_path)).restore(
            W.STEPS, jtr.params, jtr.opt_state)
        assert jds == ds
        for got, want in ((jp, ptr.params), (jo, ptr.opt_state)):
            g, w = _flatten(got), flatten(want)
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k], np.float32),
                                              np.asarray(w[k], np.float32),
                                              err_msg=k)
    else:
        JManager(str(tmp_path), async_save=False).save(
            W.STEPS, jtr.params, jtr.opt_state, ds)
        like_p = tree_map(torch.zeros_like, ptr.params)
        like_o = tree_map(torch.zeros_like, ptr.opt_state)
        step, p2, o2, got_ds = CheckpointManager(str(tmp_path)) \
            .restore_latest(like_p, like_o)
        assert step == W.STEPS and got_ds == ds
        for got, want in ((p2, jtr.params), (o2, jtr.opt_state)):
            g, w = flatten(got), _flatten(want)
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert p2["blocks"][0]["time_mix"]["bonus_u"].dtype == torch.float32
