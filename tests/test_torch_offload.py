"""Selective activation offload on the port (``remat="offload"``) against
its own ``"full"`` route and against the reference, on reduced
llama3.2-3b in float32 with 4 layers (so that 0 < k < n is reachable):

* the loss and every gradient bit-equal to ``"full"`` at k in {0, 1, n},
  under both ``attn_impl`` (the copies are exact and the recompute is the
  same);
* the host copies move exactly the inputs of the first k periods, each
  way, and nothing else: k·T·d·itemsize bytes;
* the reference's ``forward_hidden`` under ``remat="offload"`` (as
  `tests/test_offload.py` runs it) and its gradients against the port's
  on the same bridged weights;
* 3 steps of the reference's `Trainer` at ``use_offload=True`` against the
  port's: the same plans (with an offloading wave in them), per-wave
  losses, step losses and grad norms within `test_torch_train.py`'s
  F32_TOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config as jax_config
from repro.data.distribution import LengthDistribution as JDist
from repro.data.loader import GlobalScheduler as JScheduler
from repro.data.loader import SyntheticDataset as JDataset
from repro.models import transformer as JT
from repro.obs.numerics import plan_fingerprint as jax_fingerprint
from repro.optim import adamw as jadamw
from repro.train import train_step as JS
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.offload import offload_periods
from repro_torch.data.distribution import LengthDistribution
from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
from repro_torch.models import transformer as T
from repro_torch.obs.numerics import plan_fingerprint
from repro_torch.optim import adamw
from repro_torch.parallel.host_offload import HostOffload
from repro_torch.parallel.sharding import Runtime
from repro_torch.train import train_step as S
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "llama3.2-3b"
LAYERS = 4
F32_TOL = 1e-4                              # tests/test_torch_train.py
DIST = ("tiny", 4.5, 0.8, 0.1, 1.5, 256)    # tests/test_system.py
IMPLS = ("flash", "ref")


def _cfgs():
    return tuple(dataclasses.replace(c.reduced(), dtype="float32",
                                     num_layers=LAYERS)
                 for c in (jax_config(ARCH), get_config(ARCH)))


@pytest.fixture(scope="module")
def bridged(rt1):
    jcfg, cfg = _cfgs()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
    return jcfg, jp, cfg, bridge.params_from_flat(_flatten(jp), cfg, "cpu")


def _wave(seed: int, vocab: int, lens, t: int):
    rng = np.random.RandomState(seed)
    w = {k: np.zeros(t, np.int32) for k in ("tokens", "labels", "seg",
                                            "pos")}
    cur = 0
    for i, n in enumerate(lens):
        w["tokens"][cur:cur + n] = rng.randint(0, vocab, n)
        w["labels"][cur:cur + n] = rng.randint(0, vocab, n)
        w["seg"][cur:cur + n] = i + 1
        w["pos"][cur:cur + n] = np.arange(n)
        cur += n
    return w


def _grad_step(cfg, params, batch, **rt_kw):
    rt = Runtime(device="cpu", **rt_kw)
    grad_step, _ = S.make_accum_steps(cfg, rt, adamw.AdamWConfig())
    acc, m = grad_step(params, S.zeros_accum(params), batch, rt)
    return m["loss"], leaves(acc)


@pytest.mark.parametrize("k", [0, 1, LAYERS])
@pytest.mark.parametrize("impl", IMPLS)
def test_offload_is_bit_equal_to_full_remat(bridged, impl, k):
    _, _, cfg, tp = bridged
    w = _wave(0, cfg.vocab_size, [70, 40, 9], 128)
    batch = {key: torch.tensor(v) for key, v in w.items()}
    batch["denom"] = torch.tensor(119.0)
    loss_f, grads_f = _grad_step(cfg, tp, batch, attn_impl=impl,
                                 remat="full")
    store = HostOffload(torch.device("cpu"))
    loss_o, grads_o = _grad_step(cfg, tp, batch, attn_impl=impl,
                                 remat="offload", offload_periods=k,
                                 offload_store=store)
    assert torch.equal(loss_o, loss_f)
    assert len(grads_o) == len(grads_f) > 5
    for a, b in zip(grads_o, grads_f):
        assert torch.equal(a, b)
    moved = k * 128 * cfg.d_model * 4
    assert store.d2h_bytes == store.h2d_bytes == moved


@pytest.mark.parametrize("impl", IMPLS)
def test_offload_moves_exactly_the_leading_period_inputs(bridged, impl):
    """The host buffers hold period 0 and 1's inputs bit for bit (the
    embedding's output, then period 0's), and no other tensor crosses:
    two buffers, 2·T·d·4 bytes each way."""
    _, _, cfg, tp = bridged
    t, k = 96, 2
    w = _wave(1, cfg.vocab_size, [50, 30], t)
    batch = {key: torch.tensor(v) for key, v in w.items()}
    batch["denom"] = torch.tensor(80.0)
    store = HostOffload(torch.device("cpu"))
    _grad_step(cfg, tp, batch, attn_impl=impl, remat="offload",
               offload_periods=k, offload_store=store)
    rt = Runtime(device="cpu", attn_impl=impl)
    with torch.no_grad():
        x = T.embed_frontend(tp, cfg, rt, batch)
        inputs = []
        for i in range(LAYERS):
            inputs.append(x)
            x = T.block_forward(T._index(tp["blocks"][0], i), cfg, rt, x,
                                batch["seg"], batch["pos"], 0)
    assert sorted(store._host) == list(range(k))
    for i in range(k):
        assert torch.equal(store.host_view(i), inputs[i])
    assert store.pinned_bytes == k * t * cfg.d_model * 4
    assert store.d2h_bytes == store.h2d_bytes == k * t * cfg.d_model * 4


@pytest.mark.parametrize("k", [1, LAYERS])
def test_offload_forward_and_grads_match_jax(bridged, rt1, k):
    """The reference's forward_hidden under remat="offload" (jitted, the
    residuals in pinned_host memory, as tests/test_offload.py runs it) and
    its accumulated wave gradients, against the port's."""
    jcfg, jp, cfg, tp = bridged
    w = _wave(2, cfg.vocab_size, [60, 33, 20], 128)
    jrt = dataclasses.replace(rt1, remat="offload", offload_periods=k)
    jb = {key: jnp.array(v) for key, v in w.items()}
    jb["denom"] = jnp.float32(113.0)
    jh = jax.jit(lambda p, b: JT.forward_hidden(p, jcfg, jrt, b))(jp, jb)
    jstep, _ = JS.make_accum_steps(jcfg, jrt, jadamw.AdamWConfig())
    jacc, jm = jax.jit(lambda p, g, b: jstep(p, g, b, jrt))(
        jp, jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp), jb)
    tb = {key: torch.tensor(v) for key, v in w.items()}
    tb["denom"] = torch.tensor(113.0)
    rt = Runtime(device="cpu", attn_impl="ref", remat="offload",
                 offload_periods=k, offload_store=HostOffload(
                     torch.device("cpu")))
    with torch.enable_grad():           # the offload route needs grad
        h = T.forward_hidden(tp, cfg, rt, tb)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               atol=F32_TOL, rtol=F32_TOL)
    grad_step, _ = S.make_accum_steps(cfg, rt, adamw.AdamWConfig())
    acc, m = grad_step(tp, S.zeros_accum(tp), tb, rt)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=F32_TOL)
    got, want = bridge.params_to_flat(acc), _flatten(jacc)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=key)


def _record_plans(sched, fingerprint, out):
    plan_step = sched.plan_step

    def wrapped(step):
        plan = plan_step(step)
        out.append(fingerprint(plan))
        return plan

    sched.plan_step = wrapped


def _datasets(pkg_dist, pkg_ds, vocab):
    return pkg_ds(pkg_dist(*DIST), vocab, tokens_per_step=1024, context=512)


@pytest.fixture(scope="module")
def jax_offload_history(rt1):
    jcfg, _ = _cfgs()
    sched = JScheduler(_datasets(JDist, JDataset, jcfg.vocab_size), jcfg,
                       capacity=256, hdp=1, use_offload=True)
    plans, wave_losses = [], []
    _record_plans(sched, jax_fingerprint, plans)
    tr = JTrainer(jcfg, rt1, jadamw.AdamWConfig(lr=1e-3, total_steps=8),
                  sched, JTrainerConfig(capacity=256, attn_impl="ref",
                                        calibrate=False, use_offload=True))
    assert tr.offload_ok
    observe = tr.numerics.observe_wave

    def observe_wave(step, i, loss):
        wave_losses.append((step, float(loss)))
        return observe(step, i, loss)
    tr.numerics.observe_wave = observe_wave
    p0 = _flatten(tr.params)
    hist = [tr.train_step() for _ in range(3)]
    sched.stop()
    return p0, hist, plans, wave_losses


def test_three_offload_steps_match_jax_trainer(jax_offload_history):
    """The oracle attention route (the offload route itself is held under
    both attn_impl by the bit-equality test above)."""
    p0, jhist, jplans, jwaves = jax_offload_history
    _, cfg = _cfgs()
    sched = GlobalScheduler(_datasets(LengthDistribution, SyntheticDataset,
                                      cfg.vocab_size), cfg, capacity=256,
                            hdp=1, use_offload=True)
    plans = []
    _record_plans(sched, plan_fingerprint, plans)
    tr = Trainer(cfg, Runtime(device="cpu", attn_impl="ref"),
                 adamw.AdamWConfig(lr=1e-3, total_steps=8), sched,
                 TrainerConfig(capacity=256, calibrate=False,
                               use_offload=True),
                 params=bridge.params_from_flat(p0, cfg, "cpu"))
    hist, waves = [], []
    for _ in range(3):
        hist.append(tr.train_step())
        waves += tr.last_numerics["wave_losses"]
    sched.stop()
    assert sched.spec.use_offload and tr.offload_ok
    assert plans == jplans and len(set(plans)) == 3
    offloaded = [(key, rt.offload_periods) for key, rt in
                 tr._exec_cache.items() if rt.remat == "offload"]
    assert offloaded and all(key[2] > 0 and k >= 1 for key, k in offloaded)
    assert all(k == offload_periods(cfg, key[2]) for key, k in offloaded)
    assert any(k < LAYERS for _, k in offloaded)
    np.testing.assert_allclose(waves, [l for _, l in jwaves], rtol=F32_TOL)
    for got, want in zip(hist, jhist):
        assert got["waves"] == want["waves"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=F32_TOL)
    assert tr.last_numerics["applied"] == 1


def test_one_store_serves_waves_of_every_size(bridged):
    """The trainer's one store across waves of 128, 64 and 128 tokens:
    each period's buffer grows to the largest wave and is reused, so the
    pinned bytes stay at k of the largest wave's inputs, and every wave
    still matches the full route bit for bit."""
    _, _, cfg, tp = bridged
    store, k = HostOffload(torch.device("cpu")), 2
    for seed, t in ((3, 128), (4, 64), (5, 128)):
        w = _wave(seed, cfg.vocab_size, [t // 2, t // 4], t)
        batch = {key: torch.tensor(v) for key, v in w.items()}
        batch["denom"] = torch.tensor(float(t // 2 + t // 4))
        loss_f, grads_f = _grad_step(cfg, tp, batch, attn_impl="ref",
                                     remat="full")
        loss_o, grads_o = _grad_step(cfg, tp, batch, attn_impl="ref",
                                     remat="offload", offload_periods=k,
                                     offload_store=store)
        assert torch.equal(loss_o, loss_f)
        assert all(torch.equal(a, b) for a, b in zip(grads_o, grads_f))
        assert store.host_view(0).shape == (t, cfg.d_model)
        assert store.pinned_bytes == k * 128 * cfg.d_model * 4


def test_offload_needs_a_store(bridged):
    _, _, cfg, tp = bridged
    w = _wave(6, cfg.vocab_size, [40], 64)
    batch = {key: torch.tensor(v) for key, v in w.items()}
    batch["denom"] = torch.tensor(40.0)
    with pytest.raises(ValueError, match="offload_store"):
        _grad_step(cfg, tp, batch, attn_impl="ref", remat="offload",
                   offload_periods=1)


def test_runtime_checks_remat_settings():
    assert Runtime(device="cpu", remat="offload",
                   offload_periods=3).offload_periods == 3
    with pytest.raises(ValueError, match="remat"):
        Runtime(device="cpu", remat="dots")
    with pytest.raises(ValueError, match="offload_periods"):
        Runtime(device="cpu", remat="offload", offload_periods=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, LAYERS])
def test_cuda_offload_is_bit_equal_to_full_remat(k):
    """On the card, through the kernels (llama3.2-3b's width, whose head
    dim they take, cut to 4 layers): pinned host buffers and the copy
    stream give the full route's loss and gradients bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_config(ARCH), num_layers=LAYERS)
    params = T.init_params(cfg, seed=0, device="cuda")
    t = 512
    w = _wave(4, cfg.vocab_size, [300, 150, 40], t)
    batch = {key: torch.tensor(v, device="cuda") for key, v in w.items()}
    batch["denom"] = torch.tensor(490.0, device="cuda")

    def run(**rt_kw):
        rt = Runtime(device="cuda", **rt_kw)
        grad_step, _ = S.make_accum_steps(cfg, rt, adamw.AdamWConfig())
        acc, m = grad_step(params, S.zeros_accum(params), batch, rt)
        return m["loss"], leaves(acc)

    loss_f, grads_f = run(remat="full")
    store = HostOffload(torch.device("cuda", torch.cuda.current_device()))
    loss_o, grads_o = run(remat="offload", offload_periods=k,
                          offload_store=store)
    assert torch.equal(loss_o, loss_f)
    for a, b in zip(grads_o, grads_f):
        assert torch.equal(a, b)
    assert store.d2h_bytes == store.h2d_bytes == k * t * cfg.d_model * 2
    assert all(buf.is_pinned() for buf in store._host.values())
    assert store.busy_ms() > 0
