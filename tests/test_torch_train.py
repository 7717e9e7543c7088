"""The port's training slice against the reference on reduced llama3.2-3b
with bridged weights: the token-level loss, wave-accumulated gradients,
one AdamW apply and the guarded skip, and a 3-step loss / grad-norm
history against the reference's `Trainer` on identical plans, for
reduced llama3.2-3b and reduced Mistral-8x7B (MoE)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config as jax_config
from repro.core.loss import token_ce_loss as jax_token_ce_loss
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
from repro_torch.core.loss import token_ce_loss
from repro_torch.data.distribution import LengthDistribution
from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
from repro_torch.models import transformer as T
from repro_torch.obs.numerics import plan_fingerprint
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import Runtime
from repro_torch.train import train_step as S
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves

ARCH = "llama3.2-3b"
MOE_ARCH = "mistral-8x7b"
F32_TOL = 1e-4
DIST = ("tiny", 4.5, 0.8, 0.1, 1.5, 256)      # tests/test_system.py


def _cfgs(arch=ARCH):
    return (dataclasses.replace(jax_config(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _to_port(tree, cfg):
    return bridge.params_from_flat(_flatten(tree), cfg, "cpu")


def _flat(tree):
    return bridge.params_to_flat(tree)


@pytest.fixture(scope="module")
def bridged(rt1):
    jcfg, cfg = _cfgs()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
    return jcfg, jp, cfg, _to_port(jp, cfg)


def _wave(rng, vocab, lens, t):
    """One packed wave of the given sequence lengths, padding after."""
    tok = np.zeros(t, np.int32)
    lab = np.zeros(t, np.int32)
    seg = np.zeros(t, np.int32)
    pos = np.zeros(t, np.int32)
    cur = 0
    for i, n in enumerate(lens):
        tok[cur:cur + n] = rng.randint(0, vocab, n)
        lab[cur:cur + n] = rng.randint(0, vocab, n)
        seg[cur:cur + n] = i + 1
        pos[cur:cur + n] = np.arange(n)
        cur += n
    return {"tokens": tok, "labels": lab, "seg": seg, "pos": pos}


def _batches(w, denom):
    jb = {k: jnp.array(v) for k, v in w.items()}
    jb["denom"] = jnp.float32(denom)
    tb = {k: torch.tensor(v) for k, v in w.items()}
    tb["denom"] = torch.tensor(denom, dtype=torch.float32)
    return jb, tb


@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_token_ce_loss_matches_jax(bridged, rt1, impl):
    jcfg, jp, cfg, tp = bridged
    w = _wave(np.random.RandomState(0), cfg.vocab_size, [20, 33, 5], 64)
    jb, tb = _batches(w, 50.0)
    jh = JT.forward_hidden(jp, jcfg, rt1, jb)
    want, jm = jax_token_ce_loss(jp, jcfg, rt1, jh, jb["labels"], jb["seg"],
                                 jb["denom"])
    rt = Runtime(device="cpu", attn_impl=impl)
    h = T.forward_hidden(tp, cfg, rt, tb)
    got, m = token_ce_loss(tp, cfg, rt, h, tb["labels"], tb["seg"],
                           tb["denom"])
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_TOL)
    np.testing.assert_allclose(m["nll_sum"].item(), float(jm["nll_sum"]),
                               rtol=F32_TOL)
    assert m["tokens"].item() == float(jm["tokens"]) == 58


WAVES = [[40, 20], [64], [17, 30, 9]]


@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_wave_accumulated_grads(bridged, rt1, impl):
    """Eq. 1–2 on the port: three waves accumulated equal one full batch
    (tests/test_loss_equiv.py's 2e-2), and match the reference's
    accumulated grads within 1e-4."""
    jcfg, jp, cfg, tp = bridged
    rng = np.random.RandomState(1)
    waves = [_wave(rng, cfg.vocab_size, lens, 64) for lens in WAVES]
    denom = float(sum(sum(lens) for lens in WAVES))
    opt = adamw.AdamWConfig()
    rt = Runtime(device="cpu", attn_impl=impl)
    grad_step, _ = S.make_accum_steps(cfg, rt, opt)
    acc = S.zeros_accum(tp)
    jstep, _ = JS.make_accum_steps(jcfg, rt1, jadamw.AdamWConfig())
    jgrad_step = jax.jit(lambda p, g, b: jstep(p, g, b, rt1))
    jacc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    losses = []
    for w in waves:
        jb, tb = _batches(w, denom)
        acc, m = grad_step(tp, acc, tb, rt)
        jacc, jm = jgrad_step(jp, jacc, jb)
        losses.append((m["loss"].item(), float(jm["loss"])))
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=F32_TOL)
    got, want = _flat(acc), _flatten(jacc)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=key)
    # the same tokens as one packed batch
    full = {k: np.concatenate([w[k] for w in waves]) for k in waves[0]}
    seg = np.concatenate([np.where(w["seg"] > 0, w["seg"] + 10 * i, 0)
                          for i, w in enumerate(waves)])
    full["seg"] = seg.astype(np.int32)
    _, tb = _batches(full, denom)
    full_acc, _ = grad_step(tp, S.zeros_accum(tp), tb, rt)
    for a, b in zip(leaves(acc), leaves(full_acc)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2,
                                   rtol=2e-2)


def test_remat_recomputes_the_same_grads(bridged):
    _, _, cfg, tp = bridged
    w = _wave(np.random.RandomState(2), cfg.vocab_size, [30, 25], 64)
    _, tb = _batches(w, 55.0)
    out = []
    for remat in ("none", "full"):
        rt = Runtime(device="cpu", remat=remat)
        grad_step, _ = S.make_accum_steps(cfg, rt, adamw.AdamWConfig())
        out.append(grad_step(tp, S.zeros_accum(tp), tb, rt)[0])
    for a, b in zip(leaves(out[0]), leaves(out[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)


def _opt_inputs(jp, step):
    """Reference-side grads and a mid-run optimiser state from numpy."""
    rng = np.random.RandomState(3)
    r = lambda p, s=1.0: jnp.array(rng.randn(*p.shape) * s,  # noqa: E731
                                   jnp.float32)
    grads = jax.tree.map(lambda p: r(p, 0.05), jp)
    state = {"step": jnp.int32(step),
             "master": jax.tree.map(lambda p: p.astype(jnp.float32), jp),
             "m": jax.tree.map(lambda p: r(p, 0.01), jp),
             "v": jax.tree.map(lambda p: jnp.abs(r(p, 1e-4)), jp)}
    return grads, state


def _state_to_port(state, cfg):
    return {"step": torch.tensor(int(state["step"]), dtype=torch.int32),
            **{k: _to_port(state[k], cfg) for k in ("master", "m", "v")}}


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_apply_matches_jax(bridged, clip):
    """One f32 apply on identical params, grads and state: params, master,
    m, v within 1e-6, the step counter and the sentinels equal."""
    jcfg, jp, cfg, _ = bridged
    grads, state = _opt_inputs(jp, 4)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=clip)
    _, japply = JS.make_accum_steps(jcfg, None, jadamw.AdamWConfig(**ocfg),
                                    guard=True)
    jp2, js2, jom = jax.jit(japply)(jp, state, grads)
    tp = _to_port(jp, cfg)
    ts = _state_to_port(state, cfg)
    _, apply_step = S.make_accum_steps(cfg, Runtime(device="cpu"),
                                       adamw.AdamWConfig(**ocfg), guard=True)
    tp2, ts2, om = apply_step(tp, ts, _to_port(grads, cfg))
    assert tp2 is tp and ts2 is ts                       # in place
    assert int(ts2["step"]) == int(js2["step"]) == 5
    for got, want in ((tp2, jp2), *((ts2[k], js2[k])
                                    for k in ("master", "m", "v"))):
        g, w = _flat(got), _flatten(want)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], atol=1e-6, rtol=1e-6,
                                       err_msg=key)
    assert sorted(om) == sorted(jom)
    for key, want in jom.items():
        np.testing.assert_allclose(float(om[key]), float(want), rtol=1e-5,
                                   err_msg=key)


def test_guarded_apply_skips_nonfinite_grads_bit_exactly(bridged):
    jcfg, jp, cfg, _ = bridged
    grads, state = _opt_inputs(jp, 4)
    tp = _to_port(jp, cfg)
    ts = _state_to_port(state, cfg)
    tg = _to_port(grads, cfg)
    tg["blocks"][0]["mlp"]["w_in"][1, 3, 5] = float("nan")
    before = (_flat(tp), {k: _flat(ts[k]) for k in ("master", "m", "v")})
    _, apply_step = S.make_accum_steps(cfg, Runtime(device="cpu"),
                                       adamw.AdamWConfig(lr=1e-3),
                                       guard=True)
    _, _, om = apply_step(tp, ts, tg)
    assert int(om["applied"]) == 0 and int(om["grad_nonfinite"]) == 1
    assert int(ts["step"]) == 4
    for got, want in ((_flat(tp), before[0]),
                      *((_flat(ts[k]), before[1][k])
                        for k in ("master", "m", "v"))):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # and finite grads apply
    tg["blocks"][0]["mlp"]["w_in"][1, 3, 5] = 0.0
    _, _, om = apply_step(tp, ts, tg)
    assert int(om["applied"]) == 1 and int(ts["step"]) == 5


def _record_plans(sched, fingerprint, out):
    plan_step = sched.plan_step

    def wrapped(step):
        plan = plan_step(step)
        out.append(fingerprint(plan))
        return plan

    sched.plan_step = wrapped


def _jax_history(rt1, arch):
    """The reference's `Trainer`, 3 steps -> (initial params, history,
    plan fingerprints, [(params after the step, its wave losses)])."""
    jcfg, _ = _cfgs(arch)
    ds = JDataset(JDist(*DIST), jcfg.vocab_size, tokens_per_step=1024,
                  context=512)
    sched = JScheduler(ds, jcfg, capacity=256, hdp=1, use_offload=False)
    plans = []
    _record_plans(sched, jax_fingerprint, plans)
    tr = JTrainer(jcfg, rt1, jadamw.AdamWConfig(lr=1e-3, total_steps=8),
                  sched, JTrainerConfig(capacity=256, attn_impl="ref",
                                        calibrate=False))
    p0 = _flatten(tr.params)
    waves = []
    observe = tr.numerics.observe_wave

    def observe_wave(step, i, loss):
        waves.append(float(loss))
        return observe(step, i, loss)
    tr.numerics.observe_wave = observe_wave
    hist, after = [], []
    for _ in range(3):
        hist.append(tr.train_step())
        after.append((_flatten(tr.params), list(waves)))
        waves.clear()
    sched.stop()
    return p0, hist, plans, after


@pytest.fixture(scope="module")
def jax_history(rt1):
    return _jax_history(rt1, ARCH)


@pytest.fixture(scope="module")
def jax_moe_history(rt1):
    return _jax_history(rt1, MOE_ARCH)


def _port_history(history, impl, arch=ARCH):
    """The port's `Trainer` from the reference's initial params on the
    same data, held to the reference's 3-step history -> (the trainer,
    [(params after each step, its wave losses)])."""
    p0, jhist, jplans, _ = history
    _, cfg = _cfgs(arch)
    ds = SyntheticDataset(LengthDistribution(*DIST), cfg.vocab_size,
                          tokens_per_step=1024, context=512)
    sched = GlobalScheduler(ds, cfg, capacity=256, hdp=1, use_offload=False)
    plans = []
    _record_plans(sched, plan_fingerprint, plans)
    tr = Trainer(cfg, Runtime(device="cpu", attn_impl=impl),
                 adamw.AdamWConfig(lr=1e-3, total_steps=8), sched,
                 TrainerConfig(capacity=256, calibrate=False),
                 params=bridge.params_from_flat(p0, cfg, "cpu"))
    hist, after = [], []
    for _ in range(3):
        hist.append(tr.train_step())
        after.append((bridge.params_to_flat(tr.params),
                      list(tr.last_numerics["wave_losses"])))
    sched.stop()
    assert plans == jplans and len(set(plans)) == 3
    for got, want in zip(hist, jhist):
        assert got["waves"] == want["waves"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=F32_TOL)
    assert tr.last_numerics["applied"] == 1
    assert all(np.isfinite(tr.last_numerics["wave_losses"]))
    return tr, after


@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_three_steps_match_jax_trainer(jax_history, impl):
    _port_history(jax_history, impl)


@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_moe_three_steps_match_jax_trainer(jax_moe_history, impl):
    """Reduced Mistral-8x7B: each wave's rows route as one group, padding
    rows included, in the forward and again in each period's recompute;
    the same plans, per-wave and step losses and grad norms, and every
    step's update within 1e-3 relative L2 per leaf
    (`tests/test_torch_hdp_train.py`'s hold), the router float32
    throughout."""
    tr, after = _port_history(jax_moe_history, impl, MOE_ARCH)
    assert tr.params["blocks"][0]["moe"]["router"].dtype == torch.float32
    before = jax_moe_history[0]
    for (got, got_w), (want, want_w) in zip(after, jax_moe_history[3]):
        np.testing.assert_allclose(got_w, want_w, rtol=F32_TOL)
        assert sorted(got) == sorted(want)
        assert any(key.endswith("moe/router") for key in got)
        for key in want:
            upd = want[key] - before[key]
            rel = np.linalg.norm(got[key] - before[key] - upd) \
                / np.linalg.norm(upd)
            assert rel <= 1e-3, (key, rel)
        before = want


def test_entry_points_refuse_a_missing_gpu_and_unported_settings(tmp_path):
    _, cfg = _cfgs()
    ds = SyntheticDataset(LengthDistribution(*DIST), cfg.vocab_size,
                          tokens_per_step=512, context=256)
    sched = GlobalScheduler(ds, cfg, capacity=256, hdp=1)
    opt = adamw.AdamWConfig()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, None, opt, sched, TrainerConfig(capacity=256))
        from repro_torch.launch import train as launch_train
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])
    rt = Runtime(device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        Trainer(cfg, rt, opt, sched, TrainerConfig(capacity=256, mode="pp"))
    # checkpointing is ported: ckpt_dir saves at the end of run, and a
    # fresh Trainer resumes there with the same parameters and state
    saver = Trainer(cfg, rt, opt, GlobalScheduler(ds, cfg, capacity=256,
                                                  hdp=1),
                    TrainerConfig(capacity=256, ckpt_dir=str(tmp_path)))
    for _ in saver.run(1):
        pass
    saver.sched.stop()
    assert saver.ckpt.latest_valid_step() == 1
    resumed = Trainer(cfg, rt, opt, GlobalScheduler(ds, cfg, capacity=256,
                                                    hdp=1),
                      TrainerConfig(capacity=256, ckpt_dir=str(tmp_path),
                                    ckpt_save=False), seed=1)
    assert resumed.resume_if_possible() and resumed.step == 1
    resumed.sched.stop()
    for a, b in ((saver.params, resumed.params),
                 (saver.opt_state, resumed.opt_state)):
        for x, y in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y)
    # offload execution is ported: the runtime takes remat="offload", and
    # a Trainer with use_offload keeps the spec's Eq. 3 offload term, at
    # construction and through a resize
    assert Runtime(device="cpu", remat="offload",
                   offload_periods=1).remat == "offload"
    assert sched.spec.use_offload
    tr_off = Trainer(cfg, rt, opt, sched,
                     TrainerConfig(capacity=256, use_offload=True))
    assert tr_off.offload_ok and sched.spec.use_offload
    sched_off = GlobalScheduler(ds, cfg, capacity=256, hdp=1)
    tr_off.resize(sched_off)
    assert tr_off.sched is sched_off and sched_off.spec.use_offload
    # the reference's own auto-disable: offload off in the TrainerConfig
    # turns the spec's Eq. 3 offload term off
    tr = Trainer(cfg, rt, opt, sched, TrainerConfig(capacity=256))
    assert not sched.spec.use_offload
    # resize: a scheduler of the same HDP size swaps in (with a fresh
    # calibrator), as the reference's does; another size needs a new
    # process group: a relaunch at that size restores the checkpoint
    sched2 = GlobalScheduler(ds, cfg, capacity=256, hdp=1)
    calib = tr.calib
    tr.resize(sched2)
    assert tr.sched is sched2 and tr.calib is not calib
    assert not sched2.spec.use_offload
    sched4 = GlobalScheduler(ds, cfg, capacity=256, hdp=4)
    with pytest.raises(NotImplementedError,
                       match="relaunch at 4 ranks .* item 9"):
        tr.resize(sched4)
    assert tr.sched is sched2
    for s in (sched, sched2, sched4, sched_off):
        s.stop()


def test_launcher_trains_on_the_cpu(capsys):
    from repro_torch.launch import train as launch_train
    from repro_torch.obs import ledger
    was_on = ledger.ledger_enabled()
    tr = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                            "--capacity", "256", "--tokens-per-step", "512",
                            "--context", "256", "--dataset", "tiny",
                            "--device", "cpu", "--attn-impl", "ref"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2 and len(tr.history) == 2
    assert all(np.isfinite(r["loss"]) for r in tr.history)
    # the launcher's ledger is on for its run only
    assert tr.ledger.summary()["n"] == sum(r["waves"] for r in tr.history)
    assert ledger.ledger_enabled() == was_on


def _port_trainer(tcfg, params=None):
    _, cfg = _cfgs()
    ds = SyntheticDataset(LengthDistribution(*DIST), cfg.vocab_size,
                          tokens_per_step=1024, context=512)
    sched = GlobalScheduler(ds, cfg, capacity=256, hdp=1, use_offload=False,
                            sched_async=tcfg.sched_async)
    return Trainer(cfg, Runtime(device="cpu", attn_impl="ref"),
                   adamw.AdamWConfig(lr=1e-3, total_steps=8), sched, tcfg,
                   params=params)


def test_nan_fault_skips_the_apply_and_training_goes_on():
    """The numerics drill on the port's trainer: a NaN denominator in one
    wave poisons that step's grads; the guarded apply leaves params and
    optimiser state untouched and the next step applies."""
    tr = _port_trainer(TrainerConfig(capacity=256, calibrate=False,
                                     nan_fault={"step": 1, "wave": 0}))
    tr.train_step()
    before = _flat(tr.params), int(tr.opt_state["step"])
    tr.train_step()
    assert tr.last_numerics["applied"] == 0
    assert tr.last_numerics["grad_nonfinite"] > 0
    assert not np.isfinite(tr.history[-1]["loss"])
    after = _flat(tr.params)
    for key in before[0]:
        np.testing.assert_array_equal(after[key], before[0][key], err_msg=key)
    assert int(tr.opt_state["step"]) == before[1] == 1
    rec = tr.train_step()
    assert tr.last_numerics["applied"] == 1 and np.isfinite(rec["loss"])
    assert int(tr.opt_state["step"]) == 2
    tr.sched.stop()


def test_async_planning_gives_the_sync_history():
    """Plans and materialized waves from the scheduler service's planner
    thread: the same losses and grad norms as the synchronous path."""
    hists = []
    p0 = None
    for sched_async in (False, True):
        tr = _port_trainer(TrainerConfig(capacity=256, calibrate=False,
                                         sched_async=sched_async),
                           params=p0)
        if p0 is None:
            p0 = bridge.params_from_flat(_flat(tr.params), tr.cfg, "cpu")
        hists.append([(r["loss"], r["grad_norm"], r["waves"])
                      for r in tr.run(2)])
        tr.sched.stop()
    assert hists[0] == hists[1]
