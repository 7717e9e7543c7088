"""The port's serving slice against the reference on reduced llama3.2-3b
with bridged weights: the forward, the prefill KV rows, decode-vs-forward
consistency, and the continuously batched engine, also for reduced
Mistral-8x7B (MoE)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config as jax_config
from repro.models import transformer as JT
from repro.train import serve_step as JS
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import Runtime
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import serve_step as S
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "llama3.2-3b"
F32_TOL = 1e-4
BF16_TOL = 0.08                      # tests/test_serve.py


def _cfgs(dtype):
    return (dataclasses.replace(jax_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype))


@pytest.fixture(scope="module")
def bridged(rt1):
    """dtype -> (jax cfg, jax params, port cfg, port params on the CPU),
    the port's weights bridged from the reference's init."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(dtype)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
        out[dtype] = (jcfg, jp, cfg,
                      bridge.params_from_flat(_flatten(jp), cfg, "cpu"))
    return out


def _packed(rng, lens, t, vocab):
    tok = np.zeros(t, np.int32)
    seg = np.zeros(t, np.int32)
    pos = np.zeros(t, np.int32)
    cur = 0
    for i, n in enumerate(lens):
        tok[cur:cur + n] = rng.randint(0, vocab, n)
        seg[cur:cur + n] = i + 1
        pos[cur:cur + n] = np.arange(n)
        cur += n
    return tok, seg, pos


def _batches(tok, seg, pos):
    return ({"tokens": jnp.array(tok), "seg": jnp.array(seg),
             "pos": jnp.array(pos)},
            {"tokens": torch.tensor(tok), "seg": torch.tensor(seg),
             "pos": torch.tensor(pos)})


@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_forward_hidden_and_logits_match_jax(bridged, rt1, impl):
    jcfg, jp, cfg, tp = bridged["float32"]
    rng = np.random.RandomState(0)
    jb, tb = _batches(*_packed(rng, [20, 33, 5], 64, cfg.vocab_size))
    want = JT.logits_head(jp, jcfg, JT.forward_hidden(jp, jcfg, rt1, jb))
    rt = Runtime(device="cpu", attn_impl=impl)
    got = T.logits_head(tp, cfg, T.forward_hidden(tp, cfg, rt, tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)


def test_prefill_kv_rows_match_jax(bridged, rt1):
    jcfg, jp, cfg, tp = bridged["float32"]
    rng = np.random.RandomState(1)
    jb, tb = _batches(*_packed(rng, [30, 17], 64, cfg.vocab_size))
    jh, jhead, jblock = JS.make_prefill_kv_step(jcfg, rt1)(jp, jb)
    h, head, block = S.make_prefill_kv_step(cfg, Runtime(device="cpu"))(tp,
                                                                         tb)
    assert head == [] and len(jhead) == 0
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_TOL,
                               rtol=0)
    assert len(block) == len(jblock)
    for got, want in zip(block, jblock):
        for name in ("k", "v"):
            assert tuple(got[name].shape) == want[name].shape
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), atol=F32_TOL,
                                       rtol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_decode_matches_forward(dtype, tol):
    """Teacher-forced decode through the in-place cache reproduces the
    packed forward position by position (the port's own weights)."""
    _, cfg = _cfgs(dtype)
    params = T.init_params(cfg, seed=0, device="cpu")
    rt = Runtime(device="cpu")
    t, b = 24, 2
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (b, t))
    batch = {"tokens": torch.tensor(tokens.reshape(-1), dtype=torch.int32),
             "seg": torch.tensor(np.repeat([1, 2], t), dtype=torch.int32),
             "pos": torch.tensor(np.tile(np.arange(t), b),
                                 dtype=torch.int32)}
    ref = T.logits_head(params, cfg, T.forward_hidden(params, cfg, rt,
                                                      batch))
    ref = ref.reshape(b, t, -1).float()
    cache = S.init_decode_cache(cfg, rt, b, t)
    step = S.make_decode_step(cfg, rt, b, t)
    outs = []
    for i in range(t):
        lg, cache = step(params, cache, torch.tensor(tokens[:, i]), i)
        outs.append(lg.float())
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               atol=tol, rtol=tol)


MIX = [(9, 5), (17, 4), (5, 6)]          # tests/test_serve.py pool mix


def _jax_engine(jcfg, jp, rt1, prompts):
    from repro.serve import ServeConfig as JConfig, ServeEngine as JEngine
    eng = JEngine(jp, jcfg, rt1, JConfig(max_slots=4, max_context=64,
                                          prefill_capacity=64,
                                          collect_logits=True))
    rids = [eng.submit(p, m) for p, (_, m) in zip(prompts, MIX)]
    eng.drain(max_steps=200)
    return [eng.pool.get(r) for r in rids]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_pool_parity_with_jax(bridged, rt1, dtype):
    """The same pool through both engines: in float32 the greedy tokens
    are identical and the logits within 1e-4; in bf16 the logits agree
    within 0.08 up to the first greedy divergence (ties round apart)."""
    jcfg, jp, cfg, tp = bridged[dtype]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n, _ in MIX]
    want = _jax_engine(jcfg, jp, rt1, prompts)
    eng = ServeEngine(tp, cfg, Runtime(device="cpu"), ServeConfig(
        max_slots=4, max_context=64, prefill_capacity=64,
        collect_logits=True))
    rids = [eng.submit(p, m) for p, (_, m) in zip(prompts, MIX)]
    done = eng.drain(max_steps=200)
    assert sorted(r.rid for r in done) == sorted(rids)
    assert eng.stats["prefill_waves"] >= 1
    for rid, w in zip(rids, want):
        got = eng.pool.get(rid)
        g_rows = np.stack(got.logits)
        w_rows = np.stack(w.logits).astype(np.float32)
        if dtype == "float32":
            assert got.generated == w.generated
            np.testing.assert_allclose(g_rows, w_rows, atol=F32_TOL, rtol=0)
        else:
            n = 1
            while (n < len(got.generated)
                   and got.generated[n - 1] == w.generated[n - 1]):
                n += 1
            np.testing.assert_allclose(g_rows[:n], w_rows[:n],
                                       atol=BF16_TOL, rtol=BF16_TOL)
    assert sorted(rec["rid"] for rec in eng.records) == sorted(rids)


def test_engine_runs_on_after_a_request_fills_its_context(bridged, rt1):
    """A request that stops at ``max_context`` leaves its slot at a
    position past the slab; the next decode waves feed that free slot
    there, and its write wraps round the slab as the reference's
    ``pos % seq_len`` does (it once indexed past the slab and raised),
    while the other request decodes on: the reference engine's tokens,
    logits within 1e-4."""
    jcfg, jp, cfg, tp = bridged["float32"]
    from repro.serve import ServeConfig as JConfig, ServeEngine as JEngine
    pool = [(np.arange(10) + 1, 20), (np.arange(3) + 1, 12)]
    outs = []
    for eng in (JEngine(jp, jcfg, rt1, JConfig(
            max_slots=2, max_context=16, prefill_capacity=16,
            collect_logits=True)),
                ServeEngine(tp, cfg, Runtime(device="cpu"), ServeConfig(
                    max_slots=2, max_context=16, prefill_capacity=16,
                    collect_logits=True))):
        rids = [eng.submit(p, m) for p, m in pool]
        eng.drain(max_steps=100)
        outs.append([eng.pool.get(r) for r in rids])
    assert [len(r.generated) for r in outs[1]] == [7, 12]
    for got, want in zip(outs[1], outs[0]):
        assert got.error is None and got.generated == want.generated
        np.testing.assert_allclose(np.stack(got.logits),
                                   np.stack(want.logits), atol=F32_TOL,
                                   rtol=0)


MOE_POOL = [(9, 5), (17, 4), (5, 6), (30, 3), (12, 5), (3, 7)]


def test_moe_engine_pool_parity_with_jax(rt1):
    """Reduced Mistral-8x7B in float32, 6 requests on 4 slots (a second
    admission round, free slots fed their last tokens): each prefill
    wave routes as one group, each decode step the whole slab; the
    greedy tokens identical and the logits within 1e-4 of the reference
    engine's."""
    arch = "mistral-8x7b"
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
    tp = bridge.params_from_flat(_flatten(jp), cfg, "cpu")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n, _ in MOE_POOL]
    from repro.serve import ServeConfig as JConfig, ServeEngine as JEngine
    jeng = JEngine(jp, jcfg, rt1, JConfig(max_slots=4, max_context=64,
                                          prefill_capacity=64,
                                          collect_logits=True))
    jrids = [jeng.submit(p, m) for p, (_, m) in zip(prompts, MOE_POOL)]
    jeng.drain(max_steps=200)
    eng = ServeEngine(tp, cfg, Runtime(device="cpu"), ServeConfig(
        max_slots=4, max_context=64, prefill_capacity=64,
        collect_logits=True))
    rids = [eng.submit(p, m) for p, (_, m) in zip(prompts, MOE_POOL)]
    eng.drain(max_steps=200)
    assert eng.stats["prefill_waves"] == jeng.stats["prefill_waves"] >= 2
    for rid, jrid in zip(rids, jrids):
        got, want = eng.pool.get(rid), jeng.pool.get(jrid)
        assert got.generated == want.generated
        np.testing.assert_allclose(np.stack(got.logits),
                                   np.stack(want.logits), atol=F32_TOL,
                                   rtol=0)


def _reference_rows(params, cfg, rt, req):
    toks = list(req.prompt) + req.generated[:-1]
    t = len(toks)
    h = T.forward_hidden(params, cfg, rt, {
        "tokens": torch.tensor(toks, dtype=torch.int32),
        "seg": torch.ones(t, dtype=torch.int32),
        "pos": torch.arange(t, dtype=torch.int32)})
    return T.logits_head(params, cfg, h).float().numpy()[req.plen - 1:]


def test_engine_admits_into_running_batch():
    """A late request takes the first freed slot without disturbing the
    running one; every request matches its solo teacher-forced forward."""
    _, cfg = _cfgs("float32")
    params = T.init_params(cfg, seed=1, device="cpu")
    rt = Runtime(device="cpu")
    eng = ServeEngine(params, cfg, rt, ServeConfig(
        max_slots=2, max_context=64, prefill_capacity=64,
        collect_logits=True))
    rng = np.random.RandomState(1)
    a = eng.submit(rng.randint(0, cfg.vocab_size, 6), 4)
    b = eng.submit(rng.randint(0, cfg.vocab_size, 8), 12)
    for _ in range(2):
        eng.step()
    c = eng.submit(rng.randint(0, cfg.vocab_size, 7), 4)
    assert eng.n_live == 2
    eng.step()
    eng.step()
    assert eng.pool.get(c).t_admit is not None
    assert eng.pool.get(b).t_done is None
    eng.drain(max_steps=100)
    for rid in (a, b, c):
        req = eng.pool.get(rid)
        ref = _reference_rows(params, cfg, rt, req)
        assert [int(r.argmax()) for r in ref] == req.generated
        np.testing.assert_allclose(np.stack(req.logits), ref, atol=F32_TOL,
                                   rtol=0)


def test_engine_fails_nonfinite_request_and_survives():
    _, cfg = _cfgs("float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    eng = ServeEngine(params, cfg, Runtime(device="cpu"), ServeConfig(
        max_slots=2, max_context=64, prefill_capacity=64))
    rng = np.random.RandomState(0)
    rid = eng.submit(rng.randint(0, cfg.vocab_size, 9), 5)
    with torch.inference_mode():
        eng._admit()
    slot = eng.pool.get(rid).slot
    assert eng.cache["blocks"][0]["k"][:, slot].abs().sum() > 0
    good = eng.params
    eng.params = bridge.params_from_flat(
        {k: np.full_like(v, np.nan) for k, v in
         bridge.params_to_flat(params).items()}, cfg, "cpu")
    finished = eng.step()
    assert [r.rid for r in finished] == [rid]
    assert eng.pool.get(rid).error == "nonfinite_logits"
    assert eng.n_live == 0
    assert eng.cache["blocks"][0]["k"][:, slot].abs().sum() == 0  # scrubbed
    eng.params = good
    rid2 = eng.submit(rng.randint(0, cfg.vocab_size, 5), 3)
    eng.drain(max_steps=50)
    req2 = eng.pool.get(rid2)
    assert req2.error is None and len(req2.generated) == 3


def test_unported_features_raise():
    _, cfg = _cfgs("float32")
    for change in ({"pos_embed": "mrope"}, {"layer_pattern": "gm"},
                   {"frontend": "vision_stub"}):
        with pytest.raises(NotImplementedError):
            T.init_params(dataclasses.replace(cfg, **change), device="cpu")
    # one rank: a ring group of two has no second rank to run on
    with pytest.raises(ValueError, match="does not sum"):
        params = T.init_params(cfg, device="cpu")
        rt = Runtime(device="cpu").with_composition((2,))
        T.forward_hidden(params, cfg, rt, {
            "tokens": torch.zeros(8, dtype=torch.int32),
            "seg": torch.ones(8, dtype=torch.int32),
            "pos": torch.arange(8, dtype=torch.int32)})
