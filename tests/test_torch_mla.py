"""The port's Multi-head Latent Attention against the reference: reduced
deepseek-v2-lite-16b (4 heads; latent kv_lora_rank 32 + qk_rope 8, so the
flash kernels run at (Dk, Dv) = (40, 32); one dense head layer and one MoE
layer with a shared expert) in float32, with weights from the reference's
`init_params` carried across by `bridge.py` and its norm scales (the
latent norm's too) drawn off their zero init; and reduced
qwen3-moe-30b-a3b, forward and engine.

* Both configs equal the reference's, and `check_supported` takes them.
* `mla_qkv` and `mla_output` in float32 and bf16.
* The flash kernels' plain versions at (40, 32) in the reference's gather
  mode (one latent a head, v its first 32 columns), with and without a
  window, against the Pallas kernels in interpret mode; on a card
  (``cuda`` marker) the (576, 512) CUDA instantiations against the plain
  versions.
* The ring with ``v_in_k`` (the latent carried alone) forward and
  backward at g = 1 in process and at g = 2 over gloo ranks, against
  `repro.core.ring.ring_attention` (`tests/test_ring_flash.py`'s holds).
* `forward_hidden` + `logits_head` under both ``attn_impl``, the decode
  cache of latents against the packed forward, the `ServeEngine` pool
  against the reference's engine, and a ``"seq"`` slab at hdp = 2.
* 3 `Trainer` steps at hdp = 1 against the reference's `Trainer`, and a
  (2,) training wave whose sequence spans both ranks.
* The MLA leaves through the bridge, a checkpoint the reference restores,
  ZeRO-1's dimensions and the latent ring's pricing.

The reference's Trainer history and hdp = 1 engines, its hdp = 2 cases
and the port's gloo ranks run as three subprocesses that one module
fixture starts when the module does, beside the in-process cases.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_mla_worker as W
from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config as jax_config
from repro.core import hdp as jhdp
from repro.core.ring import ring_attention as jax_ring_attention
from repro.kernels import flash_attention as JFA
from repro.models import mla as JMLA
from repro.models import transformer as JT
from repro.obs import ledger as jledger
from repro.optim import adamw as jadamw
from repro.parallel import zero1 as jzero1
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import base
from repro_torch.configs.registry import get_config
from repro_torch.core import hdp as port_hdp
from repro_torch.core.ring import ring_attention
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import mla as MLA
from repro_torch.models import transformer as T
from repro_torch.obs import ledger
from repro_torch.optim import adamw
from repro_torch.parallel import zero1
from repro_torch.parallel.sharding import Runtime
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import serve_step as S
from test_torch_train import _port_history
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
ARCHS = (W.ARCH, "qwen3-moe-30b-a3b")
IMPLS = W.IMPLS
F32_TOL = 1e-4          # tests/test_torch_serve.py, test_torch_train.py
BF16_ULP = 2.0 ** -8    # one bf16 ulp, relative
FWD_TOL, GRAD_TOL = 5e-5, 1e-3          # tests/test_kernels.py, float32
RING_LOSS_TOL, RING_GRAD_TOL = 1e-3, 3e-4   # tests/test_ring_flash.py
KERNEL_TOL = 2e-2       # the CUDA kernels against their plain versions
POOL_LENS, POOL_NEW = [30, 17, 9, 25], [6, 4, 7, 5]   # the hdp = 1 pool
POOL_CFG = dict(max_slots=2, max_context=64, prefill_capacity=64,
                collect_logits=True)


def _cfgs(arch):
    return (W.config(jax_config(arch).reduced()),
            W.config(get_config(arch).reduced()))


def _jax_from_flat(tree, flat):
    """The reference's tree with every leaf taken from ``flat``."""
    def leaf(path, x):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        return jnp.asarray(flat[key], x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def bridged(rt1):
    """arch -> (jax cfg, jax params, port cfg, port params on the CPU):
    the reference's init with its norm scales perturbed, bridged."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
        flat = W.perturb_norms(_flatten(jp))
        out[arch] = (jcfg, _jax_from_flat(jp, flat), cfg,
                     bridge.params_from_flat(flat, cfg, "cpu"))
    return out


def _both(d):
    """{name: numpy int32} -> (jax batch, torch batch)."""
    return ({k: jnp.array(v) for k, v in d.items()},
            {k: torch.tensor(v) for k, v in d.items()})


# ---------------------------------------------------------------------------
# configs and the MLA functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    """The copies equal the reference's configs, full and reduced, count
    the same parameters, and `check_supported` takes both."""
    for cfg, want in ((get_config(arch), jax_config(arch)),
                      (get_config(arch).reduced(),
                       jax_config(arch).reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert cfg.param_count() == want.param_count()
        T.check_supported(cfg)
    if arch == W.ARCH:
        m = get_config(arch).mla
        assert (m.kv_lora_rank + m.qk_rope_dim, m.kv_lora_rank) == (576, 512)
        assert (576, 512) in FA.KERNEL_DIMS


def test_check_supported_still_rejects_what_waits():
    cfg = get_config(W.ARCH).reduced()
    waiting = {
        "layer pattern": dict(layer_pattern="m"),
        "mamba": dict(layer_pattern="m", mamba=base.MambaSpec()),
        "frontend": dict(frontend="vision_stub"),
        "mrope": dict(pos_embed="mrope")}
    for what, kw in waiting.items():
        with pytest.raises(NotImplementedError, match=what):
            T.check_supported(dataclasses.replace(cfg, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_functions_match_jax(bridged, dtype):
    """`mla_qkv` (RoPE per head and on the shared k_rope, the latent norm,
    the absorbed q) and `mla_output` on the bridged weights: float32
    within 1e-5, bf16 within two bf16 ulps (one rounding of the inputs
    apart in the libraries' matmuls)."""
    jcfg, jp, cfg, tp = bridged[W.ARCH]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jattn = jax.tree.map(lambda a: a.astype(jdt) if a.ndim > 1 else a,
                         jp["head_blocks"][0]["attn"])
    tattn = {k: v if isinstance(v, dict) else v.to(tdt)
             for k, v in tp["head_blocks"][0]["attn"].items()}
    rng = np.random.RandomState(3)
    x = rng.randn(20, cfg.d_model).astype(np.float32)
    pos = np.concatenate([np.arange(12), np.arange(8)]).astype(np.int32)
    q_j, kv_j = JMLA.mla_qkv(jattn, jcfg, jnp.asarray(x, jdt),
                             jnp.asarray(pos))
    q_t, kv_t = MLA.mla_qkv(tattn, cfg, torch.tensor(x).to(tdt),
                            torch.tensor(pos))
    m = cfg.mla
    assert tuple(q_t.shape) == (20, cfg.num_heads,
                                m.kv_lora_rank + m.qk_rope_dim)
    assert tuple(kv_t.shape) == (20, 1, m.kv_lora_rank + m.qk_rope_dim)
    assert q_t.dtype == kv_t.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2 * BF16_ULP
    for got, want in ((q_t, q_j), (kv_t, kv_j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)
    lat = rng.randn(20, cfg.num_heads, m.kv_lora_rank).astype(np.float32)
    want = JMLA.mla_output(jattn, jcfg, jnp.asarray(lat, jdt))
    got = MLA.mla_output(tattn, cfg, torch.tensor(lat).to(tdt))
    tol = 1e-5 if dtype == "float32" else 4 * BF16_ULP
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol * float(np.abs(want).max()),
                               rtol=tol)
    assert MLA.mla_scale(cfg) == JMLA.mla_scale(jcfg) == 1 / math.sqrt(24)
    assert MLA.mla_scale(get_config(W.ARCH)) == 1 / math.sqrt(192)


# ---------------------------------------------------------------------------
# the flash kernels at (40, 32) and (576, 512)
# ---------------------------------------------------------------------------

def _gather_inputs(seed, heads, t, dk, dv, dtype="float32"):
    """Gather mode: q [H, 1, T, Dk]; each head's k the one latent [T, Dk]
    and v its first Dv columns, as `kernels/ring_flash.py` lays them out;
    three segments and 5 padding rows."""
    rng = np.random.RandomState(seed)
    q = rng.randn(heads, 1, t, dk)
    lat = rng.randn(t, dk)
    k = np.broadcast_to(lat, (heads, t, dk)).copy()
    v = k[..., :dv].copy()
    meta = W.packed([t // 2, t // 3, t - t // 2 - t // 3 - 5], t, 2, seed)
    seg, pos = meta["seg"], meta["pos"]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.array(x, jdt) for x in (q, k, v)] + [jnp.array(x) for x in
                                                  (seg, seg, pos, pos)]
    tt = ([torch.tensor(np.asarray(x, np.float32)).to(tdt) for x in j[:3]]
          + [torch.tensor(x) for x in (seg, seg, pos, pos)])
    carry = (rng.randn(heads, 1, t, dv).astype(np.float32),
             rng.randn(heads, 1, t).astype(np.float32),
             (rng.rand(heads, 1, t) + 0.5).astype(np.float32))
    return rng, j, tt, carry, seg == 0


@pytest.mark.parametrize("window", [0, 16])
def test_flash_plain_versions_at_40_32_match_pallas(window):
    """The finalising forward, the carry from a non-zero state and the
    backward (dq, dk, dv) at the reduced model's (Dk, Dv) = (40, 32),
    softcap 0, against the Pallas kernels in interpret mode: forward
    within 5e-5, gradients within 1e-3 (float32)."""
    rng, j, tt, carry, pad = _gather_inputs(11 + window, 4, 64, 40, 32)
    kw = dict(scale=24 ** -0.5, causal=True, window=window, softcap=0.0)
    pk = dict(block_q=32, block_k=32, interpret=True, **kw)
    out_j, lse_j = JFA.flash_attention_fwd(*j, **pk)
    out, lse = FA.flash_attention_fwd(*tt, **kw)
    for got, want in ((out, out_j), (lse, lse_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FWD_TOL, rtol=FWD_TOL)
    assert (out[:, :, torch.tensor(pad)] == 0).all()
    want = JFA.flash_attention_fwd_carry(*j, *(jnp.array(c) for c in carry),
                                         **pk)
    state = tuple(torch.tensor(c) for c in carry)
    FA.flash_attention_fwd_carry(*tt, *state, **kw)
    for got, w in zip(state, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=FWD_TOL,
                                   rtol=FWD_TOL)
    do = rng.randn(*out.shape).astype(np.float32)
    want = JFA.flash_attention_bwd(*j, out_j, lse_j, jnp.array(do),
                                   block_q=32, block_k=32, interpret=True,
                                   **kw)
    got = FA.flash_attention_bwd(*tt, torch.tensor(np.asarray(out_j)),
                                 torch.tensor(np.asarray(lse_j)),
                                 torch.tensor(do), **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 40])
def test_cuda_576_512_kernels_match_plain(window):
    """On a card: the (576, 512) carry, finalising, dq and dkv kernels
    (bf16, gather mode, scale 1/sqrt(192)) against their plain versions
    at 2e-2 over 300 ragged rows, each launch counted once; padding rows
    exactly 0 / -1e30, their carry kept exactly, their grads 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng, _, tt, carry, pad = _gather_inputs(21, 2, 300, 576, 512,
                                            "bfloat16")
    tt = [x.cuda() for x in tt]
    state = [torch.tensor(c).cuda() for c in carry]
    pad = torch.tensor(pad).cuda()
    kw = dict(scale=192 ** -0.5, causal=True, window=window, softcap=0.0)
    n0 = {f: getattr(FA, f).launches for f in (
        "flash_attention_fwd", "flash_attention_fwd_carry",
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    out, lse = FA.flash_attention_fwd(*tt, **kw)
    out_p, lse_p = FA.flash_attention_fwd_plain(*tt, **kw)
    torch.testing.assert_close(out.float(), out_p.float(), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    torch.testing.assert_close(lse, lse_p, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    assert (out[:, :, pad] == 0).all()
    assert (lse[:, :, pad] == FA.NEG_INF).all()
    before = [x.clone() for x in state]
    want = FA.flash_attention_fwd_carry_plain(*tt, *state, **kw)
    FA.flash_attention_fwd_carry(*tt, *state, **kw)
    for got, w, b in zip(state, want, before):
        torch.testing.assert_close(got, w, atol=KERNEL_TOL, rtol=KERNEL_TOL)
        assert torch.equal(got[:, :, pad], b[:, :, pad])
    do = torch.tensor(rng.randn(*out.shape), dtype=torch.bfloat16,
                      device="cuda")
    res = (*tt, out_p, lse_p, do)
    dq, delta = FA.flash_attention_bwd_dq(*res, **kw)
    dk_, dv_ = FA.flash_attention_bwd_dkv(*res, delta, **kw)
    for got, w in zip((dq, dk_, dv_), FA.flash_attention_bwd_plain(*res,
                                                                   **kw)):
        torch.testing.assert_close(got.float(), w.float(), atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)
        assert float((got.float() - w.float()).norm()
                     / w.float().norm()) <= KERNEL_TOL
    assert (dq[:, :, pad] == 0).all() and (dk_[:, pad] == 0).all()
    assert all(getattr(FA, f).launches == n + 1 for f, n in n0.items())


# ---------------------------------------------------------------------------
# the ring with v_in_k
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ring_g1(rt1):
    """The reference's one-rank ring with ``v_in_k`` on `W.ring_inputs`:
    (loss sum(out²), its gradients in q and the latent)."""
    q, kl, seg, pos = W.ring_inputs()
    js, jpos = jnp.asarray(seg), jnp.asarray(pos)

    def jloss(q_, kl_):
        o = jax_ring_attention(
            q_, kl_, None, js, js, jpos, jpos, mesh=rt1.mesh,
            hdp_axes=rt1.hdp_axes, model_axis=rt1.model_axis,
            composition=(1,), kv_sharded=False,
            kv_group_of_head=jnp.zeros((W.RING_HEADS,), jnp.int32),
            scale=W.RING_SCALE, attn_impl="ref", v_in_k=(0, W.V_DIM),
            kv_chunk=8)
        return (o.astype(jnp.float32) ** 2).sum()
    lw, (dqw, dklw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(q), jnp.asarray(kl))
    return float(lw), np.asarray(dqw), np.asarray(dklw)


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_v_in_k_at_g1_matches_reference(jax_ring_g1, impl):
    """One rank: the latent [T, 1, 40] carried alone, v its first 32
    columns; loss sum(out²) within 1e-3 relative and its gradients in q
    and the latent within 3e-4 of `repro.core.ring.ring_attention`'s."""
    q, kl, seg, pos = W.ring_inputs()
    lw, dqw, dklw = jax_ring_g1
    qt = torch.tensor(q, requires_grad=True)
    kt = torch.tensor(kl, requires_grad=True)
    st, pt = torch.tensor(seg), torch.tensor(pos)
    out = ring_attention(qt, kt, None, st, st, pt, pt, composition=(1,),
                         kv_sharded=False,
                         kv_group_of_head=torch.zeros(W.RING_HEADS,
                                                      dtype=torch.int64),
                         scale=W.RING_SCALE, attn_impl=impl,
                         v_in_k=(0, W.V_DIM), kv_chunk=8)
    assert tuple(out.shape) == (len(seg), W.RING_HEADS, W.V_DIM)
    loss = (out ** 2).sum()
    loss.backward()
    assert abs(loss.item() - lw) <= RING_LOSS_TOL * abs(lw)
    for got, want in ((qt.grad, dqw), (kt.grad, dklw)):
        np.testing.assert_allclose(got.numpy(), want, atol=RING_GRAD_TOL,
                                   rtol=RING_GRAD_TOL)


# ---------------------------------------------------------------------------
# forward and serving
# ---------------------------------------------------------------------------

def _logits_batch(vocab):
    """Three packed segments of 30/20/14 tokens in 64 rows."""
    return {k: v for k, v in W.packed([30, 20, 14], 64, vocab, 0).items()
            if k != "labels"}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(bridged, jax_logits, arch, impl):
    """Three packed segments of 30/20/14 tokens: logits within 1e-4 of
    the reference's (computed by the module's reference process)."""
    _, _, cfg, tp = bridged[arch]
    _, tb = _both(_logits_batch(cfg.vocab_size))
    got = T.logits_head(tp, cfg, T.forward_hidden(
        tp, cfg, Runtime(device="cpu", attn_impl=impl), tb))
    np.testing.assert_allclose(got.numpy(), jax_logits[arch], atol=F32_TOL,
                               rtol=0)


def test_decode_latent_cache_matches_the_packed_forward(bridged):
    """Two slots decoded 24 positions one at a time through the latent
    cache ({"kv_lat"} [B, S, 1, 40] a layer, the head layer's too) match
    the packed forward of the same tokens within 1e-4.  The MoE layer's
    capacity factor is raised to its expert count so that no pair drops
    in either route (a group of 2 decode rows and one of 48 packed rows
    drop different pairs at 1.25: two different functions)."""
    _, _, cfg, tp = bridged[W.ARCH]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    t, b = 24, 2
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (b, t))
    rt = Runtime(device="cpu")
    cache = S.init_decode_cache(cfg, rt, b, t)
    for layer in cache["head_layers"] + cache["blocks"]:
        assert list(layer) == ["kv_lat"]
        assert tuple(layer["kv_lat"].shape[-3:]) == (t, 1, 40)
    assert S.cache_bytes(cache) == cfg.num_layers * b * t * 40 * 4
    step = S.make_decode_step(cfg, rt, b, t)
    got = []
    for i in range(t):
        lg, cache = step(tp, cache, torch.tensor(tokens[:, i]), i)
        got.append(lg.numpy())
    flat = tokens.reshape(-1).astype(np.int32)
    batch = {"tokens": torch.tensor(flat),
             "seg": torch.tensor(np.repeat([1, 2], t).astype(np.int32)),
             "pos": torch.tensor(np.tile(np.arange(t), b).astype(np.int32))}
    ref = T.logits_head(tp, cfg, T.forward_hidden(tp, cfg, rt, batch))
    np.testing.assert_allclose(np.stack(got, 1),
                               ref.reshape(b, t, -1).numpy(), atol=F32_TOL,
                               rtol=0)


def _engine_run(eng, prompts, new):
    rids = [eng.submit(p, n) for p, n in zip(prompts, new)]
    eng.drain(max_steps=300)
    return [eng.pool.get(r) for r in rids]


def _pool_prompts(vocab):
    rng = np.random.RandomState(2)
    return [rng.randint(0, vocab, n) for n in POOL_LENS]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_pool_matches_jax(bridged, jax_engine, arch):
    """Four prompts through two slots (prefills after retirements, slots
    reused): every request's tokens equal the reference engine's and its
    logit rows are within 1e-4."""
    _, _, cfg, tp = bridged[arch]
    got = _engine_run(ServeEngine(tp, cfg, Runtime(device="cpu"),
                                  ServeConfig(**POOL_CFG)),
                      _pool_prompts(cfg.vocab_size), POOL_NEW)
    for i, req in enumerate(got):
        assert req.error is None
        assert req.generated == jax_engine[f"{arch}/tokens/{i}"].tolist()
        np.testing.assert_allclose(np.stack(req.logits),
                                   jax_engine[f"{arch}/logits/{i}"],
                                   atol=F32_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the bridge, checkpoints, ZeRO-1, the ring's pricing
# ---------------------------------------------------------------------------

def test_bridge_and_checkpoint_carry_the_mla_leaves(rt1, tmp_path):
    """bf16 reduced deepseek: w_uk, w_uv and the latent norm bridge under
    the reference's keys (the norm float32), and a checkpoint the port
    writes restores in the reference's `CheckpointManager` exactly."""
    jcfg = jax_config(W.ARCH).reduced()
    cfg = get_config(W.ARCH).reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
    flat = W.perturb_norms(_flatten(jp))
    tp = bridge.params_from_flat(flat, cfg, "cpu")
    attn = tp["blocks"][0]["attn"]
    assert sorted(attn) == sorted(jp["blocks"][0]["attn"])
    assert attn["latent_norm"]["scale"].dtype == torch.float32
    assert attn["w_uk"].dtype == attn["w_uv"].dtype == torch.bfloat16
    fresh = T.init_params(cfg, seed=1, device="cpu")
    assert sorted(bridge.params_to_flat(fresh)) == sorted(flat)
    for key, x in bridge.params_to_flat(fresh).items():
        assert x.shape == flat[key].shape, key
    back = bridge.params_to_flat(tp)
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)
    state = adamw.init_state(tp)
    CheckpointManager(str(tmp_path), async_save=False).save(
        4, tp, state, {"step": 4})
    jstate = jadamw.init_state(jp)
    jparams, jopt, jds = JManager(str(tmp_path)).restore(4, jp, jstate)
    assert jds == {"step": 4}
    got = _flatten(jparams)
    for key in flat:
        np.testing.assert_array_equal(got[key], np.asarray(
            flat[key], got[key].dtype), err_msg=key)
    master = _flatten(jopt["master"])
    assert master["blocks/0/attn/latent_norm/scale"].dtype == np.float32
    np.testing.assert_array_equal(master["blocks/0/attn/w_uk"],
                                  back["blocks/0/attn/w_uk"])


@pytest.mark.parametrize("hdp", [2, 4])
def test_zero1_and_ring_pricing_match_reference(rt1, hdp):
    """Full-width deepseek-v2-lite: every leaf's ZeRO-1 dimension (w_uk,
    w_uv and the latent norm among them) is the one the reference's
    `zero1_spec` gives it; the ring block and the per-token ring payload
    are the latent's 576 columns, as the reference prices them."""
    jcfg, cfg = jax_config(W.ARCH), get_config(W.ARCH)
    abstract = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), jcfg, rt1))
    paths = jax.tree_util.tree_flatten_with_path(abstract)[0]
    rt = types.SimpleNamespace(hdp_size=hdp, hdp_axes=("data",))
    keys = set()
    for path, leaf in paths:
        keys.add(str(getattr(path[-1], "key", "")))
        spec = jzero1.zero1_spec(P(), leaf.shape, rt)
        want = next((i for i, e in enumerate(spec) if e is not None), None)
        assert zero1.zero1_dim(leaf.shape, hdp) == want, (path, leaf.shape)
    assert {"w_uk", "w_uv", "w_dkv"} <= keys
    for c in (1024, 4096):
        assert ledger.ring_block_bytes(cfg, c) \
            == jledger.ring_block_bytes(jcfg, c) \
            == c * 576 * 2 + 2 * 4 * c + 16
    assert port_hdp.kv_bytes_per_token(cfg) \
        == jhdp.kv_bytes_per_token(jcfg) == 2.0 * 576


# ---------------------------------------------------------------------------
# the reference's processes: its Trainer history and engines, hdp = 2
# ---------------------------------------------------------------------------

def test_three_trainer_steps_match_jax(jax_trainer_history):
    """Reduced deepseek-v2-lite: the reference's `Trainer` and the port's
    from the same initial params on the same plans
    (`tests/test_torch_train.py::_port_history`: losses and grad norms
    within 1e-4); every wave's loss within 1e-4 and every step's update
    within 1e-3 relative L2 per leaf, the MLA leaves among them."""
    history = jax_trainer_history
    tr, after = _port_history(history, "flash", W.ARCH, context=256)
    assert tr.params["blocks"][0]["attn"]["latent_norm"]["scale"].dtype \
        == torch.float32
    before = history[0]
    for (got, got_w), (want, want_w) in zip(after, history[3]):
        np.testing.assert_allclose(got_w, want_w, rtol=F32_TOL)
        assert sorted(got) == sorted(want)
        assert "head_blocks/0/attn/w_uk" in want
        for key in want:
            upd = want[key] - before[key]
            rel = np.linalg.norm(got[key] - before[key] - upd) \
                / np.linalg.norm(upd)
            assert rel <= 1e-3, (key, rel)
        before = want


JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config
from repro.core.loss import token_ce_loss
from repro.core.ring import ring_attention
from repro.models.transformer import forward_hidden, init_params
from repro.parallel.sharding import (Runtime, params_pspecs,
                                     shardings_from_pspecs)
from repro.serve import ServeConfig, ServeEngine
sys.path.insert(0, "tests")
import _torch_mla_worker as W

out = sys.argv[1]
mesh = compat.make_mesh((W.R, 1), ("data", "model"),
                        axis_types=compat.auto_axis_types(2))
compat.set_mesh(mesh)
rt = Runtime(mesh=mesh, hdp_axes=("data",), model_axis="model",
             remat="none")
cfg = W.config(get_config(W.ARCH).reduced())
params = init_params(jax.random.PRNGKey(0), cfg, rt)
flat = W.perturb_norms(_flatten(params))
def leaf(path, x):
    key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                   for p in path)
    return jnp.asarray(flat[key], x.dtype)
params = jax.tree_util.tree_map_with_path(leaf, params)
np.savez(out + "/jax_params.tmp.npz", **flat)   # the ranks wait for it
os.replace(out + "/jax_params.tmp.npz", out + "/jax_params.npz")
res = {}

q, kl, seg, pos = (jnp.asarray(x) for x in W.ring_inputs())
def ring_loss(q_, kl_):
    o = ring_attention(q_, kl_, None, seg, seg, pos, pos, mesh=mesh,
                       hdp_axes=("data",), model_axis="model",
                       composition=(W.R,), kv_sharded=False,
                       kv_group_of_head=jnp.zeros((W.RING_HEADS,),
                                                  jnp.int32),
                       scale=W.RING_SCALE, attn_impl="ref",
                       v_in_k=(0, W.V_DIM), kv_chunk=8)
    return (o.astype(jnp.float32) ** 2).sum()
l, (dq, dkl) = jax.jit(jax.value_and_grad(ring_loss, argnums=(0, 1)))(q, kl)
res["ring/loss"], res["ring/dq"], res["ring/dkl"] = (
    np.asarray(l), np.asarray(dq), np.asarray(dkl))

eng = ServeEngine(params, cfg, rt, ServeConfig(
    max_slots=W.SLOTS, max_context=W.MAX_CONTEXT,
    prefill_capacity=W.CAPACITY, collect_logits=True))
comps = []
plan_pool = eng.service.plan_pool
def recorded(lengths):
    plan = plan_pool(lengths)
    comps.append([tuple(int(x) for x in w.composition) for w in plan.waves])
    return plan
eng.service.plan_pool = recorded
rids = [eng.submit(p, W.NEW_TOKENS) for p in W.prompts(cfg.vocab_size)]
eng.drain(max_steps=200)
reqs = [eng.pool.get(r) for r in rids]
res["serve/tokens"] = np.array([r.generated for r in reqs])
res["serve/logits"] = np.stack([np.stack(r.logits) for r in reqs])
res["serve/comps"] = np.array(repr(comps))

rt_c = rt.with_composition((W.R,))
w = W.train_wave(cfg.vocab_size)
batch = {k: jnp.array(v) for k, v in w.items()}
batch["denom"] = jnp.float32(sum(W.TRAIN_LENS))
pspecs = params_pspecs(params, cfg, rt)
params = jax.device_put(params, shardings_from_pspecs(pspecs, mesh))
bspecs = {k: (P() if k == "denom" else P(("data",))) for k in batch}
batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
         for k, v in batch.items()}
in_sh = compat.resolve_shardings((pspecs, bspecs), mesh)
def loss(p, b):
    h = forward_hidden(p, cfg, rt_c, b)
    l, _ = token_ce_loss(p, cfg, rt_c, h, b["labels"], b["seg"], b["denom"])
    return l
l, g = jax.jit(jax.value_and_grad(loss), in_shardings=in_sh)(params, batch)
res["train/loss"] = np.asarray(l)
for key, x in _flatten(g).items():
    res["train/grad/" + key] = x
np.savez(out + "/jax_mla.npz", **res)
"""


# the reference's hdp = 1 engines (both models) and its 3-step `Trainer`
# history of reduced deepseek-v2-lite, one host device
HISTORY_SCRIPT = r"""
import os, pickle, sys
sys.path.insert(0, "tests")
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config
from repro.models.transformer import init_params
from repro.parallel.sharding import single_device_runtime
from repro.serve import ServeConfig, ServeEngine
import _torch_mla_worker as W
from repro.models.transformer import forward_hidden, logits_head
from test_torch_mla import (ARCHS, POOL_CFG, POOL_NEW, _logits_batch,
                            _pool_prompts)
from test_torch_train import _jax_history
out = sys.argv[1]
rt = single_device_runtime(remat="none")
compat.set_mesh(rt.mesh)
models, logits = {}, {}
for arch in ARCHS:                   # the logits first: a test waits
    cfg = W.config(get_config(arch).reduced())
    params = init_params(jax.random.PRNGKey(0), cfg, rt)
    flat = W.perturb_norms(_flatten(params))
    def leaf(path, x):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        return jnp.asarray(flat[key], x.dtype)
    params = jax.tree_util.tree_map_with_path(leaf, params)
    batch = {k: jnp.asarray(v) for k, v in
             _logits_batch(cfg.vocab_size).items()}
    logits[arch] = np.asarray(jax.jit(lambda p, b: logits_head(
        p, cfg, forward_hidden(p, cfg, rt, b)))(params, batch))
    models[arch] = (cfg, params)
np.savez(out + "/jax_logits.tmp.npz", **logits)
os.replace(out + "/jax_logits.tmp.npz", out + "/jax_logits.npz")
res = {}
for arch, (cfg, params) in models.items():
    eng = ServeEngine(params, cfg, rt, ServeConfig(**POOL_CFG))
    rids = [eng.submit(p, n) for p, n in zip(_pool_prompts(cfg.vocab_size),
                                             POOL_NEW)]
    eng.drain(max_steps=300)
    for i, r in enumerate(rids):
        req = eng.pool.get(r)
        res[f"{arch}/tokens/{i}"] = np.array(req.generated)
        res[f"{arch}/logits/{i}"] = np.stack(req.logits)
np.savez(out + "/jax_engine.npz", **res)
history = _jax_history(rt, W.ARCH, context=256)
with open(out + "/jax_history.pkl", "wb") as f:
    pickle.dump(history, f)
"""


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    """Start the reference's processes (its hdp = 1 engines and Trainer
    history on one host device; its hdp = 2 cases on 2) and the 2 gloo
    ranks together when the module starts -> (out dir, processes, logs);
    stops them at the module's end."""
    out = tmp_path_factory.mktemp("mla")
    env = subprocess_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    running, logs = {}, {}
    for part, cmd in (
            ("history", [sys.executable, "-c", HISTORY_SCRIPT, str(out)]),
            ("jax", [sys.executable, "-c", JAX_SCRIPT, str(out)]),
            ("torch", [sys.executable,
                       str(ROOT / "tests" / "_torch_mla_worker.py"),
                       str(out)])):
        logs[part] = out / f"{part}.log"
        with open(logs[part], "w") as log:
            running[part] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                             stdout=log, stderr=log)
    try:
        yield out, running, logs
    finally:
        for p in running.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _finished(procs, parts):
    out, running, logs = procs
    for part in parts:
        running[part].wait(timeout=900)
        assert running[part].returncode == 0, (
            part, logs[part].read_text()[-4000:])
    return out


@pytest.fixture(scope="module")
def jax_logits(procs):
    """arch -> the reference's logits of `_logits_batch`, as soon as its
    process has written them (before its engines and Trainer run)."""
    out, running, logs = procs
    path = out / "jax_logits.npz"
    t0 = time.monotonic()
    while not path.exists():
        assert running["history"].poll() is None, (
            logs["history"].read_text()[-4000:])
        assert time.monotonic() - t0 < 900, "no reference logits"
        time.sleep(0.2)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def jax_engine(procs):
    out = _finished(procs, ("history",))
    return dict(np.load(out / "jax_engine.npz"))


@pytest.fixture(scope="module")
def jax_trainer_history(procs):
    out = _finished(procs, ("history",))
    with open(out / "jax_history.pkl", "rb") as f:
        return pickle.load(f)        # written by this module's process


@pytest.fixture(scope="module")
def hdp2(procs):
    """-> (reference results, per-rank port results), once both
    processes have ended."""
    out = _finished(procs, ("jax", "torch"))
    ref = dict(np.load(out / "jax_mla.npz"))
    ranks = [dict(np.load(out / f"torch_rank{r}.npz")) for r in range(W.R)]
    return ref, ranks


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_v_in_k_at_g2_matches_reference(hdp2, impl):
    """The (2,) ring over gloo ranks, the latent carried alone: the
    ranks' loss shares sum to the reference's within 1e-3 relative, and
    each rank's rows of dq and of the latent's gradient are the
    reference's within 3e-4."""
    ref, ranks = hdp2
    pre = f"ring/{impl}/"
    loss = sum(float(rk[pre + "loss"]) for rk in ranks)
    want = float(ref["ring/loss"])
    assert abs(loss - want) <= RING_LOSS_TOL * abs(want)
    for name in ("dq", "dkl"):
        got = np.concatenate([rk[pre + name] for rk in ranks])
        np.testing.assert_allclose(got, ref["ring/" + name],
                                   atol=RING_GRAD_TOL, rtol=RING_GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("impl", IMPLS)
def test_hdp2_seq_slab_serves_like_jax(hdp2, impl):
    """3 slots on 2 ranks: the ``"seq"`` layout, each rank 32 of every
    layer's 64 latent positions; the 40-token prompt prefills through a
    (2,) ring.  Both ranks' tokens equal the reference's and their logit
    rows are bit-identical to each other and within 1e-4 of the
    reference's; the waves' compositions are the reference's."""
    ref, ranks = hdp2
    pre = f"serve/{impl}/"
    for rk in ranks:
        assert str(rk[pre + "layout"]) == "seq"
        assert rk[pre + "cache_shapes"].tolist() == [
            [W.MAX_CONTEXT // W.R, 1, 40]] * 2
        assert str(rk[pre + "comps"]) == str(ref["serve/comps"])
        assert "(2,)" in str(rk[pre + "comps"])
        np.testing.assert_array_equal(rk[pre + "tokens"], ref["serve/tokens"])
        np.testing.assert_array_equal(rk[pre + "logits"],
                                      ranks[0][pre + "logits"])
    np.testing.assert_allclose(ranks[0][pre + "logits"], ref["serve/logits"],
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_hdp2_wave_trains_like_jax(hdp2, impl):
    """One (2,) wave whose 50-token sequence spans both ranks' rows: the
    ranks' loss shares sum to the reference's loss and the rank-summed
    gradients (the MLA leaves' and the shared expert's among them) equal
    its gradients within 1e-4."""
    ref, ranks = hdp2
    pre = f"train/{impl}/"
    shares = [float(rk[pre + "loss"]) for rk in ranks]
    assert all(s > 0 for s in shares)
    np.testing.assert_allclose(sum(shares), float(ref["train/loss"]),
                               rtol=F32_TOL)
    base_key = "train/grad/"
    keys = [k for k in ref if k.startswith(base_key)]
    for leaf in ("attn/w_uk", "attn/w_uv", "attn/latent_norm/scale",
                 "attn/w_dkv"):
        assert any(k.endswith(leaf) for k in keys), leaf
    for key in keys:
        leaf = key[len(base_key):]
        got = sum(rk[pre + "grad/" + leaf] for rk in ranks)
        np.testing.assert_allclose(got, ref[key], atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=leaf)
