"""The port's Mixture-of-Experts (`repro_torch/models/moe.py` and its
model paths) against the reference on the reduced Mistral-8x7B (2 layers,
d 64, E 4, top-2, d_expert 64) and a variant with a shared expert and a
dense head layer (``num_shared=1, first_k_dense=1, dense_d_ff=128``),
weights from the reference's init, inputs from a numpy seed:

* `moe_forward` at T = 64 and 200, capacity factor 1.25 and 0.25 (where
  tokens are dropped): the top-k indices equal but for near-ties (the
  k-th and (k+1)-th probabilities within `TIE_MARGIN`; the smallest
  margin seen is printed), the keep masks and `router_aux_stats` equal,
  the output within 5e-5 in float32 and 2e-2 in bf16
  (`tests/test_kernels.py`'s flash tolerances);
* input and parameter gradients against ``jax.grad`` in float32 within
  1e-3 (the flash-gradient tolerance), the backward the same from run to
  run;
* the slab routing of decode: `moe_forward_sharded` on 4 ranks gives each
  rank's rows of `moe_forward` over the whole group, drops included;
* the bridged model's hidden states and logits at hdp = 1;
* the router stays float32 through a bf16 bridge and a checkpoint
  restore; `check_supported` accepts both MoE models and still rejects
  q/k norms;
* a wave's gradients under ``remat="full"`` and ``"offload"`` bit-equal
  to ``"none"`` with pairs dropped (the recompute routes as the forward);
  the stacked expert leaves' ZeRO-1 shards restored on 4 ranks from a
  whole checkpoint and gathered back.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config as jax_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel.comm import ThreadRanks
from repro_torch.parallel.sharding import Runtime

ARCH = "mistral-8x7b"
TOL = {"float32": 5e-5, "bfloat16": 2e-2}      # tests/test_kernels.py:41
GRAD_TOL = 1e-3                                # tests/test_kernels.py:70
F32_TOL = 1e-4                                 # tests/test_torch_serve.py
TIE_MARGIN = 1e-5
SHARED = dict(num_shared=1, first_k_dense=1, dense_d_ff=128)
VARIANTS = ("mistral", "shared")


def _moe_cfg(cfg, variant, dtype, cf=None):
    moe = cfg.moe
    if variant == "shared":
        moe = dataclasses.replace(moe, **SHARED)
    if cf is not None:
        moe = dataclasses.replace(moe, capacity_factor=cf)
    return dataclasses.replace(cfg, moe=moe, dtype=dtype)


def cfgs(variant="mistral", dtype="float32", cf=None):
    """(the reference's config, the port's) of the reduced model."""
    return (_moe_cfg(jax_config(ARCH).reduced(), variant, dtype, cf),
            _moe_cfg(get_config(ARCH).reduced(), variant, dtype, cf))


@pytest.fixture(scope="module")
def bridged(rt1):
    """(variant, dtype) -> (jax params, port params on the CPU), the
    port's bridged from the reference's init."""
    out = {}
    for variant in VARIANTS:
        for dtype in TOL:
            jcfg, cfg = cfgs(variant, dtype)
            jp = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
            out[variant, dtype] = (jp, bridge.params_from_flat(
                _flatten(jp), cfg, "cpu"))
    return out


def _layer(tree):
    """The first stacked MoE layer's parameters."""
    moe = tree["blocks"][0]["moe"]
    return {k: v[0] for k, v in moe.items()}


def _jax_routing(p, jcfg, x):
    """The reference's routing expressions (`repro/models/moe.py:70-84`)
    -> (probs [T, E], idx [T, k], keep [T·k]) as numpy."""
    spec = jcfg.moe
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, spec.top_k)
    flat = jax.nn.one_hot(idx, spec.num_experts,
                          dtype=jnp.int32).reshape(-1, spec.num_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1)
    cap = JM.moe_capacity(spec, x.shape[0])
    return np.asarray(probs), np.asarray(idx), np.asarray(pos < cap)


def _inputs(t, dtype, seed=0):
    x = np.random.RandomState(seed).randn(t, 64).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.tensor(x).to(getattr(torch, dtype)))


MARGINS = []


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("t", [64, 200])
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_forward_matches_jax(bridged, variant, dtype, t, cf):
    jcfg, cfg = cfgs(variant, dtype, cf)
    jp, tp = (_layer(p) for p in bridged[variant, dtype])
    jx, tx = _inputs(t, dtype)
    probs, jidx, jkeep = _jax_routing(jp, jcfg, jx)
    _, idx = M.moe_route(tp, cfg, tx)
    idx = idx.numpy()
    k = cfg.moe.top_k
    top = np.sort(probs, axis=-1)[:, ::-1]
    margin = top[:, k - 1] - top[:, k]
    flips = np.flatnonzero((np.sort(idx, -1) != np.sort(jidx, -1)).any(-1))
    assert (margin[flips] < TIE_MARGIN).all(), (flips, margin[flips])
    MARGINS.append(float(margin.min()))
    print(f"smallest k-th/(k+1)-th margin so far {min(MARGINS):.3g}, "
          f"near-tie flips here {len(flips)}")
    got = M.moe_forward(tp, cfg, tx).float().numpy()
    want = np.asarray(JM.moe_forward(jp, jcfg, jx), np.float32)
    stats = M.router_aux_stats(tp, cfg, tx)
    jstats = JM.router_aux_stats(jp, jcfg, jx)
    if len(flips) == 0:
        keep = (M.moe_positions(torch.tensor(idx), cfg.moe.num_experts)
                < M.moe_capacity(cfg.moe, t)).numpy()
        np.testing.assert_array_equal(keep, jkeep)
        np.testing.assert_array_equal(stats["expert_load"].numpy(),
                                      np.asarray(jstats["expert_load"]))
        assert float(stats["dropped_frac"]) == float(jstats["dropped_frac"])
        rows = slice(None)
    else:                      # a flip moves every later position
        rows = np.arange(t) < flips[0]
    if cf < 1:
        assert float(stats["dropped_frac"]) > 0
        assert not jkeep.all()
    np.testing.assert_allclose(got[rows], want[rows], atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_gradients_match_jax(bridged, variant, cf):
    """d/d(x, params) of Σ y·c, float32, against ``jax.grad``; twice on
    the port with bit-equal results."""
    jcfg, cfg = cfgs(variant, "float32", cf)
    jp, tp = (_layer(p) for p in bridged[variant, "float32"])
    jx, tx = _inputs(96, "float32", seed=1)
    cot = np.random.RandomState(2).randn(96, 64).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(JM.moe_forward(p, jcfg, x) * cot)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jx)

    def port_grads():
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        x = tx.clone().requires_grad_(True)
        (M.moe_forward(p, cfg, x) * torch.tensor(cot)).sum().backward()
        return {k: v.grad for k, v in p.items()}, x.grad

    g_p, g_x = port_grads()
    np.testing.assert_allclose(g_x.numpy(), np.asarray(jg_x),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    assert sorted(g_p) == sorted(jg_p)
    for key in jg_p:
        np.testing.assert_allclose(g_p[key].numpy(), np.asarray(jg_p[key]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=key)
    again, again_x = port_grads()
    assert torch.equal(again_x, g_x)
    assert all(torch.equal(again[k], g_p[k]) for k in g_p)


@pytest.mark.parametrize("variant", VARIANTS)
def test_slab_routing_over_ranks_matches_one_group(bridged, variant):
    """16 rows on 4 ranks, 4 each, capacity factor 0.5 (capacity 8 for 32
    pairs on 4 experts): each rank's rows of `moe_forward_sharded` equal
    `moe_forward`'s over the 16 (drops included) and the reference's."""
    jcfg, cfg = cfgs(variant, "float32", 0.5)
    jp, tp = (_layer(p) for p in bridged[variant, "float32"])
    jx, tx = _inputs(16, "float32", seed=3)
    whole = M.moe_forward(tp, cfg, tx)
    _, _, jkeep = _jax_routing(jp, jcfg, jx)
    assert not jkeep.all()                        # the slab drops pairs
    outs = ThreadRanks(4).run(lambda c: M.moe_forward_sharded(
        tp, cfg, tx[4 * c.rank:4 * (c.rank + 1)], c))
    got = torch.cat(outs)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JM.moe_forward(jp, jcfg, jx)),
                               atol=TOL["float32"], rtol=TOL["float32"])


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


@pytest.mark.parametrize("impl", ["flash", "ref"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_hidden_and_logits_match_jax(bridged, rt1, variant, impl):
    """A packed wave with padding rows (which route and take capacity, as
    in the reference) through the whole bridged model, float32."""
    jcfg, cfg = cfgs(variant, "float32")
    jp, tp = bridged[variant, "float32"]
    tok, seg, pos = _packed(np.random.RandomState(0), [40, 17, 25], 96,
                            cfg.vocab_size)
    jb = {"tokens": jnp.array(tok), "seg": jnp.array(seg),
          "pos": jnp.array(pos)}
    tb = {"tokens": torch.tensor(tok), "seg": torch.tensor(seg),
          "pos": torch.tensor(pos)}
    jh = JT.forward_hidden(jp, jcfg, rt1, jb)
    rt = Runtime(device="cpu", attn_impl=impl)
    h = T.forward_hidden(tp, cfg, rt, tb)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(T.logits_head(tp, cfg, h).numpy(),
                               np.asarray(JT.logits_head(jp, jcfg, jh)),
                               atol=F32_TOL, rtol=0)
    assert len(tp["head_blocks"]) == (variant == "shared")


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_builds_the_reference_tree(bridged, variant):
    """The port's seeded init: the reference's keys, shapes and dtypes
    (router float32, the rest bf16), a dense head block where the config
    asks for one."""
    _, cfg = cfgs(variant, "bfloat16")
    mine = bridge.params_to_flat(T.init_params(cfg, seed=0, device="cpu"))
    ref = bridge.params_to_flat(bridged[variant, "bfloat16"][1])
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in ref.items()}
    params = T.init_params(cfg, seed=0, device="cpu")
    assert params["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert params["blocks"][0]["moe"]["w_in"].dtype == torch.bfloat16
    if variant == "shared":
        assert params["head_blocks"][0]["mlp"]["w_in"].shape == (64, 128)
        assert "shared_gate" in params["blocks"][0]["moe"]


def test_router_stays_float32_through_bridge_and_checkpoint(bridged,
                                                           tmp_path):
    _, cfg = cfgs("shared", "bfloat16")
    _, tp = bridged["shared", "bfloat16"]
    router = tp["blocks"][0]["moe"]["router"]
    assert router.dtype == torch.float32
    assert tp["blocks"][0]["moe"]["w_in"].dtype == torch.bfloat16
    flat = bridge.params_to_flat(tp)
    assert flat["blocks/0/moe/router"].dtype == np.float32
    state = adamw.init_state(tp)
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, tp, state, {"step": 1}, block=True)
    fresh = T.init_params(cfg, seed=5, device="cpu")
    fresh_state = adamw.init_state(fresh)
    ck.restore(1, fresh, fresh_state)
    got = fresh["blocks"][0]["moe"]["router"]
    assert got.dtype == torch.float32 and torch.equal(got, router)
    assert torch.equal(fresh_state["master"]["blocks"][0]["moe"]["router"],
                       router)


def test_check_supported_accepts_moe_and_rejects_what_waits():
    for name in ("mistral-8x7b", "mistral-8x22b"):
        T.check_supported(get_config(name))
        T.check_supported(get_config(name).reduced())
    _, cfg = cfgs("shared")
    T.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="qk_norm"):
        T.check_supported(dataclasses.replace(cfg, qk_norm=True))


def _wave_batch(cfg, t=96, lens=(40, 17, 25), seed=0):
    tok, seg, pos = _packed(np.random.RandomState(seed), list(lens), t,
                            cfg.vocab_size)
    return {"tokens": torch.tensor(tok), "labels": torch.tensor(tok),
            "seg": torch.tensor(seg), "pos": torch.tensor(pos),
            "denom": torch.tensor(82.0)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_recompute_and_offload_route_as_the_forward(bridged, variant):
    """A wave through `grad_step` at capacity factor 0.25 (pairs dropped):
    ``remat="full"`` (each period recomputed in the backward) and
    ``"offload"`` with k = 1 (its input through host buffers) give the
    loss and gradients of ``"none"`` bit for bit, so the recompute routed
    every pair as the forward did."""
    from repro_torch.parallel.host_offload import HostOffload
    from repro_torch.train import train_step as S
    from repro_torch.tree import leaves
    _, cfg = cfgs(variant, "float32", 0.25)
    _, tp = bridged[variant, "float32"]
    batch = _wave_batch(cfg)
    out = []
    for remat, k in (("none", 0), ("full", 0), ("offload", 1)):
        rt = Runtime(device="cpu", remat=remat, offload_periods=k,
                     offload_store=HostOffload(torch.device("cpu")))
        grad_step, _ = S.make_accum_steps(cfg, rt, adamw.AdamWConfig())
        acc, m = grad_step(tp, S.zeros_accum(tp), batch, rt)
        out.append((m["loss"], leaves(acc)))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, out[0][1]))


def test_zero1_shards_restore_and_gather_the_expert_leaves(tmp_path):
    """A checkpoint of the whole optimiser state restores on 4 ranks, each
    taking its `zero1_dim` slice (the stacked [n_periods, E, d, f] expert
    leaves on E, the router on d), and the shards gather back to the
    file's leaves."""
    from repro_torch.ckpt.checkpoint import named_leaves
    from repro_torch.parallel import zero1
    from repro_torch.tree import leaves
    _, cfg = cfgs("mistral", "float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    state = adamw.init_state(params)
    gen = torch.Generator().manual_seed(1)
    for leaf in leaves(state["m"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    CheckpointManager(str(tmp_path)).save(1, params, state, {"step": 1},
                                          block=True)
    full = dict(named_leaves(state["m"]))
    shape = dict(named_leaves(params))

    def rank_fn(comm):
        p = T.init_params(cfg, seed=3, device="cpu")
        st = adamw.init_state(p, comm)
        CheckpointManager(str(tmp_path)).restore(1, p, st, comm)
        mine = dict(named_leaves(st["m"]))
        back = {key: zero1.gather_to_host(leaf.contiguous(),
                                          shape[key].shape, comm)
                for key, leaf in mine.items()}
        return mine, back

    runs = ThreadRanks(4).run(rank_fn)
    assert zero1.zero1_dim(shape["blocks/0/moe/w_in"].shape, 4) == 1
    assert zero1.zero1_dim(shape["blocks/0/moe/router"].shape, 4) == 1
    for r, (mine, _) in enumerate(runs):
        for key, want in full.items():
            dim = zero1.zero1_dim(shape[key].shape, 4)
            if dim is not None:
                want = zero1.shard(want, dim, r, 4)
            assert torch.equal(mine[key], want), (r, key)
    for key, want in full.items():
        np.testing.assert_array_equal(runs[0][1][key], want.numpy(),
                                      err_msg=key)
