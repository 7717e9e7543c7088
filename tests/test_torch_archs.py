"""The port's Gemma-style decoders against the reference: reduced
gemma2-9b (``lg``: local and global layers, window 16, attention softcap
50, final softcap 30, post-block norms, the embedding scale) and reduced
gemma3-12b (``lllllg``, q/k norms), head_dim 16, in float32 with weights
from the reference's `init_params` carried across by `bridge.py`.

* The flash kernels at head_dim 256 (both models'), window and softcap:
  the wrappers' plain versions on the CPU against the Pallas kernels in
  interpret mode; on a card (``cuda`` marker) the (256, 256) CUDA
  instantiations against the plain versions.
* `qk_head_norm`, and the bf16 embedding scale bit-equal to JAX's.
* `forward_hidden` + `logits_head` under both ``attn_impl``.
* 3 `Trainer` steps at hdp = 1 for gemma2-9b (`tests/test_torch_train.py`'s
  holds); gemma3-12b's training is held at hdp = 2 below.
* The counterparts of `tests/test_serve.py::test_sliding_window_ring_buffer`
  and `::test_engine_sliding_window_wraparound` on the port's decode step
  and `ServeEngine`: the local layers' ring buffers past the window.
* `ring_liveness`'s gate per layer kind at g = 2, against the reference's
  `_block_relevant`.
* hdp = 2 (`_torch_archs_worker.py`, 2 gloo ranks, against the reference
  on 2 host devices): a ``"seq"`` slab whose local layers hold
  window-sized caches, and for both models a training wave whose
  50-token sequence (over the window) spans both ranks.

The reference's Trainer history and hdp = 2 cases and the gloo ranks run
as three subprocesses that one module fixture starts when the module
does, beside the in-process cases: the reference's compiles are what
cost this file most.

Norm scales are drawn off their zero init (`W.perturb_norms`) wherever
the weights come from the reference's init, so the (1 + scale) factors
of the norms are held too.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_archs_worker as W
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config as jax_config
from repro.core import ring as jring
from repro.kernels import flash_attention as JFA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import base
from repro_torch.configs.registry import get_config
from repro_torch.core import ring
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel.comm import ThreadRanks
from repro_torch.parallel.sharding import Runtime
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import serve_step as S
from test_torch_flash import _cuda_inputs, _inputs
from test_torch_kernels_bwd import GRAD_TOL, _bwd_inputs, _cuda_bwd_case
from test_torch_kernels_bwd import _rel_l2
from test_torch_train import _port_history
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma2-9b", "gemma3-12b")
IMPLS = ("flash", "ref")
F32_TOL = 1e-4          # tests/test_torch_serve.py, test_torch_train.py
SERVE_TOL = 0.08        # tests/test_serve.py
BF16_ULP = 2.0 ** -8    # one bf16 ulp, relative
FLASH_TOL = {"float32": 5e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
KERNEL_TOL = 2e-2       # the CUDA kernels against their plain versions
D256 = dict(g=2, hg=2, t=64, s=64, dk=256, dv=256)


def _cfgs(arch):
    return (dataclasses.replace(jax_config(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


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


def _packed(rng, lens, t, vocab):
    tok, seg, pos = (np.zeros(t, np.int32) for _ in range(3))
    cur = 0
    for i, n in enumerate(lens):
        tok[cur:cur + n] = rng.randint(0, vocab, n)
        seg[cur:cur + n] = i + 1
        pos[cur:cur + n] = np.arange(n)
        cur += n
    return ({"tokens": jnp.array(tok), "seg": jnp.array(seg),
             "pos": jnp.array(pos)},
            {"tokens": torch.tensor(tok), "seg": torch.tensor(seg),
             "pos": torch.tensor(pos)})


# ---------------------------------------------------------------------------
# the flash kernels at head_dim 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap", [(16, 50.0), (16, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_head_dim_256_matches_pallas(dtype, window, softcap):
    """The forward (finalising, and carrying from a non-zero state) and
    the backward at Dk = Dv = 256, gemma2's local-layer masks (window and
    softcap 50) and gemma3's (no softcap), against the Pallas kernels in
    interpret mode at `tests/test_kernels.py`'s tolerances."""
    g, hg, t, s, dk, dv = (D256[k] for k in ("g", "hg", "t", "s", "dk",
                                             "dv"))
    j, tt, carry, pad = _inputs(11, g, hg, t, s, dk, dv, dtype)
    kw = dict(scale=dk ** -0.5, causal=True, window=window, softcap=softcap)
    pk = dict(block_q=32, block_k=32, interpret=True, **kw)
    tol = FLASH_TOL[dtype]
    out_j, lse_j = JFA.flash_attention_fwd(*j, **pk)
    out, lse = FA.flash_attention_fwd(*tt, **kw)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(out_j, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=tol,
                               rtol=tol)
    want = JFA.flash_attention_fwd_carry(
        *j, *(jnp.array(c) for c in carry), **pk)
    state = tuple(torch.tensor(c) for c in carry)
    FA.flash_attention_fwd_carry(*tt, *state, **kw)
    for got, w in zip(state, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=tol,
                                   rtol=tol)
    jb, tb, kw, pad = _bwd_inputs(12, g, hg, t, s, dk, dv, dtype, window,
                                  softcap)
    want = JFA.flash_attention_bwd(*jb, block_q=32, block_k=32,
                                   interpret=True, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), FA.flash_attention_bwd(*tb,
                                                                     **kw),
                          want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   atol=GRAD_TOL[dtype], rtol=GRAD_TOL[dtype],
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [50.0, 0.0])
def test_cuda_head_dim_256_kernels_match_plain(softcap):
    """On a card: the (256, 256) instantiations of the carry, finalising,
    dq and dkv kernels (bf16) against their plain versions at 2e-2, each
    launch counted once, over 1000 ragged rows with window 16."""
    tt, state, pad = _cuda_inputs("random", 1000, 256, 256, hg=2)
    kw = dict(scale=256 ** -0.5, causal=True, window=16, softcap=softcap)
    n0 = FA.flash_attention_fwd.launches
    out, lse = FA.flash_attention_fwd(*tt, **kw)
    assert FA.flash_attention_fwd.launches == n0 + 1
    out_p, lse_p = FA.flash_attention_fwd_plain(*tt, **kw)
    torch.testing.assert_close(out.float(), out_p.float(), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    torch.testing.assert_close(lse, lse_p, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    want = FA.flash_attention_fwd_carry_plain(*tt, *state, **kw)
    FA.flash_attention_fwd_carry(*tt, *state, **kw)
    for got, w in zip(state, want):
        torch.testing.assert_close(got, w, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    tb, kw, _, want = _cuda_bwd_case(1000, 256, 256, "random", 16, softcap,
                                     hg=2)
    n0 = (FA.flash_attention_bwd_dq.launches,
          FA.flash_attention_bwd_dkv.launches)
    dq, delta = FA.flash_attention_bwd_dq(*tb, **kw)
    dk_, dv_ = FA.flash_attention_bwd_dkv(*tb, delta, **kw)
    assert (FA.flash_attention_bwd_dq.launches,
            FA.flash_attention_bwd_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    for got, w in zip((dq, dk_, dv_), want):
        torch.testing.assert_close(got.float(), w.float(), atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)
        assert _rel_l2(got, w) <= KERNEL_TOL


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------

def test_check_supported_accepts_gemma_and_rejects_what_waits():
    for arch in ARCHS:
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_config(arch))
        T.check_supported(cfg)
        T.check_supported(cfg.reduced())
        assert cfg.reduced().window == 16 and cfg.reduced().head_dim == 16
    cfg = get_config("gemma3-12b").reduced()
    waiting = {
        "layer pattern": dict(layer_pattern="m"),
        "mamba": dict(layer_pattern="m", mamba=base.MambaSpec()),
        "frontend": dict(frontend="vision_stub"),
        "mrope": dict(pos_embed="mrope")}
    for what, kw in waiting.items():
        with pytest.raises(NotImplementedError, match=what):
            T.check_supported(dataclasses.replace(cfg, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_head_norm_matches_jax(dtype):
    """float32 within 1e-6; bf16 within one bf16 ulp (the fp32 rsqrt of
    the two libraries may round a last bit apart before the cast)."""
    rng = np.random.RandomState(0)
    x = rng.randn(9, 4, 16).astype(np.float32) * 3
    scale = (rng.randn(16) * 0.1).astype(np.float32)
    want = JL.qk_head_norm(jnp.asarray(scale), jnp.asarray(x).astype(dtype),
                           1e-6)
    got = L.qk_head_norm(torch.tensor(scale),
                         torch.tensor(x).to(getattr(torch, dtype)), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_embedding_scale_is_bit_equal_in_bf16(arch):
    """At full width (d_model 3584 / 3840) JAX rounds sqrt(d_model) to
    bf16 before it multiplies; the port does the same, bit for bit,
    where a Python float would differ on 9% (gemma3, 61.97 -> 62.0) to
    35% (gemma2, 59.87 -> 59.75) of the elements."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    rng = np.random.RandomState(0)
    table = (rng.randn(64, cfg.d_model) * 0.02).astype(np.float32)
    tokens = rng.randint(0, 64, 300).astype(np.int32)
    want = JT.embed_tokens({"embed": jnp.asarray(table, jnp.bfloat16)}, jcfg,
                           jnp.asarray(tokens))
    emb = torch.tensor(table).to(torch.bfloat16)
    got = T.embed_tokens({"embed": emb}, cfg, torch.tensor(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    naive = emb[torch.tensor(tokens).long()] * math.sqrt(cfg.d_model)
    assert (naive != got).float().mean() > 0.05


# ---------------------------------------------------------------------------
# forward, the bridge and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(bridged, rt1, arch, impl):
    """Three packed segments of 30/20/14 tokens: the local layers' window
    of 16 masks inside the first two.  Logits within 1e-4."""
    jcfg, jp, cfg, tp = bridged[arch]
    jb, tb = _packed(np.random.RandomState(0), [30, 20, 14], 64,
                     cfg.vocab_size)
    want = JT.logits_head(jp, jcfg, JT.forward_hidden(jp, jcfg, rt1, jb))
    got = T.logits_head(tp, cfg, T.forward_hidden(
        tp, cfg, Runtime(device="cpu", attn_impl=impl), tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)


def test_bridge_and_checkpoint_carry_the_gemma_leaves(rt1, tmp_path):
    """bf16 gemma3: q_norm, k_norm and the post-block norms bridge as
    float32 under the reference's keys and survive a checkpoint."""
    jcfg = jax_config("gemma3-12b").reduced()
    cfg = get_config("gemma3-12b").reduced()
    flat = W.perturb_norms(_flatten(JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg, rt1)))
    tp = bridge.params_from_flat(flat, cfg, "cpu")
    attn, blk = tp["blocks"][0]["attn"], tp["blocks"][5]
    for x in (attn["q_norm"], attn["k_norm"], blk["postnorm1"]["scale"],
              blk["postnorm2"]["scale"]):
        assert x.dtype == torch.float32
    assert attn["w_q"].dtype == torch.bfloat16
    back = bridge.params_to_flat(tp)
    assert sorted(back) == sorted(flat)
    assert any(k.endswith("attn/q_norm") for k in back)
    for key in flat:
        if key.rsplit("/", 1)[-1] in ("q_norm", "k_norm", "scale"):
            np.testing.assert_array_equal(back[key], flat[key], err_msg=key)
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, tp, adamw.init_state(tp), {"step": 1}, block=True)
    fresh = T.init_params(cfg, seed=3, device="cpu")
    state = adamw.init_state(fresh)
    ck.restore(1, fresh, state)
    for x, y in ((fresh["blocks"][2]["attn"]["k_norm"],
                  tp["blocks"][2]["attn"]["k_norm"]),
                 (state["master"]["blocks"][5]["postnorm2"]["scale"],
                  tp["blocks"][5]["postnorm2"]["scale"])):
        assert x.dtype == torch.float32 and torch.equal(x, y)


# ---------------------------------------------------------------------------
# decode through the ring buffers, the engine past the window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sliding_window_ring_buffer(bridged, rt1, arch):
    """`tests/test_serve.py::test_sliding_window_ring_buffer` on the port:
    40 positions (> the window of 16) decoded one at a time through the
    local layers' 16-position ring buffers match the windowed packed
    forward, here within 1e-4 in float32 (the reference test holds bf16
    at 0.08), and that forward the reference's within 1e-4: the
    reference's decode is held through its engine below."""
    jcfg, jp, cfg, tp = bridged[arch]
    t, b = 40, 2
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (b, t))
    rt = Runtime(device="cpu")
    cache = S.init_decode_cache(cfg, rt, b, t)
    lens = [c["k"].shape[2] for c in cache["blocks"]]
    assert lens == [16 if c == "l" else t for c in cfg.layer_pattern]
    step = S.make_decode_step(cfg, rt, b, t)
    got = []
    for i in range(t):
        lg, cache = step(tp, cache, torch.tensor(tokens[:, i]), i)
        got.append(lg.numpy())
    jb, tb = _packed(np.random.RandomState(0), [t, t], 2 * t, cfg.vocab_size)
    flat = tokens.reshape(-1).astype(np.int32)
    jb["tokens"], tb["tokens"] = jnp.asarray(flat), torch.tensor(flat)
    ref = T.logits_head(tp, cfg, T.forward_hidden(tp, cfg, rt, tb))
    np.testing.assert_allclose(np.stack(got, 1),
                               ref.reshape(b, t, -1).numpy(), atol=F32_TOL,
                               rtol=0)
    want = JT.logits_head(jp, jcfg, JT.forward_hidden(jp, jcfg, rt1, jb))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)


def _engine_run(eng, prompts, new):
    rids = [eng.submit(p, n) for p, n in zip(prompts, new)]
    eng.drain(max_steps=200)
    return [eng.pool.get(r) for r in rids]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_sliding_window_wraparound(bridged, rt1, arch):
    """`tests/test_serve.py::test_engine_sliding_window_wraparound` on the
    port: prompts of 24 and 19 tokens (> the window) land in the ring
    buffers where decode would have written them, and generation past
    the wrap point matches the teacher-forced windowed forward (argmax,
    0.08) and the reference's engine (tokens, logits within 1e-4)."""
    from repro.serve import ServeConfig as JConfig, ServeEngine as JEngine
    jcfg, jp, cfg, tp = bridged[arch]
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (24, 19)]
    new = (10, 7)
    scfg = dict(max_slots=2, max_context=64, prefill_capacity=64,
                collect_logits=True)
    want = _engine_run(JEngine(jp, jcfg, rt1, JConfig(**scfg)), prompts, new)
    rt = Runtime(device="cpu")
    got = _engine_run(ServeEngine(tp, cfg, rt, ServeConfig(**scfg)),
                      prompts, new)
    for g, w in zip(got, want):
        assert g.error is None and g.generated == w.generated
        rows = np.stack(g.logits)
        np.testing.assert_allclose(rows, np.stack(w.logits), atol=F32_TOL,
                                   rtol=0)
        toks = np.concatenate([g.prompt, g.generated[:-1]]).astype(np.int32)
        n = len(toks)
        h = T.forward_hidden(tp, cfg, rt, {
            "tokens": torch.tensor(toks),
            "seg": torch.ones(n, dtype=torch.int32),
            "pos": torch.arange(n, dtype=torch.int32)})
        ref = T.logits_head(tp, cfg, h[g.plen - 1:]).numpy()
        assert [int(r.argmax()) for r in ref] == g.generated
        np.testing.assert_allclose(rows, ref, atol=SERVE_TOL, rtol=SERVE_TOL)


def test_ring_liveness_gates_each_layer_kind_as_the_reference():
    """At g = 2, rank 1's queries (positions 40..79 of one sequence) see
    rank 0's keys (0..39) in a global layer, and in a window-16 local layer
    only through its first 15 positions; a window of 8 after 40 positions
    sees none of them: the step is dead for that layer kind alone.  Every
    verdict equals the reference's `_block_relevant` on the same metas."""
    seg = torch.ones(80, dtype=torch.int32)
    pos = torch.arange(80, dtype=torch.int32)
    for window, want in ((0, True), (16, True), (50, True), (8, True),
                         (1, False)):
        def table(comm):
            sl = slice(comm.rank * 40, (comm.rank + 1) * 40)
            return ring.ring_liveness(comm, (2,), seg[sl], pos[sl], seg[sl],
                                      pos[sl], causal=True, window=window)
        got = ThreadRanks(2).run(table)[0]
        q = jring._block_meta(jnp.asarray(seg[40:].numpy()),
                              jnp.asarray(pos[40:].numpy()))
        k = jring._block_meta(jnp.asarray(seg[:40].numpy()),
                              jnp.asarray(pos[:40].numpy()))
        ref = bool(jring._block_relevant(q, k, causal=True, window=window))
        assert bool(got[1, 1]) == ref == want, window
        assert bool(got[0, 1]) is False          # the future: dead
    # a window shorter than the gap between the two blocks' positions
    pos2 = torch.cat([torch.arange(40), torch.arange(100, 140)]).int()

    def table2(comm):
        sl = slice(comm.rank * 40, (comm.rank + 1) * 40)
        return [ring.ring_liveness(comm, (2,), seg[sl], pos2[sl], seg[sl],
                                   pos2[sl], causal=True, window=w)
                for w in (16, 0)]
    local, glob = ThreadRanks(2).run(table2)[0]
    assert not bool(local[1, 1]) and bool(glob[1, 1])


# ---------------------------------------------------------------------------
# the reference's processes: its Trainer history, its hdp = 2 cases
# ---------------------------------------------------------------------------

def test_three_trainer_steps_match_jax(jax_trainer_history):
    """Reduced gemma2-9b: the reference's `Trainer` (run by the module's
    `HISTORY_SCRIPT` process) and the port's from the same initial params
    on the same plans (`tests/test_torch_train.py::_port_history`: losses
    and grad norms within 1e-4); every wave's loss within 1e-4 and every
    step's update within 1e-3 relative L2 per leaf.  Sequences up to the
    capacity of 256 (over the window of 16), so every wave has one shape
    and the reference compiles one grad step."""
    history = jax_trainer_history
    tr, after = _port_history(history, "flash", W.ARCH, context=256)
    assert tr.params["blocks"][0]["postnorm1"]["scale"].dtype \
        == torch.float32
    before = history[0]
    for (got, got_w), (want, want_w) in zip(after, history[3]):
        np.testing.assert_allclose(got_w, want_w, rtol=F32_TOL)
        assert sorted(got) == sorted(want)
        for key in want:
            upd = want[key] - before[key]
            rel = np.linalg.norm(got[key] - before[key] - upd) \
                / np.linalg.norm(upd)
            assert rel <= 1e-3, (key, rel)
        before = want


# ---------------------------------------------------------------------------
# hdp = 2 against the reference on 2 host devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config
from repro.core.loss import token_ce_loss
from repro.models.transformer import forward_hidden, init_params
from repro.parallel.sharding import (Runtime, params_pspecs,
                                     shardings_from_pspecs)
from repro.serve import ServeConfig, ServeEngine
sys.path.insert(0, "tests")
import _torch_archs_worker as W

out = sys.argv[1]
mesh = compat.make_mesh((W.R, 1), ("data", "model"),
                        axis_types=compat.auto_axis_types(2))
compat.set_mesh(mesh)
rt = Runtime(mesh=mesh, hdp_axes=("data",), model_axis="model",
             remat="none")
def leaf(path, x):
    key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                   for p in path)
    return jnp.asarray(flat[key], x.dtype)
models = {}
for arch in W.ARCHS:                 # the weights first: the ranks wait
    cfg = W.config(get_config(arch).reduced())
    params = init_params(jax.random.PRNGKey(0), cfg, rt)
    flat = W.perturb_norms(_flatten(params))
    models[arch] = (cfg, jax.tree_util.tree_map_with_path(leaf, params))
    np.savez(out + "/jax_params.tmp.npz", **flat)
    os.replace(out + "/jax_params.tmp.npz", out + f"/jax_params_{arch}.npz")
res = {}

cfg, params = models[W.ARCH]
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
for arch, (cfg, params) in models.items():
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
        l, _ = token_ce_loss(p, cfg, rt_c, h, b["labels"], b["seg"],
                             b["denom"])
        return l
    l, g = jax.jit(jax.value_and_grad(loss), in_shardings=in_sh)(params,
                                                                  batch)
    res[f"train/{arch}/loss"] = np.asarray(l)
    for key, x in _flatten(g).items():
        res[f"train/{arch}/grad/{key}"] = x
np.savez(out + "/jax_archs.npz", **res)
"""


# the reference's 3-step `Trainer` history of reduced gemma2-9b, one host
# device, pickled for `test_three_trainer_steps_match_jax`
HISTORY_SCRIPT = r"""
import pickle, sys
sys.path.insert(0, "tests")
from repro import compat
from repro.parallel.sharding import single_device_runtime
import _torch_archs_worker as W
from test_torch_train import _jax_history
rt = single_device_runtime(remat="none")
compat.set_mesh(rt.mesh)
history = _jax_history(rt, W.ARCH, context=256)
with open(sys.argv[1] + "/jax_history.pkl", "wb") as f:
    pickle.dump(history, f)
"""


@pytest.fixture(scope="module", autouse=True)
def hdp2_procs(tmp_path_factory):
    """Start the reference's processes (its Trainer history on one host
    device; its hdp = 2 cases on 2) and the 2 gloo ranks together when the
    module starts, so they run beside the in-process cases -> (out dir,
    processes, logs); stops them at the module's end."""
    out = tmp_path_factory.mktemp("archs")
    env = subprocess_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs, logs = {}, {}
    for part, cmd in (
            ("history", [sys.executable, "-c", HISTORY_SCRIPT, str(out)]),
            ("jax", [sys.executable, "-c", JAX_SCRIPT, str(out)]),
            ("torch", [sys.executable,
                       str(ROOT / "tests" / "_torch_archs_worker.py"),
                       str(out)])):
        logs[part] = out / f"{part}.log"
        with open(logs[part], "w") as log:
            procs[part] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                           stdout=log, stderr=log)
    try:
        yield out, procs, logs
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _finished(hdp2_procs, parts):
    out, procs, logs = hdp2_procs
    for part in parts:
        procs[part].wait(timeout=900)
        assert procs[part].returncode == 0, (
            part, logs[part].read_text()[-4000:])
    return out


@pytest.fixture(scope="module")
def jax_trainer_history(hdp2_procs):
    """The reference's history (`test_torch_train._jax_history`), once
    its process has ended."""
    out = _finished(hdp2_procs, ("history",))
    with open(out / "jax_history.pkl", "rb") as f:
        return pickle.load(f)        # written by this module's process


@pytest.fixture(scope="module")
def hdp2(hdp2_procs):
    """-> (reference results, per-rank port results), once both
    processes have ended."""
    out = _finished(hdp2_procs, ("jax", "torch"))
    ref = dict(np.load(out / "jax_archs.npz"))
    ranks = [dict(np.load(out / f"torch_rank{r}.npz")) for r in range(W.R)]
    return ref, ranks


@pytest.mark.parametrize("impl", IMPLS)
def test_hdp2_seq_slab_serves_like_jax(hdp2, impl):
    """3 slots on 2 ranks: the ``"seq"`` layout, each rank 32 of a global
    layer's positions and 8 of a local layer's 16-position ring buffer;
    the 40-token prompt prefills through a (2,) ring.  Both ranks'
    tokens equal the reference's and their logit rows are bit-identical
    to each other and within 1e-4 of the reference's; the waves'
    compositions are the reference's."""
    ref, ranks = hdp2
    pre = f"serve/{impl}/"
    cfg = get_config(W.ARCH).reduced()
    for rk in ranks:
        assert str(rk[pre + "layout"]) == "seq"
        assert rk[pre + "cache_positions"].tolist() == [
            8 if c == "l" else W.MAX_CONTEXT // W.R
            for c in cfg.layer_pattern]
        assert str(rk[pre + "comps"]) == str(ref["serve/comps"])
        assert "(2,)" in str(rk[pre + "comps"])
        np.testing.assert_array_equal(rk[pre + "tokens"], ref["serve/tokens"])
        np.testing.assert_array_equal(rk[pre + "logits"],
                                      ranks[0][pre + "logits"])
    np.testing.assert_allclose(ranks[0][pre + "logits"], ref["serve/logits"],
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_hdp2_wave_over_the_window_trains_like_jax(hdp2, arch, impl):
    """One (2,) wave whose 50-token sequence spans both ranks' rows, so
    the local layers' window crosses the rank boundary through the ring:
    the ranks' loss shares sum to the reference's loss and the
    rank-summed gradients equal its gradients (the q/k norms' too in
    gemma3-12b), within 1e-4."""
    ref, ranks = hdp2
    pre = f"train/{arch}/{impl}/"
    shares = [float(rk[pre + "loss"]) for rk in ranks]
    assert all(s > 0 for s in shares)
    np.testing.assert_allclose(sum(shares), float(ref[f"train/{arch}/loss"]),
                               rtol=F32_TOL)
    base = f"train/{arch}/grad/"
    keys = [k for k in ref if k.startswith(base)]
    assert any(k.endswith("postnorm1/scale") for k in keys)
    assert (arch == "gemma3-12b") == any(k.endswith("attn/q_norm")
                                         for k in keys)
    for key in keys:
        leaf = key[len(base):]
        got = sum(rk[pre + "grad/" + leaf] for rk in ranks)
        np.testing.assert_allclose(got, ref[key], atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=leaf)
