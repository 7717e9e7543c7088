"""The port's flash backward and fused cross-entropy (plain versions, which
the wrappers run on the CPU) against the reference's Pallas kernels in
interpret mode, the differentiable ring-flash against the reference's
custom VJP, and the CUDA kernels against their plain versions on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ring import ring_attention as jax_ring_attention
from repro.kernels import flash_attention as JFA
from repro.kernels import fused_ce as JCE
from repro.kernels import ref as jref
from repro_torch.core.ring import ring_attention
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_ce as CE
from repro_torch.kernels import ops
from repro_torch.kernels import ring_flash as RF

from test_torch_flash import MASKS, SHAPES, _cuda_inputs, _inputs
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}    # tests/test_kernels.py:70
CE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}      # tests/test_kernels.py:82


def _bwd_inputs(seed, g, hg, t, s, dk, dv, dtype, window, softcap):
    """Same inputs on both sides: (q, k, v, meta) from `_inputs`, (out,
    lse) from the reference's forward, do from numpy."""
    j, tt, _, pad = _inputs(seed, g, hg, t, s, dk, dv, dtype)
    kw = dict(scale=dk ** -0.5, causal=True, window=window, softcap=softcap)
    out_j, lse_j = JFA.flash_attention_fwd(*j, block_q=32, block_k=32,
                                           interpret=True, **kw)
    do = np.random.RandomState(seed + 1).randn(g, hg, t, dv)
    do_j = jnp.array(do, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    res_t = [torch.tensor(np.asarray(x, np.float32)).to(tdt)
             for x in (out_j, do_j)]
    lse_t = torch.tensor(np.asarray(lse_j))
    return (j + [out_j, lse_j, do_j], tt + [res_t[0], lse_t, res_t[1]], kw,
            pad)


@pytest.mark.parametrize("window,softcap", MASKS)
@pytest.mark.parametrize("g,hg,t,s,dk,dv", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_matches_pallas(g, hg, t, s, dk, dv, dtype, window,
                                  softcap):
    j, tt, kw, pad = _bwd_inputs(g * 10 + hg, g, hg, t, s, dk, dv, dtype,
                                 window, softcap)
    want = JFA.flash_attention_bwd(*j, block_q=32, block_k=32,
                                   interpret=True, **kw)
    n0 = (FA.flash_attention_bwd_dq.launches,
          FA.flash_attention_bwd_dkv.launches)
    got = FA.flash_attention_bwd(*tt, **kw)
    assert (FA.flash_attention_bwd_dq.launches,
            FA.flash_attention_bwd_dkv.launches) == n0   # CPU: plain
    tol = GRAD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)
    # padding query rows: exactly zero dq
    assert (got[0][:, :, pad] == 0).all()
    # the two kernel wrappers give the same as the joint call on the CPU
    dq, delta = FA.flash_attention_bwd_dq(*tt, **kw)
    torch.testing.assert_close(dq, got[0], atol=0, rtol=0)
    torch.testing.assert_close(
        delta, (tt[9].float() * tt[7].float()).sum(-1), atol=0, rtol=0)
    for a, b in zip(FA.flash_attention_bwd_dkv(*tt, delta, **kw), got[1:]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_flash_bwd_rejects_mismatched_residuals():
    _, tt, kw, _ = _bwd_inputs(4, 1, 1, 64, 64, 32, 32, "float32", 0, 0.0)
    q, k, v, qs, ks, qp, kp, out, lse, do = tt
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd(q, k, v, qs, ks, qp, kp, out, lse.double(),
                               do, **kw)
    with pytest.raises(ValueError, match="out and do"):
        FA.flash_attention_bwd(q, k, v, qs, ks, qp, kp, out, lse,
                               do[..., :16].contiguous(), **kw)
    with pytest.raises(ValueError, match="delta"):
        FA.flash_attention_bwd_dkv(q, k, v, qs, ks, qp, kp, out, lse, do,
                                   lse[..., :8].contiguous(), **kw)


def _ring_case(gather):
    rng = np.random.RandomState(3)
    t, h, g, d = 48, 4, 2, 16
    q = rng.randn(t, h, d).astype(np.float32)
    k = rng.randn(t, g, d).astype(np.float32)
    v = rng.randn(t, g, d).astype(np.float32)
    seg = np.array([1] * 30 + [2] * 12 + [0] * 6, np.int32)
    pos = np.concatenate([np.arange(30), np.arange(12),
                          np.zeros(6)]).astype(np.int32)
    kgh = np.array([0, 0, 1, 1], np.int32) if gather else None
    return q, k, v, seg, pos, kgh


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 20.0)])
def test_ring_flash_grad_matches_jax(rt1, gather, window, softcap):
    """composition (1,): the port's differentiable ring-flash (through
    `ring_attention(attn_impl="flash")`) against the reference's
    ``ops.make_ring_flash`` custom VJP (attn_impl="pallas")."""
    q, k, v, seg, pos, kgh = _ring_case(gather)
    kw = dict(composition=(1,), kv_sharded=not gather, scale=0.3,
              window=window, softcap=softcap)

    def f_jax(q, k, v):
        o = jax_ring_attention(
            q, k, v, jnp.array(seg), jnp.array(seg), jnp.array(pos),
            jnp.array(pos), mesh=rt1.mesh, hdp_axes=rt1.hdp_axes,
            model_axis=rt1.model_axis, attn_impl="pallas", block_q=48,
            block_k=48, kv_group_of_head=(None if kgh is None
                                          else jnp.array(kgh)), **kw)
        return (o ** 2).sum()

    l_j, g_j = jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1, 2)))(
        jnp.array(q), jnp.array(k), jnp.array(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = ring_attention(tq, tk, tv, *(torch.tensor(x) for x in
                                     (seg, seg, pos, pos)),
                       kv_group_of_head=(None if kgh is None
                                         else torch.tensor(kgh)),
                       attn_impl="flash", **kw)
    loss = (o ** 2).sum()
    loss.backward()
    assert abs(loss.item() - float(l_j)) <= 1e-3 * abs(float(l_j))
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-3, err_msg=f"d{name}")


def test_make_ring_flash_is_cached_and_needs_no_grad():
    cfg = RF.RingConfig(composition=(1,), kv_split=(16, 16, 16),
                        gather=False, scale=0.25)
    assert ops.make_ring_flash(cfg) is ops.make_ring_flash(cfg)
    q, k, v, seg, pos, _ = _ring_case(False)
    kv = torch.tensor(np.concatenate([k, v], -1))
    meta = [torch.tensor(x) for x in (seg, seg, pos, pos)]
    with torch.inference_mode():
        out = ops.make_ring_flash(cfg)(torch.tensor(q), kv, *meta, None)
    want, _ = RF.ring_flash_fwd(cfg, torch.tensor(q), kv, *meta, None)
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    # one rank (no comm): a ring group of two has no second rank
    with pytest.raises(ValueError, match="does not sum"):
        RF.ring_flash_fwd(RF.RingConfig(composition=(2,),
                                        kv_split=(16, 16, 16), gather=False,
                                        scale=0.25), torch.tensor(q), kv,
                          *meta, None)


def _ce_inputs(t, v, dtype, seed):
    rng = np.random.RandomState(seed)
    lg = rng.randn(t, v) * 3
    labels = rng.randint(0, v, t).astype(np.int32)
    g = rng.randn(t).astype(np.float32)
    lg_j = jnp.array(lg, getattr(jnp, dtype))
    lg_t = torch.tensor(np.asarray(lg_j, np.float32)).to(getattr(torch,
                                                                 dtype))
    return lg_j, lg_t, labels, g


@pytest.mark.parametrize("t,v", [(64, 512), (128, 1024), (32, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ce_matches_pallas(t, v, dtype):
    lg_j, lg_t, labels, g = _ce_inputs(t, v, dtype, t)
    nll_j, lse_j, tgt_j = JCE.fused_ce_fwd(lg_j, jnp.array(labels),
                                           interpret=True)
    n0 = CE.fused_ce_fwd.launches, CE.fused_ce_bwd.launches
    nll, lse, tgt = CE.fused_ce_fwd(lg_t, torch.tensor(labels))
    tol = CE_TOL[dtype]
    for a, b in ((nll, nll_j), (lse, lse_j), (tgt, tgt_j)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=tol)
    d_j = JCE.fused_ce_bwd(lg_j, jnp.array(labels), lse_j, jnp.array(g),
                           interpret=True)
    d = CE.fused_ce_bwd(lg_t, torch.tensor(labels), lse, torch.tensor(g))
    assert d.dtype == lg_t.dtype
    np.testing.assert_allclose(d.float().numpy(), np.asarray(d_j, np.float32),
                               atol=tol, rtol=tol)
    assert (CE.fused_ce_fwd.launches, CE.fused_ce_bwd.launches) == n0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ce_ragged_vocab_matches_ref(dtype):
    """V = 1000 is no multiple of the Pallas kernel's panel: held against
    the reference's jnp oracles; padding rows (g = 0) give exact zeros."""
    t, v = 48, 1000
    lg_j, lg_t, labels, g = _ce_inputs(t, v, dtype, 7)
    g[-5:] = 0.0
    labels[-5:] = 0
    nll_r, lse_r = jref.fused_ce_ref(lg_j, jnp.array(labels))
    d_r = jref.fused_ce_grad_ref(lg_j, jnp.array(labels), jnp.array(g))
    nll, lse, _ = CE.fused_ce_fwd(lg_t, torch.tensor(labels))
    d = CE.fused_ce_bwd(lg_t, torch.tensor(labels), lse, torch.tensor(g))
    tol = CE_TOL[dtype]
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_r), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(d.float().numpy(), np.asarray(d_r, np.float32),
                               atol=tol, rtol=tol)
    assert (d[-5:] == 0).all()


def test_fused_softmax_xent_grad_is_the_bwd_kernel():
    """The autograd Function's gradient is `fused_ce_bwd` of the forward's
    lse, and matches autograd through the plain log-sum-exp."""
    from repro_torch.core.loss import token_ce_from_logits
    _, lg, labels, g = _ce_inputs(40, 700, "float32", 2)
    labels_t = torch.tensor(labels)
    valid = torch.ones(40, dtype=torch.bool)
    valid[-4:] = False
    x1 = lg.clone().requires_grad_(True)
    x2 = lg.clone().requires_grad_(True)
    l1, _ = token_ce_from_logits(x1, labels_t, valid, 37.0, impl="flash")
    l2, _ = token_ce_from_logits(x2, labels_t, valid, 37.0, impl="ref")
    l1.backward()
    l2.backward()
    torch.testing.assert_close(l1, l2, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x1.grad, x2.grad, atol=1e-6, rtol=1e-5)
    assert (x1.grad[-4:] == 0).all()


# ---------------------------------------------------------------------------
# on the card: each new kernel against its plain version
# ---------------------------------------------------------------------------

def _cuda_bwd_case(t, dk, dv, layout, window, softcap, hg=3):
    """On the card, metadata as in `test_torch_flash._cuda_inputs`: (out,
    lse) from the plain forward (the Pallas kernel needs T to be a multiple
    of its tile)."""
    tt, _, pad = _cuda_inputs(layout, t, dk, dv, hg)
    kw = dict(scale=dk ** -0.5, causal=True, window=window, softcap=softcap)
    out, lse = FA.flash_attention_fwd_plain(*tt, **kw)
    do = torch.tensor(np.random.RandomState(6).randn(2, hg, t, dv),
                      dtype=torch.bfloat16, device="cuda")
    tt = tt + [out, lse, do]
    return tt, kw, pad, FA.flash_attention_bwd_plain(*tt, **kw)


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


CUDA_BWD_CASES = [  # t, dk, dv, layout, window, softcap
    (1000, 128, 128, "random", 0, 0.0), (200, 64, 64, "random", 16, 30.0),
    (256, 128, 64, "random", 0, 0.0), (4096, 128, 128, "diag64", 0, 0.0),
    (1000, 64, 64, "offedge", 0, 0.0), (512, 128, 128, "padtiles", 0, 0.0),
    (4096, 128, 128, "random", 16, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,dk,dv,layout,window,softcap", CUDA_BWD_CASES)
def test_cuda_flash_bwd_dq_matches_plain(t, dk, dv, layout, window, softcap):
    """Against the plain version; padding rows exactly 0; a second run
    gives bit-identical dq and delta (no atomics)."""
    tt, kw, pad, want = _cuda_bwd_case(t, dk, dv, layout, window, softcap)
    n0 = FA.flash_attention_bwd_dq.launches
    dq, delta = FA.flash_attention_bwd_dq(*tt, **kw)
    assert FA.flash_attention_bwd_dq.launches == n0 + 1
    torch.testing.assert_close(dq.float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    assert _rel_l2(dq, want[0]) <= 2e-2
    assert (dq[:, :, pad] == 0).all()
    torch.testing.assert_close(delta, FA._delta(tt[7], tt[9]), atol=1e-4,
                               rtol=1e-4)
    again = FA.flash_attention_bwd_dq(*tt, **kw)
    assert torch.equal(again[0], dq) and torch.equal(again[1], delta)


# Hg = 1 and Hg = 4: a dq block holds fewer heads than it has warpgroups
CUDA_DQ_HEAD_CASES = [  # hg, t, dk, dv, layout
    (1, 1000, 128, 128, "random"), (4, 512, 128, 64, "random"),
    (4, 1000, 64, 64, "offedge"), (1, 512, 32, 32, "padtiles")]


@pytest.mark.cuda
@pytest.mark.parametrize("hg,t,dk,dv,layout", CUDA_DQ_HEAD_CASES)
def test_cuda_flash_bwd_head_counts_match_plain(hg, t, dk, dv, layout):
    """dq, delta and then dkv from that delta against the plain version
    where the heads of a group do not fill the dq kernel's last block."""
    tt, kw, pad, want = _cuda_bwd_case(t, dk, dv, layout, 0, 0.0, hg)
    dq, delta = FA.flash_attention_bwd_dq(*tt, **kw)
    dk_, dv_ = FA.flash_attention_bwd_dkv(*tt, delta, **kw)
    for got, w in zip((dq, dk_, dv_), want):
        torch.testing.assert_close(got.float(), w.float(), atol=2e-2,
                                   rtol=2e-2)
        assert _rel_l2(got, w) <= 2e-2
    assert (dq[:, :, pad] == 0).all()
    torch.testing.assert_close(delta, FA._delta(tt[7], tt[9]), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_bwd_dq_writes_every_row():
    """dq comes from an uninitialised allocation: with a NaN-filled block
    of its size freed just before the call, the padding-only q tile (rows
    128-191 of "padtiles") and every padding row still come out exactly
    0, and nothing is left NaN."""
    tt, kw, pad, want = _cuda_bwd_case(512, 128, 128, "padtiles", 0, 0.0)
    poison = torch.full_like(tt[0], float("nan"))
    del poison
    dq, _ = FA.flash_attention_bwd_dq(*tt, **kw)
    assert not dq.isnan().any()
    assert (dq[:, :, 128:192] == 0).all() and (dq[:, :, pad] == 0).all()
    torch.testing.assert_close(dq.float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t,dk,dv,layout,window,softcap", CUDA_BWD_CASES)
def test_cuda_flash_bwd_dkv_matches_plain(t, dk, dv, layout, window,
                                          softcap):
    """Against the plain version; padding keys exactly 0; a second run
    gives bit-identical dk and dv (no atomics)."""
    tt, kw, _, want = _cuda_bwd_case(t, dk, dv, layout, window, softcap)
    k_pad = tt[4] == 0
    _, delta = FA.flash_attention_bwd_dq(*tt, **kw)
    n0 = FA.flash_attention_bwd_dkv.launches
    dk_, dv_ = FA.flash_attention_bwd_dkv(*tt, delta, **kw)
    assert FA.flash_attention_bwd_dkv.launches == n0 + 1
    for got, w in zip((dk_, dv_), want[1:]):
        torch.testing.assert_close(got.float(), w.float(), atol=2e-2,
                                   rtol=2e-2)
        assert _rel_l2(got, w) <= 2e-2
        assert (got[:, k_pad] == 0).all()
    again = FA.flash_attention_bwd_dkv(*tt, delta, **kw)
    assert torch.equal(again[0], dk_) and torch.equal(again[1], dv_)


def _cuda_ce_case(t, v):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, lg, labels, g = _ce_inputs(t, v, "bfloat16", 1)
    g[-3:] = 0.0
    return (lg.cuda(), torch.tensor(labels).cuda(), torch.tensor(g).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("t,v", [(256, 128256), (64, 1000), (33, 4096)])
def test_cuda_fused_ce_fwd_matches_plain(t, v):
    lg, labels, _ = _cuda_ce_case(t, v)
    n0 = CE.fused_ce_fwd.launches
    got = CE.fused_ce_fwd(lg, labels)
    assert CE.fused_ce_fwd.launches == n0 + 1
    for a, b in zip(got, CE.fused_ce_fwd_plain(lg, labels)):
        torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t,v", [(256, 128256), (64, 1000), (33, 4096)])
def test_cuda_fused_ce_bwd_matches_plain(t, v):
    lg, labels, g = _cuda_ce_case(t, v)
    lse = CE.fused_ce_fwd_plain(lg, labels)[1]
    n0 = CE.fused_ce_bwd.launches
    d = CE.fused_ce_bwd(lg, labels, lse, g)
    assert CE.fused_ce_bwd.launches == n0 + 1
    want = CE.fused_ce_bwd_plain(lg, labels, lse, g)
    torch.testing.assert_close(d.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert _rel_l2(d, want) <= 2e-2
    assert (d[-3:] == 0).all()
