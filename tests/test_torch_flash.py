"""The port's flash forward (plain versions, which the wrappers run on the
CPU) against the reference's Pallas kernels in interpret mode, and the
CUDA kernels against the plain versions on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

NEG_INF = -1.0e30
TOL = {"float32": 5e-5, "bfloat16": 2e-2}      # tests/test_kernels.py


def _meta(rng, t, n_seq, n_pad):
    """n_seq packed segments over the first t - n_pad rows, padding after."""
    n = t - n_pad
    bounds = sorted(rng.choice(np.arange(1, n), n_seq - 1, replace=False))
    bounds = [0] + list(bounds) + [n]
    seg = np.zeros(t, np.int32)
    pos = np.zeros(t, np.int32)
    for i in range(n_seq):
        a, b = bounds[i], bounds[i + 1]
        seg[a:b] = i + 1
        pos[a:b] = np.arange(b - a)
    return seg, pos


def _inputs(seed, g, hg, t, s, dk, dv, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(g, hg, t, dk)
    k = rng.randn(g, s, dk)
    v = rng.randn(g, s, dv)
    q_seg, q_pos = _meta(rng, t, 3, n_pad=5)
    k_seg, k_pos = _meta(rng, s, 3, n_pad=3)
    carry = (rng.randn(g, hg, t, dv).astype(np.float32),
             rng.randn(g, hg, t).astype(np.float32),
             (rng.rand(g, hg, t) + 0.5).astype(np.float32))
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    j = ([jnp.array(x, jdt) for x in (q, k, v)]
         + [jnp.array(x) for x in (q_seg, k_seg, q_pos, k_pos)])
    # the same rounded values on both sides
    tq = [torch.tensor(np.asarray(x, np.float32)).to(tdt) for x in j[:3]]
    tm = [torch.tensor(x) for x in (q_seg, k_seg, q_pos, k_pos)]
    return j, tq + tm, carry, q_seg == 0


SHAPES = [(1, 1, 64, 64, 32, 32), (2, 2, 64, 128, 64, 64),
          (2, 4, 128, 64, 32, 16), (4, 1, 64, 64, 128, 128)]
MASKS = [(0, 0.0), (16, 30.0)]


@pytest.mark.parametrize("window,softcap", MASKS)
@pytest.mark.parametrize("g,hg,t,s,dk,dv", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_matches_pallas(g, hg, t, s, dk, dv, dtype, window,
                                  softcap):
    j, tt, _, pad = _inputs(g * 100 + hg, g, hg, t, s, dk, dv, dtype)
    kw = dict(scale=dk ** -0.5, causal=True, window=window, softcap=softcap)
    out_j, lse_j = JFA.flash_attention_fwd(*j, block_q=32, block_k=32,
                                           interpret=True, **kw)
    before = FA.flash_attention_fwd.launches
    out, lse = FA.flash_attention_fwd(*tt, **kw)
    assert FA.flash_attention_fwd.launches == before   # CPU: plain version
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(out_j, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=tol,
                               rtol=tol)
    # padding rows: exactly zero output, lse exactly NEG_INF
    assert (out[:, :, pad] == 0).all()
    assert (lse[:, :, pad] == NEG_INF).all()


@pytest.mark.parametrize("window,softcap", MASKS)
@pytest.mark.parametrize("g,hg,t,s,dk,dv", SHAPES[1:3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_carry_matches_pallas(g, hg, t, s, dk, dv, dtype, window,
                                        softcap):
    """Non-zero carry-in; the wrapper updates (acc, m, l) in place."""
    j, tt, carry, pad = _inputs(7 + g, g, hg, t, s, dk, dv, dtype)
    kw = dict(scale=dk ** -0.5, causal=True, window=window, softcap=softcap)
    acc_j, m_j, l_j = JFA.flash_attention_fwd_carry(
        *j, *(jnp.array(c) for c in carry), block_q=32, block_k=32,
        interpret=True, **kw)
    state = tuple(torch.tensor(c) for c in carry)
    out = FA.flash_attention_fwd_carry(*tt, *state, **kw)
    assert all(a is b for a, b in zip(out, state))
    tol = TOL[dtype]
    for got, want in zip(state, (acc_j, m_j, l_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=tol)
    # padding query rows keep their carry exactly
    for got, c in zip(state, carry):
        np.testing.assert_array_equal(got.numpy()[:, :, pad], c[:, :, pad])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_ragged_tail(dtype):
    """T = S = 50 is no multiple of any tile: held against the dense
    reference oracle, which has no divisibility assert."""
    j, tt, _, pad = _inputs(3, 2, 2, 50, 50, 32, 32, dtype)
    kw = dict(scale=0.2, causal=True, window=0, softcap=0.0)
    want = jref.flash_attention_ref(*j, **kw)
    out, lse = FA.flash_attention_fwd(*tt, **kw)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(
        ref.flash_attention_ref(*tt, **kw).float().numpy(),
        np.asarray(want, np.float32), atol=tol, rtol=tol)
    assert (out[:, :, pad] == 0).all() and (lse[:, :, pad] == NEG_INF).all()


def test_wrappers_reject_what_the_kernel_does_not_take():
    _, tt, carry, _ = _inputs(4, 1, 1, 64, 64, 32, 32, "float32")
    q, k, v, qs, ks, qp, kp = tt
    with pytest.raises(ValueError, match="int32"):
        FA.flash_attention_fwd(q, k, v, qs.long(), ks, qp, kp, scale=1.0)
    with pytest.raises(ValueError, match="do not match"):
        FA.flash_attention_fwd(q, k[:, :32], v, qs, ks, qp, kp, scale=1.0)
    with pytest.raises(ValueError, match="float32"):
        FA.flash_attention_fwd_carry(q, k, v, qs, ks, qp, kp,
                                     *(torch.tensor(c).double()
                                       for c in carry), scale=1.0)


def _layout(name, t):
    """(q_seg, k_seg, q_pos, k_pos) numpy int32 [t] of a named packing:
    "diag64" 64-token segments (only diagonal 64x64 tiles live), "offedge"
    segment edges off the 64-row tile edges then padding, "padtiles" a
    64-row tile of padding only between two segments, "dead" queries and
    keys in different segments (every tile dead)."""
    rows = np.arange(t)
    if name == "diag64":
        seg, pos = rows // 64 + 1, rows % 64
    elif name == "offedge":
        lens = [100, 37, 300, 1, 63, 65, 200]
        seg, pos = np.zeros(t, np.int64), np.zeros(t, np.int64)
        cur = 0
        for i, n in enumerate(lens):
            seg[cur:cur + n], pos[cur:cur + n] = i + 1, np.arange(n)
            cur += n
    elif name == "padtiles":
        seg = np.where(rows < 128, 1, np.where(rows < 192, 0, 2))
        pos = np.where(rows < 128, rows, np.where(rows < 192, 0, rows - 192))
    elif name == "dead":
        return tuple(x.astype(np.int32) for x in (
            np.ones(t), np.full(t, 2), rows, rows))
    else:
        raise ValueError(name)
    seg, pos = seg.astype(np.int32), pos.astype(np.int32)
    return seg, seg, pos, pos


def _cuda_inputs(layout, t, dk, dv, hg=3):
    """On the card: random bf16 (q, k, v) of G = 2 groups of ``hg`` heads
    and the carry-in of `_inputs` with the metadata of `_inputs` ("random")
    or of `_layout`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tt, carry, pad = _inputs(5, 2, hg, t, t, dk, dv, "bfloat16")
    if layout != "random":
        meta = _layout(layout, t)
        tt = tt[:3] + [torch.tensor(x) for x in meta]
        pad = meta[0] == 0
    return ([x.cuda() for x in tt], [torch.tensor(c).cuda() for c in carry],
            torch.tensor(pad).cuda())


CUDA_CASES = [  # t, dk, dv, layout, window, softcap
    (4096, 128, 128, "random", 16, 30.0), (1000, 128, 64, "random", 16, 30.0),
    (200, 32, 32, "random", 16, 30.0), (4096, 128, 128, "diag64", 0, 0.0),
    (1000, 64, 64, "offedge", 0, 0.0), (512, 128, 128, "padtiles", 0, 0.0),
    (512, 128, 64, "dead", 0, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,dk,dv,layout,window,softcap", CUDA_CASES)
def test_cuda_kernels_match_plain(t, dk, dv, layout, window, softcap):
    """On a card: both CUDA kernels against their plain versions (bf16,
    2e-2), each launch counted; padding rows exactly 0 / -1e30, and where
    every tile is dead the carry comes back bit-identical."""
    tt, state, pad = _cuda_inputs(layout, t, dk, dv)
    kw = dict(scale=dk ** -0.5, causal=True, window=window, softcap=softcap)
    n0 = FA.flash_attention_fwd.launches
    out, lse = FA.flash_attention_fwd(*tt, **kw)
    out_p, lse_p = FA.flash_attention_fwd_plain(*tt, **kw)
    assert FA.flash_attention_fwd.launches == n0 + 1
    torch.testing.assert_close(out.float(), out_p.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, lse_p, atol=2e-2, rtol=2e-2)
    assert (out[:, :, pad] == 0).all() and (lse[:, :, pad] == NEG_INF).all()
    before = [x.clone() for x in state]
    want = FA.flash_attention_fwd_carry_plain(*tt, *state, **kw)
    FA.flash_attention_fwd_carry(*tt, *state, **kw)
    for got, w in zip(state, want):
        torch.testing.assert_close(got, w, atol=2e-2, rtol=2e-2)
    for got, b in zip(state, before):
        assert torch.equal(got[:, :, pad], b[:, :, pad])
        if layout == "dead":
            assert torch.equal(got, b)
