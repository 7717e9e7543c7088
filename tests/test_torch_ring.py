"""The port's HDP ring (`core/ring.py`, `kernels/ring_flash.py`,
`parallel/comm.py`) against the reference's ring.

* The composition tables and permutations equal the JAX functions.
* Every case of `tests/test_ring_flash.py`'s RING_SCRIPT and
  GATHER_SCRIPT, plus the offset composition (1, 2, 1), on 4 gloo ranks
  (one process each, `_torch_ring_worker.py`) with ``attn_impl`` "ref"
  (the oracle ring) and "flash" (the ring-flash engine; its kernels' plain
  versions on the CPU), against the reference's ring on a (4, 1) mesh of
  4 host devices in one subprocess: out within 2e-5, gradients within
  3e-4, loss within 1e-3 relative (`tests/test_ring_flash.py:40-43`).
* Reduced llama3.2-3b, weights carried across by `bridge.py`: the loss
  shares and rank-summed gradients of the port's `grad_step` on 4 gloo
  ranks under (2, 2) and (4,) against `tests/test_distributed.py`'s
  GRAD_SCRIPT computation in float32, within its 3e-2.
* `ThreadRanks` (g ranks as threads of one process) gives the gloo ranks'
  results bit for bit.
* On a card (``cuda`` marker): the ring through `ThreadRanks` with direct
  calls of the ring-flash forward and backward, against the same ring on
  the CPU (the plain versions), with exact kernel launch counts.

The JAX side and the gloo ranks run as two subprocesses started together
by one module fixture.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ring_worker as W
from repro.core import ring as jring
from repro.kernels import ring_flash as JRF
from repro_torch.core import ring
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ring_flash as RF
from repro_torch.parallel.comm import ThreadRanks
from repro_torch.parallel.sharding import Runtime
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
OUT_TOL, GRAD_TOL, LOSS_TOL = 2e-5, 3e-4, 1e-3    # test_ring_flash.py:40-43
MODEL_TOL = 3e-2                                  # test_distributed.py
FLASH_TOL = 2e-2                                  # the kernels' bf16 gate

COMPOSITIONS = [(1,), (4,), (2, 2), (1, 2, 1), (2, 1, 1), (1, 1, 1, 1),
                (8,), (4, 2, 1, 1)]

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config
from repro.core.loss import token_ce_loss
from repro.core.ring import ring_attention
from repro.models.transformer import init_params, forward_hidden
from repro.parallel.sharding import (Runtime, params_pspecs,
                                     shardings_from_pspecs)
sys.path.insert(0, "tests")
import _torch_ring_worker as W

inputs, out, part = sys.argv[1:]
inp = dict(np.load(inputs))
mesh = compat.make_mesh((4, 1), ("data", "model"),
                        axis_types=compat.auto_axis_types(2))
compat.set_mesh(mesh)
res = {}

if part == "model":
    # the weights first: the gloo ranks wait for them
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              dtype="float32")
    rt = Runtime(mesh=mesh, hdp_axes=("data",), model_axis="model",
                 composition=(2, 2), remat="none", kv_chunk=16)
    params = init_params(jax.random.PRNGKey(0), cfg, rt)
    np.savez(out + "/jax_params.tmp.npz", **_flatten(params))
    os.replace(out + "/jax_params.tmp.npz", out + "/jax_params.npz")
    # GRAD_SCRIPT of tests/test_distributed.py, float32, on the (4, 1) mesh
    batch = {"tokens": jnp.array(inp["tokens"]),
             "labels": jnp.array(inp["labels"]),
             "seg": jnp.array(inp["seg_two_seq"]),
             "pos": jnp.array(inp["pos_two_seq"]),
             "denom": jnp.float32(W.T)}
    pspecs = params_pspecs(params, cfg, rt)
    params = jax.device_put(params, shardings_from_pspecs(pspecs, mesh))
    bspecs = {k: (P() if k == "denom" else P(("data",))) for k in batch}
    batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
             for k, v in batch.items()}
    in_sh = compat.resolve_shardings((pspecs, bspecs), mesh)
    for name, comp in W.MODEL_COMPS.items():
        rt_c = rt.with_composition(comp)
        def loss(p, b):
            h = forward_hidden(p, cfg, rt_c, b)
            l, _ = token_ce_loss(p, cfg, rt_c, h, b["labels"], b["seg"],
                                 b["denom"])
            return l
        l, g = jax.jit(jax.value_and_grad(loss), in_shardings=in_sh)(
            params, batch)
        res[f"{name}/loss"] = np.asarray(l)
        for key, x in _flatten(g).items():
            res[f"{name}/grad/{key}"] = x

if part == "ring":
    for name in W.RING_CASES:
        q, k, v, seg, pos, kw = W.case_args(inp, name)
        kgi = kw.pop("kgi")
        seg, pos = jnp.array(seg), jnp.array(pos)
        xs = [jnp.array(x) for x in (q, k, v) if x is not None]
        def f(*xs):
            o = ring_attention(
                xs[0], xs[1], xs[2] if len(xs) > 2 else None, seg, seg, pos,
                pos, mesh=mesh, hdp_axes=("data",), model_axis="model",
                kv_group_of_head=(None if kgi is None
                                  else jnp.array(kgi, jnp.int32)),
                attn_impl="ref", **kw)
            return (o.astype(jnp.float32) ** 2).sum(), o
        (loss, o), grads = jax.jit(jax.value_and_grad(
            f, argnums=tuple(range(len(xs))), has_aux=True))(*xs)
        for i, x in enumerate([o, loss, *grads]):
            res[f"{name}/{i}"] = np.asarray(x)

np.savez(out + f"/jax_{part}.npz", **res)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Start the reference (4 host devices; its ring cases and its model in
    two processes) and the port (4 gloo ranks) together; -> (inputs,
    reference results, per-rank port results)."""
    out = tmp_path_factory.mktemp("ring")
    inp = W.make_inputs()
    np.savez(out / "inputs.npz", **inp)
    env = subprocess_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_cmd = [sys.executable, "-c", JAX_SCRIPT, str(out / "inputs.npz"),
               str(out)]
    procs, logs = {}, {}
    for part, cmd in (("ring", jax_cmd + ["ring"]),
                      ("model", jax_cmd + ["model"]),
                      ("torch", [sys.executable,
                                 str(ROOT / "tests" / "_torch_ring_worker.py"),
                                 str(out / "inputs.npz"), str(out)])):
        logs[part] = out / f"{part}.log"
        with open(logs[part], "w") as log:
            procs[part] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                           stdout=log, stderr=log)
    try:
        for p in procs.values():
            p.wait(timeout=600)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for part, p in procs.items():
        assert p.returncode == 0, (part, logs[part].read_text()[-4000:])
    ref = {**np.load(out / "jax_ring.npz"), **np.load(out / "jax_model.npz")}
    ranks = [dict(np.load(out / f"torch_rank{r}.npz")) for r in range(W.R)]
    return inp, ref, ranks


# ---------------------------------------------------------------------------
# (a) composition helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comp", COMPOSITIONS, ids=str)
def test_composition_helpers_match_jax(comp):
    sizes, starts = ring.composition_tables(comp)
    j_sizes, j_starts = jring.composition_tables(comp)
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(j_sizes))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(j_starts))
    assert ring.ring_perm(comp) == jring.ring_perm(comp)
    g = max(comp)
    assert ring.uniform_composition(8, g) == jring.uniform_composition(8, g)
    cfg = RF.RingConfig(composition=comp, kv_split=(8, 8, 8), gather=False,
                        scale=1.0)
    jcfg = JRF.RingConfig(hdp_axes=("data",), composition=comp,
                          kv_split=(8, 8, 8), gather=False, scale=1.0)
    assert cfg.steps == jcfg.steps and cfg.perm == jcfg.perm
    for s in range(cfg.steps + 2):
        assert RF._reverse_perm(cfg, s) == JRF._reverse_perm(jcfg, s), s


# ---------------------------------------------------------------------------
# (b) ring cases on 4 gloo ranks against the reference's ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", W.IMPLS)
@pytest.mark.parametrize("name", list(W.RING_CASES))
def test_gloo_ring_matches_jax(results, name, impl):
    _, ref, ranks = results
    got = [np.concatenate([rk[f"{name}/{impl}/{i}"] for rk in ranks])
           for i in (0, 2, 3, 4) if f"{name}/{impl}/{i}" in ranks[0]]
    np.testing.assert_allclose(got[0], ref[f"{name}/0"], atol=OUT_TOL,
                               rtol=OUT_TOL, err_msg="out")
    loss = sum(float(rk[f"{name}/{impl}/1"]) for rk in ranks)
    want = float(ref[f"{name}/1"])
    assert abs(loss - want) <= LOSS_TOL * abs(want), (loss, want)
    for i, g in enumerate(got[1:]):
        np.testing.assert_allclose(g, ref[f"{name}/{i + 2}"], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"grad {i}")


# ---------------------------------------------------------------------------
# (c) the model under a mixed composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", W.IMPLS)
@pytest.mark.parametrize("name", list(W.MODEL_COMPS))
def test_gloo_model_grads_match_jax(results, name, impl):
    """Each rank's `token_ce_loss` over the global denom is its share: the
    shares sum to the reference's loss, and the rank-summed gradients (the
    all-reduce a multi-rank trainer does) equal the reference's."""
    _, ref, ranks = results
    shares = [float(rk[f"{name}/{impl}/loss"]) for rk in ranks]
    want = float(ref[f"{name}/loss"])
    assert all(s > 0 for s in shares)
    np.testing.assert_allclose(sum(shares), want, rtol=MODEL_TOL)
    keys = [k for k in ref if k.startswith(f"{name}/grad/")]
    assert len(keys) > 5
    for key in keys:
        leaf = key[len(f"{name}/grad/"):]
        got = sum(rk[f"{name}/{impl}/grad/{leaf}"] for rk in ranks)
        np.testing.assert_allclose(got, ref[key], atol=MODEL_TOL,
                                   rtol=MODEL_TOL, err_msg=leaf)


# ---------------------------------------------------------------------------
# (d) the in-process stand-in and the process group agree bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", W.IMPLS)
def test_thread_ranks_match_gloo_bitwise(results, impl):
    inp, _, ranks = results
    name = "offset_win_cap"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as the gloo ranks run
    try:
        got = ThreadRanks(W.R).run(
            lambda comm: W.run_case(comm, inp, name, impl))
    finally:
        torch.set_num_threads(threads)
    for r, rk in enumerate(ranks):
        for i, x in enumerate(got[r]):
            np.testing.assert_array_equal(x, rk[f"{name}/{impl}/{i}"],
                                          err_msg=f"rank {r} output {i}")


# ---------------------------------------------------------------------------
# single process: the comm's semantics and what must raise
# ---------------------------------------------------------------------------

def test_thread_ranks_ppermute_semantics():
    """Listed pairs move, untargeted ranks receive zeros, receivers own
    their buffers; all_gather stacks in rank order; a failing rank fails
    the run instead of hanging the others."""
    def fn(comm):
        x = torch.full((3,), float(comm.rank + 1))
        (y,) = comm.ppermute([x], [(1, 2), (2, 1)])
        (z,) = comm.ppermute([x], [])
        gathered = comm.all_gather(torch.tensor([comm.rank]))
        x.add_(10)                       # must not show in any receiver
        return y, z, gathered

    got = ThreadRanks(4).run(fn)
    assert [float(y[0]) for y, _, _ in got] == [0.0, 3.0, 2.0, 0.0]
    assert all((z == 0).all() for _, z, _ in got)
    assert all(g.flatten().tolist() == [0, 1, 2, 3] for _, _, g in got)

    def bad(comm):
        if comm.rank == 2:
            raise ValueError("rank 2 fails")
        comm.ppermute([torch.zeros(1)], [(0, 1)])

    with pytest.raises(RuntimeError, match="rank 2") as e:
        ThreadRanks(4, timeout=30).run(bad)
    assert isinstance(e.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="rank 0") as e:
        ThreadRanks(2).run(lambda c: c.ppermute([torch.zeros(1)],
                                                [(0, 1), (1, 1), (0, 0)]))
    assert "twice" in str(e.value.__cause__)


def test_compositions_must_cover_the_ranks():
    q, k, v, seg, pos, kw = W.case_args(W.make_inputs(), "g2",
                                        slice(0, W.C))
    kw.pop("kgi")
    args = [torch.tensor(x) for x in (q, k, v, seg, seg, pos, pos)]
    for impl in W.IMPLS:
        with pytest.raises(ValueError, match="does not sum"):
            ring.ring_attention(*args, attn_impl=impl, **kw)
        with pytest.raises(RuntimeError) as e:
            ThreadRanks(2).run(lambda c: ring.ring_attention(
                *args, attn_impl=impl, comm=c, **kw))
        assert "does not sum" in str(e.value.__cause__)
    with pytest.raises(ValueError, match="does not sum"):
        Runtime(device="cpu").with_composition((2,))
    rt = Runtime(device="cpu")
    assert rt.composition == (1,) and rt.hdp_size == 1


def test_planner_waves_liveness():
    """The ring's liveness table (one all-gather of the rank metas) against
    the count `launch/ring_check.py` and `chip_smoke.py` gate the kernel
    launches with, on the planner's hdp = 4 waves; and a visiting block
    no rank can see is dead on every rank."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import ring_check as RC
    waves, _, comps = RC.planner_waves(get_config("llama3.2-3b"), 4)
    assert set(waves) == set(RC.RING_COMPS), comps
    c = RC.RING_CAP
    for comp, lw in waves.items():
        seg, pos = (torch.tensor(lw.batch[k]) for k in ("seg", "pos"))

        def table(comm):
            sl = slice(comm.rank * c, (comm.rank + 1) * c)
            return ring.ring_liveness(comm, comp, seg[sl], pos[sl], seg[sl],
                                      pos[sl], causal=True, window=0)
        tables = ThreadRanks(4).run(table)
        assert all(torch.equal(t, tables[0]) for t in tables)
        want = RC.expected_launches(comp, lw.batch["seg"], lw.batch["pos"])
        assert tables[0].sum(dim=1).tolist() == want, comp
    # each rank its own sequence: under (2, 2) no visiting block is live
    split = np.repeat(np.arange(1, 5), c).astype(np.int32)
    spos = np.tile(np.arange(c), 4).astype(np.int32)
    assert RC.expected_launches((2, 2), split, spos) == [1, 1, 1, 1]


def test_single_rank_entry_points_refuse_several_ranks():
    """Given a comm of 2 ranks, the trainer builds (rank 0's parameters
    broadcast, each rank its ZeRO-1 shard of the optimiser state) and so
    does the serving engine, each rank with its shard of the decode slab:
    whole slots when they tile the ranks, else half of every slot's cache
    positions."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.distribution import LengthDistribution
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("llama3.2-3b").reduced()
    ds = SyntheticDataset(LengthDistribution("tiny", 4.5, 0.8, 0.1, 1.5, 256),
                          cfg.vocab_size, tokens_per_step=512, context=256)
    sched = GlobalScheduler(ds, cfg, capacity=256, hdp=2)
    params = init_params(cfg, device="cpu")

    def build(comm):
        rt = Runtime(device="cpu", comm=comm)
        assert rt.hdp_size == 2 and rt.composition == (1, 1)
        tr = Trainer(cfg, rt, AdamWConfig(), sched,
                     TrainerConfig(capacity=256),
                     params=init_params(cfg, seed=comm.rank, device="cpu"))
        for slots, shard in ((8, (4, 256)), (3, (3, 128))):
            eng = ServeEngine(params, cfg, rt, ServeConfig(max_slots=slots))
            k = eng.cache["blocks"][0]["k"]
            assert tuple(k.shape) == (cfg.num_layers, *shard,
                                      cfg.num_kv_heads,
                                      cfg.resolved_head_dim)
        return tr.params["embed"], tr.opt_state["master"]["embed"]

    try:
        got = ThreadRanks(2).run(build)
    finally:
        sched.stop()
    for r, (embed, master) in enumerate(got):
        torch.testing.assert_close(embed, params["embed"], rtol=0, atol=0)
        half = cfg.vocab_size // 2
        torch.testing.assert_close(master, params["embed"][
            r * half:(r + 1) * half].float(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# on the card: the ring through ThreadRanks, direct calls
# ---------------------------------------------------------------------------

CUDA_RING_CASES = [  # name, composition, layout, window, softcap, gather
    ("g2", (2, 2), "zigzag", 0, 0.0, False),
    ("offset", (1, 2, 1), "packed", 0, 0.0, False),
    ("win_cap", (2, 2), "zigzag", 16, 30.0, False),
    ("gather", (1, 2, 1), "packed", 0, 0.0, True),
    ("dead", (2, 2), "split", 0, 0.0, False),
]
CUDA_C, CUDA_G, CUDA_HG, CUDA_D = 256, 2, 3, 64


def _cuda_ring_inputs(layout, gather):
    """bf16 q, kv, do and int32 metadata for 4 ranks of CUDA_C rows:
    "zigzag" one sequence per 2-rank group in chunk pairs; "packed" two
    sequences across the ranks and padding; "split" each rank its own
    sequence (every visiting block dead everywhere)."""
    from repro_torch.data.packing import zigzag_chunks
    rng = np.random.RandomState(7)
    t, c = 4 * CUDA_C, CUDA_C
    seg = np.zeros(t, np.int32)
    pos = np.zeros(t, np.int32)
    if layout == "zigzag":
        half = c // 2
        for grp in range(2):
            for j, lo, hi in zigzag_chunks(2 * c, 2):
                r = 2 * grp + j
                seg[r * c:(r + 1) * c] = grp + 1
                pos[r * c:r * c + half] = np.arange(*lo)
                pos[r * c + half:(r + 1) * c] = np.arange(*hi)
    elif layout == "packed":
        seg[:700], pos[:700] = 1, np.arange(700)
        seg[700:1000], pos[700:1000] = 2, np.arange(300)
    else:
        for r in range(4):
            seg[r * c:(r + 1) * c] = r + 1
            pos[r * c:(r + 1) * c] = np.arange(c)
    hpl = CUDA_G * CUDA_HG
    q = rng.randn(t, hpl, CUDA_D)
    kv = rng.randn(t, CUDA_G, 2 * CUDA_D)
    do = rng.randn(t, hpl, CUDA_D)
    cfg = RF.RingConfig(composition=(4,), kv_split=(CUDA_D, CUDA_D, CUDA_D),
                        gather=gather, scale=CUDA_D ** -0.5)
    kgi = np.repeat(np.arange(CUDA_G), CUDA_HG) if gather else None
    return cfg, (q, kv, seg, pos, do, kgi)


def _ring_direct(comm, cfg, arrays, device, dtype):
    """One rank's direct forward and backward ring (no autograd)."""
    q, kv, seg, pos, do, kgi = arrays
    sl = slice(comm.rank * CUDA_C, (comm.rank + 1) * CUDA_C)
    f = lambda x: torch.tensor(x[sl]).to(torch.bfloat16).to(  # noqa: E731
        device=device, dtype=dtype)
    m = lambda x: torch.tensor(x[sl], device=device)           # noqa: E731
    kgi_t = None if kgi is None else torch.tensor(kgi, device=device)
    with torch.no_grad():
        out, res = RF.ring_flash_fwd(cfg, f(q), f(kv), m(seg), m(seg),
                                     m(pos), m(pos), kgi_t, comm)
        dq, dkv = RF.ring_flash_bwd(cfg, res, f(do), comm)
    return out.float().cpu(), dq.float().cpu(), dkv.float().cpu(), \
        res[-1][comm.rank].sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name,comp,layout,window,softcap,gather",
                         CUDA_RING_CASES, ids=[c[0] for c in CUDA_RING_CASES])
def test_cuda_ring_matches_the_plain_ring(name, comp, layout, window,
                                          softcap, gather):
    """The ring on the card against the same ring on the CPU (the plain
    versions), out, dq and dk/dv within the flash gates; carry, dq and
    dkv launches equal the live steps of all ranks exactly."""
    import dataclasses
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, arrays = _cuda_ring_inputs(layout, gather)
    cfg = dataclasses.replace(cfg, composition=comp, window=window,
                              softcap=softcap)
    want = ThreadRanks(4).run(lambda c: _ring_direct(
        c, cfg, arrays, "cpu", torch.float32))
    before = [w.launches for w in (FA.flash_attention_fwd_carry,
                                   FA.flash_attention_bwd_dq,
                                   FA.flash_attention_bwd_dkv)]
    got = ThreadRanks(4).run(lambda c: _ring_direct(
        c, cfg, arrays, "cuda", torch.bfloat16))
    torch.cuda.synchronize()
    n_live = sum(g[3] for g in got)
    assert n_live == sum(w[3] for w in want)
    if name == "dead":
        assert n_live == 4              # the local blocks only
    after = [w.launches for w in (FA.flash_attention_fwd_carry,
                                  FA.flash_attention_bwd_dq,
                                  FA.flash_attention_bwd_dkv)]
    assert [a - b for a, b in zip(after, before)] == [n_live] * 3
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            torch.testing.assert_close(a, b, atol=FLASH_TOL, rtol=FLASH_TOL)
            rl2 = float((a - b).norm() / b.norm().clamp_min(1e-30))
            assert rl2 <= FLASH_TOL
