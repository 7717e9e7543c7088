"""The port's multi-rank `ServeEngine` against the reference's engine at
hdp = 4.

* Reduced llama3.2-3b in float32, 8 prompts of 100/40/9/20/5/60/70/3
  tokens, 6 new tokens each, ``max_context`` 128, ``prefill_capacity``
  32: the reference's engine on a (4, 1) mesh of 4 host devices and the
  port's on `ThreadRanks(4)` from the reference's weights, at
  ``max_slots`` 4 (the slab's slots split over the ranks) and 6 (its
  cache positions split, attention through the flash-decoding combine),
  under ``attn_impl`` "flash" (the kernels' plain versions here) and
  "ref".  Greedy tokens identical, logits within 1e-4
  (`test_torch_serve.py`'s F32_TOL), every rank's tokens and logit rows
  bit-identical, the waves' compositions the reference's.
* `decode_attention_sharded` against the reference's at g = 4 (softcap 0
  and 30), and the slab's layout rule against `decode_axes`.
* One case on 4 gloo ranks (`_torch_hdp_serve_worker.py`) gives the
  `ThreadRanks` result bit for bit; planted mismatched plans make every
  rank raise; a request with non-finite logits fails alike at hdp = 1 and
  4 and leaves no NaN for its slot's next tenant.
* The launcher's ``--mesh 2x1`` on 2 gloo ranks (reduced, bf16).
* MoE: reduced Mistral-8x7B in float32 at capacity factor 0.5, 16
  requests on 16 slots (``"batch"``, 4 a rank) on both sides: decode
  routes the whole slab as one group (the reference's ``moe_forward`` on
  the global ``[B, d]``), which here drops pairs, so only the port's
  all-gather of the ranks' top-k indices gives the reference's tokens
  and logits (within 1e-4); the ranks bit-identical.

The reference, the gloo ranks and the launcher run as three subprocesses
started together by one module fixture.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_hdp_serve_worker as W
from repro.train import serve_step as JS
from repro_torch import bridge
from repro_torch.core import ring
from repro_torch.launch import profile_serve
from repro_torch.parallel.comm import ThreadRanks
from repro_torch.parallel.sharding import Runtime
from repro_torch.train import serve_step as S
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_threads import subprocess_env

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4                  # tests/test_torch_serve.py
ATTN_TOL = 1e-5                 # decode attention alone, fp32
IMPLS = ("flash", "ref")
CASES = [(s, i) for s in W.SLOTS for i in IMPLS]
DEC = dict(b=3, s=32, g=2, hg=3, d=16, lens=[0, 5, 29])   # 8 positions a
                                                          # rank: row 0 none,
                                                          # row 1 rank 0 only
SOFTCAPS = (0.0, 30.0)

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config
from repro.core import ring as R
from repro.models.transformer import init_params
from repro.parallel.sharding import Runtime
from repro.serve import ServeConfig, ServeEngine
sys.path.insert(0, "tests")
import _torch_hdp_serve_worker as W

out, dec = sys.argv[1], json.loads(sys.argv[2])
mesh = compat.make_mesh((W.R, 1), ("data", "model"),
                        axis_types=compat.auto_axis_types(2))
compat.set_mesh(mesh)
cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                          dtype="float32")
rt = Runtime(mesh=mesh, hdp_axes=("data",), model_axis="model")
params = init_params(jax.random.PRNGKey(0), cfg, rt)
np.savez(out + "/jax_params.tmp.npz", **_flatten(params))
os.replace(out + "/jax_params.tmp.npz", out + "/jax_params.npz")

res = {}
rng = np.random.RandomState(3)
b, s, g, hg, d = (dec[k] for k in ("b", "s", "g", "hg", "d"))
q = rng.randn(b, g, hg, d).astype(np.float32)
k = rng.randn(b, s, g, d).astype(np.float32)
v = rng.randn(b, s, g, d).astype(np.float32)
lens = np.array(dec["lens"], np.int32)
res.update(dec_q=q, dec_k=k, dec_v=v, dec_lens=lens)
for cap in dec["softcaps"]:
    res[f"dec_out/{cap}"] = np.asarray(R.decode_attention_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        mesh=mesh, batch_axes=(), seq_axes=("data", "model"),
        scale=d ** -0.5, softcap=cap))

for slots in W.SLOTS:
    eng = ServeEngine(params, cfg, rt, ServeConfig(
        max_slots=slots, max_context=W.MAX_CONTEXT,
        prefill_capacity=W.CAPACITY, collect_logits=True))
    comps = []
    plan_pool = eng.service.plan_pool
    def recorded(lengths):
        plan = plan_pool(lengths)
        comps.append([tuple(int(x) for x in w.composition)
                      for w in plan.waves])
        return plan
    eng.service.plan_pool = recorded
    rids = [eng.submit(p, W.NEW_TOKENS) for p in W.prompts(cfg.vocab_size)]
    eng.drain(max_steps=200)
    reqs = [eng.pool.get(r) for r in rids]
    res[f"{slots}/tokens"] = np.array([r.generated for r in reqs])
    res[f"{slots}/logits"] = np.stack([np.stack(r.logits) for r in reqs])
    res[f"{slots}/comps"] = np.array(repr(comps))

mcfg = W.with_cf(get_config(W.MOE_ARCH).reduced())
mparams = init_params(jax.random.PRNGKey(0), mcfg, rt)
np.savez(out + "/jax_params_moe.npz", **_flatten(mparams))
eng = ServeEngine(mparams, mcfg, rt, ServeConfig(
    max_slots=W.MOE_SLOTS, max_context=W.MAX_CONTEXT,
    prefill_capacity=W.CAPACITY, collect_logits=True))
rids = [eng.submit(p, W.NEW_TOKENS)
        for p in W.prompts(mcfg.vocab_size, W.MOE_PROMPT_LENS)]
eng.drain(max_steps=200)
reqs = [eng.pool.get(r) for r in rids]
res["moe/tokens"] = np.array([r.generated for r in reqs])
res["moe/logits"] = np.stack([np.stack(r.logits) for r in reqs])
np.savez(out + "/jax_serve.npz", **res)
"""

LAUNCH_ARGS = ["--mesh", "2x1", "--device", "cpu", "--reduced",
               "--capacity", "1024"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Start the reference (4 host devices), the gloo ranks and the
    launcher together; -> (reference results, per-rank gloo results, the
    launcher's stdout)."""
    out = tmp_path_factory.mktemp("hdp_serve")
    env = subprocess_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    dec = json.dumps({**DEC, "softcaps": list(SOFTCAPS)})
    procs, logs = {}, {}
    for part, cmd in (
            ("jax", [sys.executable, "-c", JAX_SCRIPT, str(out), dec]),
            ("torch", [sys.executable,
                       str(ROOT / "tests" / "_torch_hdp_serve_worker.py"),
                       str(out)]),
            ("launch", [sys.executable, "-m",
                        "repro_torch.launch.profile_serve", *LAUNCH_ARGS])):
        logs[part] = out / f"{part}.log"
        with open(logs[part], "w") as log, \
                open(out / f"{part}.err", "w") as err:
            procs[part] = subprocess.Popen(
                cmd, cwd=out if part == "launch" else ROOT, env=env,
                stdout=log, stderr=err)
    try:
        for p in procs.values():
            p.wait(timeout=600)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for part, p in procs.items():
        assert p.returncode == 0, (part, logs[part].read_text()[-2000:],
                                   (out / f"{part}.err").read_text()[-4000:])
    ref = dict(np.load(out / "jax_serve.npz"))
    ref["flat"] = dict(np.load(out / "jax_params.npz"))
    ref["flat_moe"] = dict(np.load(out / "jax_params_moe.npz"))
    ranks = [dict(np.load(out / f"torch_rank{r}.npz")) for r in range(W.R)]
    return ref, ranks, logs["launch"].read_text()


@pytest.fixture(scope="module")
def port(results):
    """(slots, impl) -> every rank's `serve_pool` result on ThreadRanks(4),
    from the reference's weights, with the gloo ranks' thread count."""
    ref, _, _ = results
    cfg = W.config()
    params = bridge.params_from_flat(ref["flat"], cfg, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(W.TORCH_THREADS)
    try:
        return {(slots, impl): ThreadRanks(W.R).run(
            lambda c: W.serve_pool(c, params, cfg, slots, impl))
            for slots, impl in CASES}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def moe_port(results):
    """Every rank's MoE pool on ThreadRanks(4), from the reference's
    weights, and the pairs each decode step dropped over the slab
    (counted by a wrapper of `moe_forward_sharded` that all-gathers the
    ranks' top-k indices once more)."""
    from repro_torch.models import moe as M
    ref, _, _ = results
    cfg = W.config(W.MOE_ARCH)
    params = bridge.params_from_flat(ref["flat_moe"], cfg, "cpu")
    sharded = M.moe_forward_sharded
    drops = []

    def counting(p, c, x, comm):
        _, idx = M.moe_route(p, c, x)
        every = comm.all_gather(idx).reshape(-1, c.moe.top_k)
        pos = M.moe_positions(every, c.moe.num_experts)
        if comm.rank == 0:
            drops.append(int((pos >= M.moe_capacity(
                c.moe, every.shape[0])).sum()))
        return sharded(p, c, x, comm)

    threads = torch.get_num_threads()
    torch.set_num_threads(W.TORCH_THREADS)
    M.moe_forward_sharded = counting
    try:
        runs = ThreadRanks(W.R).run(lambda c: W.serve_pool(
            c, params, cfg, W.MOE_SLOTS, "flash",
            pool=W.prompts(cfg.vocab_size, W.MOE_PROMPT_LENS)))
    finally:
        M.moe_forward_sharded = sharded
        torch.set_num_threads(threads)
    return runs, drops


def test_moe_decode_routes_the_whole_slab_like_jax(results, moe_port):
    ref, _, _ = results
    runs, drops = moe_port
    assert runs[0]["engine"].shard.layout == "batch"
    assert runs[0]["engine"].shard.slots == W.MOE_SLOTS // W.R
    np.testing.assert_allclose(np.stack(runs[0]["logits"]),
                               ref["moe/logits"], atol=F32_TOL, rtol=0)
    assert np.array_equal(np.array(runs[0]["tokens"]), ref["moe/tokens"])
    assert len(drops) > 0 and sum(drops) > 0, drops   # decode dropped
    for r, run in enumerate(runs[1:], 1):
        assert run["tokens"] == runs[0]["tokens"], r
        for a, b in zip(run["logits"], runs[0]["logits"]):
            assert np.array_equal(a, b), r


@pytest.mark.parametrize("slots,impl", CASES)
def test_tokens_match_jax(results, port, slots, impl):
    ref, _, _ = results
    got = port[(slots, impl)][0]
    assert np.array_equal(np.array(got["tokens"]), ref[f"{slots}/tokens"])


@pytest.mark.parametrize("slots,impl", CASES)
def test_logits_match_jax(results, port, slots, impl):
    ref, _, _ = results
    got = np.stack(port[(slots, impl)][0]["logits"])
    np.testing.assert_allclose(got, ref[f"{slots}/logits"], atol=F32_TOL,
                               rtol=0)


@pytest.mark.parametrize("slots,impl", CASES)
def test_ranks_agree_bit_for_bit(port, slots, impl):
    runs = port[(slots, impl)]
    for r, run in enumerate(runs[1:], 1):
        assert run["tokens"] == runs[0]["tokens"], r
        for a, b in zip(run["logits"], runs[0]["logits"]):
            assert np.array_equal(a, b), r


@pytest.mark.parametrize("slots", W.SLOTS)
def test_compositions_and_layout_match_jax(results, port, slots):
    """The same waves (compositions per admission round), a ring wave
    among them, and the slab layout the reference's rule gives."""
    ref, _, _ = results
    runs = port[(slots, "flash")]
    assert repr(runs[0]["comps"]) == str(ref[f"{slots}/comps"])
    assert any(max(c) > 1 for rnd in runs[0]["comps"] for c in rnd)
    want = "batch" if slots % W.R == 0 else "seq"
    for r, run in enumerate(runs):
        sh = run["engine"].shard
        assert sh.layout == want
        k = run["engine"].cache["blocks"][0]["k"]
        if want == "batch":
            assert (sh.slot0, sh.base) == (r * slots // W.R, 0)
            assert k.shape[1:3] == (slots // W.R, W.MAX_CONTEXT)
        else:
            assert (sh.slot0, sh.base) == (0, r * W.MAX_CONTEXT // W.R)
            assert k.shape[1:3] == (slots, W.MAX_CONTEXT // W.R)


def test_gloo_ranks_match_thread_ranks(results, port):
    _, ranks, _ = results
    want = port[W.GLOO_CASE][0]
    for r, got in enumerate(ranks):
        assert np.array_equal(got["tokens"], np.array(want["tokens"])), r
        assert np.array_equal(got["logits"], np.stack(want["logits"])), r
        assert str(got["comps"]) == repr(want["comps"]), r


@pytest.mark.parametrize("hdp", [1, 2, 4, 8])
def test_decode_layout_matches_jax(hdp):
    rt = types.SimpleNamespace(hdp_size=hdp, hdp_axes=("data",),
                               model_axis="model")
    for batch in range(1, 20):
        batch_axes, _ = JS.decode_axes(None, rt, batch)
        assert S.decode_layout(batch, hdp) == \
            ("batch" if batch_axes else "seq"), (batch, hdp)


@pytest.mark.parametrize("softcap", SOFTCAPS)
def test_decode_attention_sharded_matches_jax(results, softcap):
    """Each rank its 8 cache positions; every rank's output the reference's
    and bit-identical to the others'."""
    ref, _, _ = results
    q, k, v, lens = (torch.tensor(ref[f"dec_{n}"])
                     for n in ("q", "k", "v", "lens"))
    n = DEC["s"] // W.R

    def rank_fn(comm):
        sl = slice(comm.rank * n, (comm.rank + 1) * n)
        return ring.decode_attention_sharded(
            q, k[:, sl], v[:, sl], lens, comm=comm, base=comm.rank * n,
            scale=DEC["d"] ** -0.5, softcap=softcap)
    outs = ThreadRanks(W.R).run(rank_fn)
    np.testing.assert_allclose(outs[0].numpy(), ref[f"dec_out/{softcap}"],
                               atol=ATTN_TOL, rtol=0)
    assert not outs[0][0].any()                  # no valid entry: zeros
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_seq_layout_needs_positions_that_tile_the_ranks():
    cfg = W.config()

    def build(comm):
        rt = Runtime(device="cpu", comm=comm)
        assert S.slab_shard(rt, 3, 64).layout == "seq"
        with pytest.raises(ValueError, match="seq_len % hdp == 0"):
            S.init_decode_cache(cfg, rt, 3, 66)
        return S.slab_shard(rt, 4, 66)          # whole slots: any length
    shards = ThreadRanks(W.R).run(build)
    assert [(s.slot0, s.slots, s.positions) for s in shards] == \
        [(r, 1, 66) for r in range(W.R)]


def _seeded(cfg):
    from repro_torch.models.transformer import init_params
    return init_params(cfg, seed=1, device="cpu")


def test_mismatched_plans_raise_on_every_rank():
    """Rank 2 holds another pool: every rank raises at the plan check of
    the first admission round, none waits in a wave's ring."""
    cfg = W.config()
    params = _seeded(cfg)
    pool = W.prompts(cfg.vocab_size)
    errors = []

    def rank_fn(comm):
        mine = pool if comm.rank != 2 else [pool[0][:50]] + pool[1:]
        try:
            W.serve_pool(comm, params, cfg, 4, "ref", pool=mine)
        except RuntimeError as e:
            errors.append((comm.rank, str(e)))
    ThreadRanks(W.R, timeout=120).run(rank_fn)
    assert sorted(r for r, _ in errors) == list(range(W.R))
    assert all("planned different prefills" in e for _, e in errors)


@pytest.mark.parametrize("slots", W.SLOTS)
def test_nonfinite_request_fails_alike_on_every_rank(slots):
    """A NaN planted after the first step at the last cache position of
    slot 1 (a position no request reaches, on the rank whose shard holds
    it) fails that slot's request at its next decode, on every rank as at
    hdp = 1; the slot is scrubbed, so its next tenant, whose masked
    attention sum would meet the NaN, gets the hdp = 1 engine's tokens
    like every other request."""
    cfg = W.config()
    params = _seeded(cfg)
    slot, pos = 1, W.MAX_CONTEXT - 1

    def plant(eng):
        sh = eng.shard
        if sh.owns(slot, pos):
            eng.cache["blocks"][0]["v"][0, slot - sh.slot0,
                                        pos - sh.base] = float("nan")

    one = W.serve_pool(None, params, cfg, slots, "flash", plant=plant)
    assert [e is not None for e in one["errors"]] == \
        [i == 1 for i in range(len(W.PROMPT_LENS))]
    runs = ThreadRanks(W.R).run(lambda c: W.serve_pool(
        c, params, cfg, slots, "flash", plant=plant))
    for run in runs:
        assert run["errors"] == one["errors"]
        assert run["tokens"] == one["tokens"]
        for layer in run["engine"].cache["blocks"]:
            for buf in layer.values():
                assert torch.isfinite(buf).all()


def test_launcher_mesh_on_gloo_ranks(results):
    """``profile_serve --mesh 2x1 --device cpu --reduced``: one JSON line
    from rank 0, the ranks bit-identical, the drain held to rank 0's hdp
    = 1 engine by `hold_to_single_rank`, every rank's slab shard (8 slots
    over 2 ranks: 4 slots of 4096 positions, 2 kv heads of 16, 2 layers,
    k and v, bf16)."""
    _, _, stdout = results
    line = json.loads(stdout.strip().splitlines()[-1])
    assert line["mesh"] == "2x1" and line["layout"] == "batch"
    assert line["ranks_identical"]
    assert not line["vs_hdp1"]["faults"]
    assert line["vs_hdp1"]["rms"] <= profile_serve.SERVE_TOL
    assert line["kv_slab_bytes_by_rank"] == [4 * 4096 * 2 * 16 * 2 * 2 * 2] * 2
    assert any(max(eval(k.split("x")[0])) > 1
               for k in line["warm"]["prefill_ms_by_composition"])
    assert len(line["warm"]["ttft_s"]) == len(profile_serve.PROMPT_LENS)


def test_hold_to_single_rank_allows_only_near_ties():
    ref = [([3, 1, 2], np.array([[0, 0, 0, 5.0], [0, 1.0, 0.99, 0],
                                 [0, 0, 9.0, 0]]))]
    same = profile_serve.hold_to_single_rank(ref, ref)
    assert same["same_tokens"] and same["rms"] == 0.0
    near = profile_serve.hold_to_single_rank(
        [([3, 2, 0], ref[0][1] + 0.01)], ref)
    assert not near["same_tokens"] and not near["faults"]
    assert [n["position"] for n in near["near_ties"]] == [1]
    assert near["rms"] == pytest.approx(0.01)
    far = profile_serve.hold_to_single_rank([([0, 1, 2], ref[0][1])], ref)
    assert [f["position"] for f in far["faults"]] == [0]
