"""The port's side of the hdp = 2 cases of `tests/test_torch_mla.py`:
reduced deepseek-v2-lite-16b (Multi-head Latent Attention, Dk 40, Dv 32)
in float32 on 2 gloo ranks (one process per rank), written to npz for the
test.

    python tests/_torch_mla_worker.py OUT_DIR

Imports numpy only at the top (the reference's script reads the cases'
constants from here); the spawned ranks import torch and the port, never
JAX.  The ranks wait for the reference's parameters
(``OUT_DIR/jax_params.npz``, written before the reference runs) and each
writes ``OUT_DIR/torch_rank{r}.npz``:

* the ring with ``v_in_k`` at g = 2: `ring_inputs` through
  `core/ring.py::ring_attention` (one latent KV head, v its first
  `V_DIM` columns), the loss sum(out²) and its gradients in q and the
  latent, under both ``attn_impl``;
* serving: `PROMPT_LENS` through `ServeEngine` at `SLOTS` slots, which
  do not tile the 2 ranks, so every rank holds half of every slot's
  latent cache positions (``"seq"``); the 40-token prompt exceeds the
  prefill capacity of 32 a rank, so it prefills through a (2,) ring;
* training: one (2,) wave of `TRAIN_LENS` (the 50-token sequence across
  the two ranks' rows) through `grad_step`: each rank's loss share over
  the global denom and its gradients, under both ``attn_impl``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

R = 2                                         # HDP ranks
ARCH = "deepseek-v2-lite-16b"
PROMPT_LENS = [40, 20, 9]
NEW_TOKENS = 6
SLOTS, MAX_CONTEXT, CAPACITY = 3, 64, 32
C = 32                                        # rows a rank
TRAIN_LENS = [50, 10]                         # + 4 padding rows
IMPLS = ("flash", "ref")
RING_HEADS, LAT_DIM, V_DIM = 4, 40, 32        # the reduced MLA's widths
RING_SCALE = 24 ** -0.5                       # 1/sqrt(nope 16 + rope 8)
NORM_NOISE = 0.1          # norm scales drawn off their zero init, so the
                          # (1 + scale) factors are tested


def config(cfg):
    """``cfg`` (either package's reduced config) in float32."""
    return dataclasses.replace(cfg, dtype="float32")


def prompts(vocab: int) -> list:
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n) for n in PROMPT_LENS]


def packed(lens, t: int, vocab: int, seed: int) -> dict:
    """One packed buffer of [t] tokens, labels, seg, pos (int32) holding
    sequences of ``lens`` tokens, padding after them."""
    rng = np.random.RandomState(seed)
    out = {k: np.zeros(t, np.int32) for k in ("tokens", "labels", "seg",
                                               "pos")}
    cur = 0
    for i, n in enumerate(lens):
        out["tokens"][cur:cur + n] = rng.randint(0, vocab, n)
        out["labels"][cur:cur + n] = rng.randint(0, vocab, n)
        out["seg"][cur:cur + n] = i + 1
        out["pos"][cur:cur + n] = np.arange(n)
        cur += n
    return out


def train_wave(vocab: int) -> dict:
    """The (2,) wave: [R·C] tokens, labels, seg, pos (int32)."""
    return packed(TRAIN_LENS, R * C, vocab, 1)


def ring_inputs(t: int = R * C):
    """q [t, H, 40] and the latent [t, 1, 40] (float32) and the metadata
    of sequences of 40 and 18 tokens, 6 padding rows."""
    rng = np.random.RandomState(5)
    q = rng.randn(t, RING_HEADS, LAT_DIM).astype(np.float32)
    kl = rng.randn(t, 1, LAT_DIM).astype(np.float32)
    meta = packed([40, 18], t, 2, 0)
    return q, kl, meta["seg"], meta["pos"]


def perturb_norms(flat: dict) -> dict:
    """Add NORM_NOISE x N(0, 1) to every norm scale of a flat parameter
    dict (keys in sorted order, one numpy stream): the MLA latent norm's
    too."""
    rng = np.random.RandomState(7)
    out = dict(flat)
    for key in sorted(flat):
        if key.rsplit("/", 1)[-1] in ("scale", "q_norm", "k_norm"):
            out[key] = (flat[key] + NORM_NOISE * rng.randn(
                *flat[key].shape)).astype(flat[key].dtype)
    return out


def _wait_for(path: str, timeout: float = 600.0) -> None:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def ring(comm, impl: str) -> dict:
    import torch
    from repro_torch.core.ring import ring_attention
    q, kl, seg, pos = ring_inputs()
    sl = slice(comm.rank * C, (comm.rank + 1) * C)
    qt = torch.tensor(q[sl], requires_grad=True)
    kt = torch.tensor(kl[sl], requires_grad=True)
    s, p = torch.tensor(seg[sl]), torch.tensor(pos[sl])
    out = ring_attention(
        qt, kt, None, s, s, p, p, composition=(R,), kv_sharded=False,
        kv_group_of_head=torch.zeros(RING_HEADS, dtype=torch.int64),
        scale=RING_SCALE, attn_impl=impl, v_in_k=(0, V_DIM), kv_chunk=8,
        comm=comm)
    loss = (out.float() ** 2).sum()
    loss.backward()
    return {"loss": np.float32(loss.item()), "dq": qt.grad.numpy(),
            "dkl": kt.grad.numpy()}


def serve(comm, params, cfg, impl: str) -> dict:
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine(params, cfg, Runtime(device="cpu", comm=comm,
                                           attn_impl=impl),
                      ServeConfig(max_slots=SLOTS, max_context=MAX_CONTEXT,
                                  prefill_capacity=CAPACITY,
                                  collect_logits=True))
    comps = []
    plan_pool = eng.service.plan_pool

    def recorded(lengths):
        plan = plan_pool(lengths)
        comps.append([tuple(w.composition) for w in plan.waves])
        return plan
    eng.service.plan_pool = recorded
    rids = [eng.submit(p, NEW_TOKENS) for p in prompts(cfg.vocab_size)]
    eng.drain(max_steps=200)
    reqs = [eng.pool.get(r) for r in rids]
    caches = eng.cache["head_layers"] + eng.cache["blocks"]
    return {"tokens": np.array([r.generated for r in reqs]),
            "logits": np.stack([np.stack(r.logits) for r in reqs]),
            "comps": np.array(repr(comps)), "layout": eng.shard.layout,
            "cache_shapes": np.array([list(c["kv_lat"].shape[-3:])
                                      for c in caches])}


def train(comm, params, cfg, impl: str):
    import torch
    from repro_torch import bridge
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.train_step import make_accum_steps, zeros_accum
    rt = Runtime(device="cpu", comm=comm, composition=(R,), remat="none",
                 attn_impl=impl)
    w = train_wave(cfg.vocab_size)
    sl = slice(comm.rank * C, (comm.rank + 1) * C)
    batch = {k: torch.tensor(v[sl]) for k, v in w.items()}
    batch["denom"] = torch.tensor(float(sum(TRAIN_LENS)))
    grad_step, _ = make_accum_steps(cfg, rt, AdamWConfig())
    acc, m = grad_step(params, zeros_accum(params), batch, rt)
    return float(m["loss"]), bridge.params_to_flat(acc)


def _rank_main(rank: int, out_dir: str) -> None:
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.configs.registry import get_config
    from repro_torch.parallel.comm import ProcessGroupComm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        comm = ProcessGroupComm()
        res = {}
        for impl in IMPLS:
            for key, x in ring(comm, impl).items():
                res[f"ring/{impl}/{key}"] = x
        _wait_for(f"{out_dir}/jax_params.npz")
        cfg = config(get_config(ARCH).reduced())
        params = bridge.params_from_flat(
            dict(np.load(f"{out_dir}/jax_params.npz")), cfg, "cpu")
        for impl in IMPLS:
            for key, x in serve(comm, params, cfg, impl).items():
                res[f"serve/{impl}/{key}"] = x
            loss, grads = train(comm, params, cfg, impl)
            res[f"train/{impl}/loss"] = np.float32(loss)
            for key, g in grads.items():
                res[f"train/{impl}/grad/{key}"] = g
        np.savez(f"{out_dir}/torch_rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    import torch.multiprocessing as mp
    (out_dir,) = argv
    mp.start_processes(_rank_main, args=(out_dir,), nprocs=R, join=True,
                       start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    sys.exit(main(sys.argv[1:]))
