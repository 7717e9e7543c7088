"""The port's side of the hdp = 2 cases of `tests/test_torch_archs.py`:
reduced gemma2-9b and gemma3-12b (window 16) in float32 on 2 gloo ranks
(one process per rank), written to npz for the test.

    python tests/_torch_archs_worker.py OUT_DIR

Imports numpy only at the top (the reference's script reads the cases'
constants from here); the spawned ranks import torch and the port, never
JAX.  The ranks wait for the reference's parameters of each model
(``OUT_DIR/jax_params_<arch>.npz``, written before the reference runs)
and each writes ``OUT_DIR/torch_rank{r}.npz``:

* serving (gemma2-9b): `PROMPT_LENS` through `ServeEngine` at `SLOTS`
  slots, which do not tile the 2 ranks, so every rank holds half of
  every slot's cache positions (``"seq"``): 32 of a global layer's 64, 8
  of a local layer's 16-position ring buffer.  The 40-token prompt exceeds the prefill
  capacity of 32 a rank, so it prefills through a (2,) ring, and the
  window.
* training (both models): one (2,) wave of `TRAIN_LENS` (50 > the
  window, across the two ranks' rows) through `grad_step`: each rank's
  loss share over the global denom and its gradients, under both
  ``attn_impl``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

R = 2                                         # HDP ranks
ARCH = "gemma2-9b"                            # the serving case's model
ARCHS = ("gemma2-9b", "gemma3-12b")           # the training case's
PROMPT_LENS = [40, 20, 9]
NEW_TOKENS = 6
SLOTS, MAX_CONTEXT, CAPACITY = 3, 64, 32
C = 32                                        # training rows a rank
TRAIN_LENS = [50, 10]                         # + 4 padding rows
IMPLS = ("flash", "ref")
NORM_NOISE = 0.1          # norm scales drawn off their zero init, so the
                          # (1 + scale) factors are tested


def config(cfg):
    """``cfg`` (either package's reduced Gemma config) in float32."""
    return dataclasses.replace(cfg, dtype="float32")


def prompts(vocab: int) -> list:
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n) for n in PROMPT_LENS]


def train_wave(vocab: int) -> dict:
    """The (2,) wave: [R·C] tokens, labels, seg, pos (int32)."""
    rng = np.random.RandomState(1)
    t = R * C
    out = {k: np.zeros(t, np.int32) for k in ("tokens", "labels", "seg",
                                               "pos")}
    cur = 0
    for i, n in enumerate(TRAIN_LENS):
        out["tokens"][cur:cur + n] = rng.randint(0, vocab, n)
        out["labels"][cur:cur + n] = rng.randint(0, vocab, n)
        out["seg"][cur:cur + n] = i + 1
        out["pos"][cur:cur + n] = np.arange(n)
        cur += n
    return out


def perturb_norms(flat: dict) -> dict:
    """Add NORM_NOISE x N(0, 1) to every norm scale of a flat parameter
    dict (keys in sorted order, one numpy stream)."""
    rng = np.random.RandomState(7)
    out = dict(flat)
    for key in sorted(flat):
        if key.rsplit("/", 1)[-1] in ("scale", "q_norm", "k_norm"):
            out[key] = (flat[key] + NORM_NOISE * rng.randn(
                *flat[key].shape)).astype(flat[key].dtype)
    return out


def _wait_for(path: str, timeout: float = 300.0) -> None:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


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
    cache = eng.cache["blocks"]
    return {"tokens": np.array([r.generated for r in reqs]),
            "logits": np.stack([np.stack(r.logits) for r in reqs]),
            "comps": np.array(repr(comps)), "layout": eng.shard.layout,
            "cache_positions": np.array([c["k"].shape[2] for c in cache])}


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
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm = ProcessGroupComm()
        res = {}
        for arch in ARCHS:
            _wait_for(f"{out_dir}/jax_params_{arch}.npz")
            cfg = config(get_config(arch).reduced())
            params = bridge.params_from_flat(
                dict(np.load(f"{out_dir}/jax_params_{arch}.npz")), cfg,
                "cpu")
            for impl in IMPLS:
                if arch == ARCH:
                    got = serve(comm, params, cfg, impl)
                    for key, x in got.items():
                        res[f"serve/{impl}/{key}"] = x
                loss, grads = train(comm, params, cfg, impl)
                res[f"train/{arch}/{impl}/loss"] = np.float32(loss)
                for key, g in grads.items():
                    res[f"train/{arch}/{impl}/grad/{key}"] = g
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
