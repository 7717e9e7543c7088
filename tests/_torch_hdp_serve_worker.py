"""The port's side of `tests/test_torch_hdp_serve.py`: the serving pool
through `ServeEngine` at hdp = 4, and its run on 4 gloo ranks (one
process per rank), written to npz for the test.

    python tests/_torch_hdp_serve_worker.py OUT_DIR

Imports numpy only at the top (the reference's script reads the pool's
constants from here); the spawned ranks import torch and the port, never
JAX.  The ranks wait for the reference's parameters (``OUT_DIR/
jax_params.npz``, written before the reference serves) and each writes
``OUT_DIR/torch_rank{r}.npz``: the `GLOO_CASE` pool's tokens, logit rows
and wave compositions.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

R = 4                                         # HDP ranks
PROMPT_LENS = [100, 40, 9, 20, 5, 60, 70, 3]
NEW_TOKENS = 6
MAX_CONTEXT, CAPACITY = 128, 32
SLOTS = (4, 6)                                # "batch", then "seq" layout
GLOO_CASE = (6, "flash")                      # slots, attn_impl
TORCH_THREADS = 1                             # ThreadRanks and gloo ranks
                                              # alike, for bit-equal GEMMs


def config():
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("llama3.2-3b").reduced(),
                               dtype="float32")


def prompts(vocab: int) -> list:
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n) for n in PROMPT_LENS]


def serve_pool(comm, params, cfg, slots: int, impl: str, pool=None,
               plant=None) -> dict:
    """The pool through this rank's engine -> {"tokens" [n, NEW_TOKENS],
    "logits" [n, NEW_TOKENS, V], "errors", "comps" (each admission
    round's wave compositions), "engine"}.  ``plant(engine)`` runs after
    the engine's first step."""
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine(params, cfg, Runtime(device="cpu", comm=comm,
                                           attn_impl=impl),
                      ServeConfig(max_slots=slots, max_context=MAX_CONTEXT,
                                  prefill_capacity=CAPACITY,
                                  collect_logits=True))
    comps = []
    plan_pool = eng.service.plan_pool

    def recorded(lengths):
        plan = plan_pool(lengths)
        comps.append([tuple(w.composition) for w in plan.waves])
        return plan
    eng.service.plan_pool = recorded
    pool = prompts(cfg.vocab_size) if pool is None else pool
    rids = [eng.submit(p, NEW_TOKENS) for p in pool]
    if plant is not None:
        eng.step()
        plant(eng)
    eng.drain(max_steps=200)
    reqs = [eng.pool.get(r) for r in rids]
    return {"tokens": [list(r.generated) for r in reqs],
            "logits": [np.stack(r.logits) if r.logits else None
                       for r in reqs],
            "errors": [r.error for r in reqs], "comps": comps,
            "engine": eng}


def _wait_for(path: str, timeout: float = 300.0) -> None:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def _rank_main(rank: int, out_dir: str) -> None:
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.parallel.comm import ProcessGroupComm
    torch.set_num_threads(TORCH_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm = ProcessGroupComm()
        _wait_for(f"{out_dir}/jax_params.npz")
        cfg = config()
        params = bridge.params_from_flat(
            dict(np.load(f"{out_dir}/jax_params.npz")), cfg, "cpu")
        slots, impl = GLOO_CASE
        res = serve_pool(comm, params, cfg, slots, impl)
        np.savez(f"{out_dir}/torch_rank{rank}.npz",
                 tokens=np.array(res["tokens"]),
                 logits=np.stack(res["logits"]),
                 comps=np.array(repr(res["comps"])))
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
