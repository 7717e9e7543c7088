"""The port's side of `tests/test_torch_ep.py`: the `Trainer` with expert
parallelism on a 2 x 2 grid of gloo ranks (world rank h·2 + m: HDP
position h, model rank m; one process per rank), reduced Mistral-8x7B in
float32 (4 experts, top-2, 4/2 heads), written to npz for the test to
hold against the reference.

    python tests/_torch_ep_worker.py OUT_DIR

Imports torch, numpy and the port only (no JAX).  The ranks wait for the
reference's initial parameters (``OUT_DIR/jax_params.npz``) and each
takes its model slices, so both sides start from the same weights.

* `STEPS` steps at 2 x 2; per step the plan fingerprint, the step and
  wave losses, the grad norm, every MoE call's top-k indices gathered
  over the model group, and this rank's parameters (its model slices)
  after it.  The last step is checkpointed into ``OUT_DIR/ckpt_ep``
  (every rank's optimiser shards recorded beside it).  The test holds
  the one history against the reference's in both of its MoE routes
  (`REF_IMPLS`).

Each rank writes ``OUT_DIR/torch_rank{r}.npz``.  `moe_inputs` makes the
module case's inputs for both sides of the test from a numpy seed.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

HDP, TP = 2, 2
R = HDP * TP
STEPS = 2
ARCH = "mistral-8x7b"
REF_IMPLS = ("manual", "gather")   # the reference's moe_impl
CKPT = "ckpt_ep"
# the module case: a low capacity factor, so every expert drops pairs
MOE_ARCHS = ("mistral-8x7b", "deepseek-v2-lite-16b")
MOE_CF = 0.5
MOE_ROWS = 64                   # 32 rows an HDP rank
# the loss cases: (arch, tp); qwen3-moe's 2 KV heads replicated over 4
LOSS_CASES = [("deepseek-v2-lite-16b", 2), ("qwen3-moe-30b-a3b", 2),
              ("gemma2-9b", 2), ("gemma3-12b", 2), ("qwen3-moe-30b-a3b", 4)]


def config(arch: str = ARCH, dtype: str = "float32", **moe):
    """The reduced ``arch`` in ``dtype``; ``moe`` replaces MoESpec fields
    (the port's config, whose fields are the reference's)."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def moe_inputs(cfg) -> dict:
    """One MoE layer's global parameters (the reference's leaves and
    scales), its input x [MOE_ROWS, d] and the output's cotangent, as
    float32 numpy arrays from a seed of the arch's name."""
    spec = cfg.moe
    d, e, f = cfg.d_model, spec.num_experts, spec.d_expert
    rng = np.random.RandomState(sum(map(ord, cfg.name)))

    def normal(*shape, fan_in):
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    p = {"router": normal(d, e, fan_in=d),
         "w_in": normal(e, d, f, fan_in=d),
         "w_gate": normal(e, d, f, fan_in=d),
         "w_out": normal(e, f, d, fan_in=f)}
    if spec.num_shared:
        s = spec.num_shared * f
        p.update(shared_in=normal(d, s, fan_in=d),
                 shared_gate=normal(d, s, fan_in=d),
                 shared_out=normal(s, d, fan_in=s))
    return {"params": p,
            "x": rng.randn(MOE_ROWS, d).astype(np.float32),
            "dy": rng.randn(MOE_ROWS, d).astype(np.float32)}


def record_topk(tp_comm, calls: list):
    """While open, every `moe_route` call appends its top-k indices
    gathered over the model group ([tp, T, k]) to ``calls``; -> a
    function that closes it."""
    from repro_torch.models import moe as M
    route = M.moe_route

    def recorded(params, cfg, x):
        gates, idx = route(params, cfg, x)
        calls.append(tp_comm.all_gather(idx).numpy())
        return gates, idx
    M.moe_route = recorded

    def close():
        M.moe_route = route
    return close


def run_history(comm, tp_comm, flat, res, out_dir) -> None:
    """`STEPS` steps at 2 x 2 (see the module docstring)."""
    import _torch_tp_worker as W
    from repro_torch import bridge
    calls: list = []
    tr = W.trainer(comm, tp_comm, flat, "ref", cfg=config(),
                   ckpt_dir=f"{out_dir}/{CKPT}", ckpt_every=STEPS)
    close = record_topk(tp_comm, calls)
    try:
        for key, v in bridge.params_to_flat(tr.params).items():
            res[f"p0/{key}"] = v
        for s in range(STEPS):
            rec = tr.train_step()
            for key, v in bridge.params_to_flat(tr.params).items():
                res[f"p{s + 1}/{key}"] = v
            res[f"wave_losses/{s}"] = np.array(
                tr.last_numerics["wave_losses"])
            for k in ("loss", "grad_norm", "waves"):
                res.setdefault(k, []).append(rec[k])
            res.setdefault("applied", []).append(
                tr.last_numerics["applied"])
        res["fp"] = np.array(tr.plans)
        res["topk_calls"] = len(calls)
        res["topk_same"] = all((c == c[0]).all() for c in calls)
        tr.ckpt.wait()
        for key, v in W.state_flat(tr.opt_state).items():
            res[f"ckpt/state/{key}"] = v
    finally:
        close()
        tr.sched.stop()


def _rank_main(rank: int, out_dir: str) -> None:
    import datetime
    import torch
    import torch.distributed as dist
    import _torch_tp_worker as W
    from repro_torch.parallel.comm import tp_grid
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm, tp_comm = tp_grid(HDP, TP)
        W._wait_for(f"{out_dir}/jax_params.npz")
        flat = dict(np.load(f"{out_dir}/jax_params.npz"))
        res: dict = {"hdp_rank": comm.rank, "model_rank": tp_comm.rank}
        run_history(comm, tp_comm, flat, res, out_dir)
        np.savez(f"{out_dir}/torch_rank{rank}.npz",
                 **{k: np.asarray(v) for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    import torch.multiprocessing as mp
    (out_dir,) = argv
    mp.start_processes(_rank_main, args=(out_dir,), nprocs=R, join=True,
                       start_method="spawn")
    return 0


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "..", "src"))
    sys.path.insert(0, here)
    sys.exit(main(sys.argv[1:]))
