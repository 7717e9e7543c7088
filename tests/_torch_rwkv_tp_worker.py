"""The port's side of `tests/test_torch_rwkv_tp.py`: reduced rwkv6-7b in
float32 trained with tensor parallelism on 4 gloo ranks (one process
each), written to npz for the test to hold against the reference and
against the port's own runs.

    python tests/_torch_rwkv_tp_worker.py OUT_DIR

Imports torch and the port only (no JAX), so the four spawned ranks start
light.  The ranks wait for the reference's initial parameters
(``OUT_DIR/jax_params.npz``, the global leaves) and then run, each from
them:

* ``t12``: hdp 1 x tp 2 on each model group ({0, 1} and {2, 3} side by
  side), `STEPS` Trainer steps: the test holds it to the reference's
  Trainer on a (1, 2) mesh;
* ``g22``: the 4 ranks as a 2 x 2 grid (world rank h·2 + m), `STEPS`
  steps;
* ``g21``: hdp 2 x tp 1 on each HDP group ({0, 2} and {1, 3}), the same
  steps: the 2 x 2 grid's control.  A sequence sharded over the HDP
  ranks crosses them at its last non-padding row, where the reference
  sends its buffer's last row, so 2 x 2 is held to the port's 2 x 1 and
  not to the reference's (2, 2) mesh.

Per run and step: the plan fingerprint, loss, wave losses, grad norm,
applied flag and this rank's parameters (its model slices) after it.
Each rank writes ``OUT_DIR/torch_rank{r}.npz``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

HDP, TP = 2, 2
R = HDP * TP
CAP, TOKENS, CONTEXT = 128, 512, 256
STEPS = 2
LR, TOTAL_STEPS = 1e-3, 8
DIST = ("tiny", 4.5, 0.8, 0.1, 1.5, 256)      # tests/test_system.py
ARCH = "rwkv6-7b"


def wave(vocab: int) -> dict:
    """One packed wave of 64 tokens (sequences of 30 and 20, padding
    after) with denom 50, as numpy arrays."""
    rng = np.random.RandomState(5)
    t, lens = 64, (30, 20)
    out = {k: np.zeros(t, np.int32) for k in ("tokens", "labels", "seg",
                                               "pos")}
    cur = 0
    for i, n in enumerate(lens):
        out["tokens"][cur:cur + n] = rng.randint(0, vocab, n)
        out["labels"][cur:cur + n] = rng.randint(0, vocab, n)
        out["seg"][cur:cur + n] = i + 1
        out["pos"][cur:cur + n] = np.arange(n)
        cur += n
    out["denom"] = np.float32(50.0)
    return out


def config():
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")


def trainer(comm, tp_comm, flat):
    """The port's `Trainer` on ``comm``'s HDP ranks and ``tp_comm``'s
    model ranks (None: one) from the reference's global parameters,
    recording each step's plan fingerprint in ``.plans``."""
    from repro_torch import bridge
    from repro_torch.data.distribution import LengthDistribution
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    from repro_torch.obs.numerics import plan_fingerprint
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = config()
    hdp = 1 if comm is None else comm.size
    model = (0, 1) if tp_comm is None else (tp_comm.rank, tp_comm.size)
    ds = SyntheticDataset(LengthDistribution(*DIST), cfg.vocab_size,
                          tokens_per_step=TOKENS, context=CONTEXT)
    sched = GlobalScheduler(ds, cfg, capacity=CAP, hdp=hdp,
                            use_offload=False)
    plans = []
    plan_step = sched.plan_step

    def recorded(step):
        plan = plan_step(step)
        plans.append(plan_fingerprint(plan))
        return plan
    sched.plan_step = recorded
    tr = Trainer(cfg, Runtime(device="cpu", comm=comm, tp_comm=tp_comm),
                 AdamWConfig(lr=LR, total_steps=TOTAL_STEPS), sched,
                 TrainerConfig(capacity=CAP, calibrate=False),
                 params=bridge.params_from_flat(flat, cfg, "cpu",
                                                model=model))
    tr.plans = plans
    return tr


def run_history(comm, tp_comm, flat, run, res) -> None:
    """`STEPS` steps under the key ``run`` (module docstring)."""
    from repro_torch import bridge
    tr = trainer(comm, tp_comm, flat)
    try:
        for key, v in bridge.params_to_flat(tr.params).items():
            res[f"{run}/p0/{key}"] = v
        for s in range(STEPS):
            rec = tr.train_step()
            for key, v in bridge.params_to_flat(tr.params).items():
                res[f"{run}/p{s + 1}/{key}"] = v
            res[f"{run}/wave_losses/{s}"] = np.array(
                tr.last_numerics["wave_losses"])
            for k in ("loss", "grad_norm", "waves"):
                res.setdefault(f"{run}/{k}", []).append(rec[k])
            res.setdefault(f"{run}/applied", []).append(
                tr.last_numerics["applied"])
        res[f"{run}/fp"] = np.array(tr.plans)
    finally:
        tr.sched.stop()


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
    from repro_torch.parallel.comm import tp_grid
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm, tp_comm = tp_grid(HDP, TP)
        _wait_for(f"{out_dir}/jax_params.npz")
        flat = dict(np.load(f"{out_dir}/jax_params.npz"))
        res: dict = {"hdp_rank": comm.rank, "model_rank": tp_comm.rank}
        run_history(None, tp_comm, flat, "t12", res)
        run_history(comm, tp_comm, flat, "g22", res)
        run_history(comm, None, flat, "g21", res)
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
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    sys.exit(main(sys.argv[1:]))
