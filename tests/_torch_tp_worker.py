"""The port's side of `tests/test_torch_tp.py`: the `Trainer` with tensor
parallelism on a 2 x 2 grid of gloo ranks (world rank h·2 + m: HDP
position h, model rank m; one process per rank), written to npz for the
test to hold against the reference.

    python tests/_torch_tp_worker.py OUT_DIR

Imports torch and the port only (no JAX), so the four spawned ranks start
light.  The ranks wait for the reference's initial parameters
(``OUT_DIR/jax_params.npz``, the global leaves in its layout at tp 2) and
each takes its model slices, so both sides start from the same weights.

* ``ref`` and ``flash``: 3 steps at 2 x 2; per step the plan
  fingerprint, the step and wave losses, the grad norm and this rank's
  parameters (its model slices) after it.  The ``ref`` run checkpoints
  step 2 into ``OUT_DIR/ckpt22`` (every rank's optimiser shards after
  step 2 recorded beside it).
* ``h4``: the 4 ranks as a 4 x 1 grid resume ``ckpt22`` and train step 3
  (the reference resumes the same file at (4, 1)).

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
CAP, TOKENS, CONTEXT = 256, 1024, 512
STEPS = 3
LR, TOTAL_STEPS = 1e-3, 8
DIST = ("tiny", 4.5, 0.8, 0.1, 1.5, 256)      # tests/test_system.py
IMPLS = ("ref", "flash")
ARCH = "llama3.2-3b"
CKPT_STEP = 2


def wave(vocab: int) -> dict:
    """One packed wave of 64 tokens (sequences of 30 and 20, padding
    after) with denom 50, as numpy arrays: tp 4's case."""
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


def trainer(comm, tp_comm, flat, impl="ref", cfg=None, **tcfg):
    """The port's `Trainer` of ``cfg`` (default `config`) on ``comm``'s
    HDP ranks and ``tp_comm``'s model ranks from the reference's global
    parameters, recording each
    step's plan fingerprint in ``.plans``."""
    from repro_torch import bridge
    from repro_torch.data.distribution import LengthDistribution
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    from repro_torch.obs.numerics import plan_fingerprint
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = config() if cfg is None else cfg
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
                 TrainerConfig(capacity=CAP, calibrate=False, attn_impl=impl,
                               **tcfg),
                 params=bridge.params_from_flat(flat, cfg, "cpu",
                                                model=model))
    tr.plans = plans
    return tr


def state_flat(state) -> dict:
    from repro_torch import bridge
    return {f"{k}/{key}": v for k in ("master", "m", "v")
            for key, v in bridge.params_to_flat(state[k]).items()}


def run_history(comm, tp_comm, flat, impl, res, out_dir) -> None:
    """STEPS steps at 2 x 2 (see the module docstring)."""
    from repro_torch import bridge
    ckpt = impl == "ref"
    tr = trainer(comm, tp_comm, flat, impl,
                 **(dict(ckpt_dir=f"{out_dir}/ckpt22", ckpt_every=CKPT_STEP)
                    if ckpt else {}))
    try:
        for key, v in bridge.params_to_flat(tr.params).items():
            res[f"{impl}/p0/{key}"] = v
        for s in range(STEPS):
            rec = tr.train_step()
            for key, v in bridge.params_to_flat(tr.params).items():
                res[f"{impl}/p{s + 1}/{key}"] = v
            res[f"{impl}/wave_losses/{s}"] = np.array(
                tr.last_numerics["wave_losses"])
            for k in ("loss", "grad_norm", "waves"):
                res.setdefault(f"{impl}/{k}", []).append(rec[k])
            res.setdefault(f"{impl}/applied", []).append(
                tr.last_numerics["applied"])
            if ckpt and tr.step == CKPT_STEP:
                tr.ckpt.wait()
                for key, v in state_flat(tr.opt_state).items():
                    res[f"ckpt/state/{key}"] = v
        res[f"{impl}/fp"] = np.array(tr.plans)
        if ckpt:
            tr.ckpt.wait()
    finally:
        tr.sched.stop()


def resume_4x1(world, flat, res, out_dir) -> None:
    """The 4 ranks as 4 HDP ranks resume ``ckpt22``'s step 2 and train
    step 3."""
    from repro_torch import bridge
    tr = trainer(world, None, flat, "ref", ckpt_dir=f"{out_dir}/ckpt22",
                 ckpt_save=False)
    try:
        assert tr.resume_if_possible()
        res["h4/resumed_at"] = tr.step
        for key, v in state_flat(tr.opt_state).items():
            res[f"h4/state/{key}"] = v
        rec = tr.train_step()
        for k in ("loss", "grad_norm", "waves"):
            res[f"h4/{k}"] = rec[k]
        for key, v in bridge.params_to_flat(tr.params).items():
            res[f"h4/after/{key}"] = v
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
    from repro_torch.parallel.comm import ProcessGroupComm, tp_grid
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm, tp_comm = tp_grid(HDP, TP)
        world = ProcessGroupComm()
        _wait_for(f"{out_dir}/jax_params.npz")
        flat = dict(np.load(f"{out_dir}/jax_params.npz"))
        res: dict = {"hdp_rank": comm.rank, "model_rank": tp_comm.rank}
        for impl in IMPLS:
            run_history(comm, tp_comm, flat, impl, res, out_dir)
        resume_4x1(world, flat, res, out_dir)
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
