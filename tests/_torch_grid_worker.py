"""The port's side of `tests/test_torch_grid.py`: the pipelined `Trainer`
with tensor parallelism on 8 gloo ranks, 2 stages x hdp 2 x tp 2 (one
process per rank), written to npz for the test to hold against the
reference's pipelined `Trainer` on ``make_pipeline_mesh(2, 2, 2)``.

    python tests/_torch_grid_worker.py OUT_DIR

Imports torch and the port only (no JAX), so the eight spawned ranks
start light.  World rank s·4 + h·2 + m is stage s, HDP position h, model
rank m (`parallel/comm.py::grid`).  The ranks wait for the reference's
initial parameters (``OUT_DIR/jax_params.npz``, its global leaves at tp
2) and each takes its stage window and model slices of them, then:

* ``ref``: `STEPS` steps at 2 x 2 x 2, a checkpoint of step `CKPT_STEP`
  into ``OUT_DIR/ckpt``; per step the plan fingerprint, the step, wave
  and round losses, the grad norm, this rank's parameters after it, and
  the tied embedding's gradient on this rank's vocabulary rows: this
  rank's own, and summed over its stage and HDP groups;
* ``ckpt``: the checkpoint resumed at 1 x 2 x 2 (each stage's four ranks
  run the same resume side by side: its HDP and model groups) and at
  1 x 1 x 2 (each model group); each trains step `CKPT_STEP` + 1 (held
  to ``ref``'s) and the 1 x 2 x 2 resume records its restored state;
* ``off``: 4 layers (2 periods a stage), one step with the plan's
  offloading rounds (the bytes ledger on) and the same step with the
  offload switched off in execution only (remat ``"full"``); seeded
  weights; on the 2 x 2 x 2 grid (``pp``) and at one stage on each
  stage's four ranks, hdp 2 x tp 2 (``flat``).

Each rank writes ``OUT_DIR/torch_rank{r}.npz``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

S, H, TP = 2, 2, 2                  # stages, HDP ranks, model ranks
R = S * H * TP
CAP, TOKENS, CONTEXT = 256, 2048, 1024
STEPS, CKPT_STEP = 3, 2
LR, TOTAL_STEPS = 1e-3, 8
DIST = ("tiny", 4.5, 0.8, 0.1, 1.5, 256)      # tests/test_system.py
OFF_LAYERS = 4
ARCH = "llama3.2-3b"
KINDS = ("ring", "pp", "offload_d2h", "offload_h2d")


def config(layers: int = 0):
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def trainer(comm, stage_comm, tp_comm, flat, layers=0, plan_stages=S,
            **tcfg):
    """The port's `Trainer` on the given groups (None: one rank) from the
    reference's global parameters (seeded ones if ``flat`` is None),
    PP-Balance plans for ``plan_stages`` stages (DP-Balance's at 1),
    recording each step's plan fingerprint in ``.plans``."""
    from repro_torch import bridge
    from repro_torch.data.distribution import LengthDistribution
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    from repro_torch.obs.numerics import plan_fingerprint
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = config(layers)
    rt = Runtime(device="cpu", comm=comm, stage_comm=stage_comm,
                 tp_comm=tp_comm)
    ds = SyntheticDataset(LengthDistribution(*DIST), cfg.vocab_size,
                          tokens_per_step=TOKENS, context=CONTEXT)
    mode = "pp" if plan_stages > 1 else "dp"
    sched = GlobalScheduler(ds, cfg, capacity=CAP, hdp=rt.hdp_size,
                            mode=mode, num_stages=plan_stages,
                            use_offload=tcfg.get("use_offload", False))
    plans = []
    plan_step = sched.plan_step

    def recorded(step):
        plan = plan_step(step)
        plans.append(plan_fingerprint(plan))
        return plan
    sched.plan_step = recorded
    params = None if flat is None else bridge.params_from_flat(
        flat, cfg, "cpu", stage=(rt.stage_rank, rt.num_stages),
        model=(rt.model_rank, rt.tp))
    tr = Trainer(cfg, rt, AdamWConfig(lr=LR, total_steps=TOTAL_STEPS), sched,
                 TrainerConfig(capacity=CAP, calibrate=False, attn_impl="ref",
                               mode=mode, **tcfg), params=params)
    tr.plans = plans
    return tr


def run_history(comm, stage_comm, tp_comm, flat, res, out_dir) -> None:
    """``ref`` (module docstring)."""
    from repro_torch import bridge
    tr = trainer(comm, stage_comm, tp_comm, flat,
                 ckpt_dir=f"{out_dir}/ckpt", ckpt_every=CKPT_STEP)
    apply_step = tr.apply_step

    def apply(params, state, acc):
        g = acc["embed"].clone()
        res[f"ref/embed_grad_own/{tr.step}"] = g.numpy().copy()
        for c in (tr.rt.stage_comm, tr.rt.comm):
            c.all_reduce(g)
        res[f"ref/embed_grad/{tr.step}"] = g.numpy()
        return apply_step(params, state, acc)
    tr.apply_step = apply
    try:
        for key, v in bridge.params_to_flat(tr.params).items():
            res[f"ref/p0/{key}"] = v
        for s in range(STEPS):
            rec = tr.train_step()
            nu = tr.last_numerics
            for key, v in bridge.params_to_flat(tr.params).items():
                res[f"ref/p{s + 1}/{key}"] = v
            res[f"ref/wave_losses/{s}"] = np.array(nu["wave_losses"])
            res[f"ref/round_losses/{s}"] = np.array(nu["round_losses"])
            for k in ("loss", "grad_norm", "waves", "rounds"):
                res.setdefault(f"ref/{k}", []).append(rec[k])
            res.setdefault(f"ref/applied", []).append(nu["applied"])
            if tr.step == CKPT_STEP:
                tr.ckpt.wait()
        tr.ckpt.wait()
        res["ref/fp"] = np.array(tr.plans)
    finally:
        tr.sched.stop()


def ckpt_check(comm, tp_comm, res, out_dir) -> None:
    """``ckpt`` (module docstring)."""
    import torch.distributed as dist
    from repro_torch import bridge
    from _torch_hdp_train_worker import state_flat
    dist.barrier()
    for run, groups in (("g122", (comm, None, tp_comm)),
                        ("g112", (None, None, tp_comm))):
        tr = trainer(*groups, None, ckpt_dir=f"{out_dir}/ckpt",
                     ckpt_save=False)
        try:
            assert tr.resume_if_possible()
            res[f"ckpt/{run}/resumed_at"] = tr.step
            if run == "g122":
                for key, v in bridge.params_to_flat(tr.params).items():
                    res[f"ckpt/{run}/params/{key}"] = v
                for key, v in state_flat(tr.opt_state).items():
                    res[f"ckpt/{run}/state/{key}"] = v
            rec = tr.train_step()
            res[f"ckpt/{run}/loss"] = rec["loss"]
            res[f"ckpt/{run}/grad_norm"] = rec["grad_norm"]
        finally:
            tr.sched.stop()


def offload_check(comm, stage_comm, tp_comm, res, tag) -> None:
    """``off`` (module docstring) under ``off/<tag>/``: each run's loss,
    wave losses and parameters; the offloading run's ledger records, and
    the (stage-local) k of its dispatches."""
    from repro_torch import bridge
    from repro_torch.obs import ledger
    stages = 1 if stage_comm is None else stage_comm.size
    for run, offload in (("offload", True), ("full", False)):
        ledger.set_ledger_enabled(run == "offload")
        tr = trainer(comm, stage_comm, tp_comm, None, layers=OFF_LAYERS,
                     plan_stages=stages, use_offload=True)
        tr.offload_ok = offload
        keys = []
        tr.telemetry_fn = lambda ws, *_, **__: keys.append(
            (tuple(ws[0].composition), ws[0].c_mult,
             round(max(w.offload_ratio for w in ws), 2)))
        try:
            rec = tr.train_step()
            res[f"off/{tag}/{run}/loss"] = rec["loss"]
            res[f"off/{tag}/{run}/wave_losses"] = np.array(
                tr.last_numerics["wave_losses"])
            for key, v in bridge.params_to_flat(tr.params).items():
                res[f"off/{tag}/{run}/p1/{key}"] = v
            if offload:
                recs = tr.ledger.recent(64)
                res[f"off/{tag}/ledger/comp"] = np.array(
                    [str(tuple(r["comp"])) for r in recs])
                res[f"off/{tag}/ledger/c_mult"] = np.array(
                    [r["c_mult"] for r in recs])
                res[f"off/{tag}/ledger/n_waves"] = np.array(
                    [r["n_waves"] for r in recs])
                res[f"off/{tag}/ledger/pred"] = np.array(
                    [[r["pred"][k] for k in KINDS] for r in recs])
                res[f"off/{tag}/ledger/meas"] = np.array(
                    [[r["meas"][k] for k in KINDS] for r in recs])
                res[f"off/{tag}/ledger/r"] = np.array(
                    [key[2] for key in keys])
                res[f"off/{tag}/ledger/k"] = np.array(
                    [tr._exec_cache[key].offload_periods for key in keys])
                res[f"off/{tag}/moved"] = np.array(
                    [tr.offload_store.d2h_bytes, tr.offload_store.h2d_bytes])
        finally:
            ledger.set_ledger_enabled(False)
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
    from repro_torch.parallel.comm import grid
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm, stage_comm, tp_comm = grid(S, H, TP)
        res: dict = {"stage": stage_comm.rank, "hdp_rank": comm.rank,
                     "model_rank": tp_comm.rank}
        offload_check(comm, stage_comm, tp_comm, res, "pp")
        offload_check(comm, None, tp_comm, res, "flat")
        _wait_for(f"{out_dir}/jax_params.npz")
        flat = dict(np.load(f"{out_dir}/jax_params.npz"))
        run_history(comm, stage_comm, tp_comm, flat, res, out_dir)
        ckpt_check(comm, tp_comm, res, out_dir)
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
