"""The port's side of `tests/test_torch_pipeline.py`: the pipelined
`Trainer` on 4 gloo ranks, 2 stages × hdp 2 (one process per rank),
written to npz for the test to hold against the reference.

    python tests/_torch_pipeline_worker.py OUT_DIR

Imports torch and the port only (no JAX), so the four spawned ranks start
light.  The runs from the reference's initial parameters wait for
``OUT_DIR/jax_params.npz`` (written by the JAX side before it trains).
World rank s·2 + h is stage s, HDP position h (`parallel/comm.py::
stage_grid`); the stage-less runs use each rank's HDP group (ranks {0, 1}
and {2, 3} run the same 1-stage hdp = 2 step side by side), and the
checkpoint's resumes use the stage groups {0, 2} (2 stages × hdp 1) and
{1, 3} (as the HDP group of a 1-stage hdp = 2 run).  Each rank writes
``OUT_DIR/torch_rank{r}.npz``; the checkpoint scenario writes
``OUT_DIR/ckpt22`` (2 × 2, step 2), which the JAX side restores.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

from _torch_hdp_train_worker import opt_inputs, state_flat

R, S, H = 4, 2, 2                   # world, stages, HDP ranks
CAP, TOKENS, CONTEXT = 256, 2048, 1024
STEPS = 3
LR, TOTAL_STEPS = 1e-3, 8
DIST = ("tiny", 4.5, 0.8, 0.1, 1.5, 256)      # tests/test_system.py
IMPLS = ("ref", "flash")
OFF_LAYERS = 4                      # 2 periods a stage, so k < n exists
ARCH, MOE_ARCH = "llama3.2-3b", "mistral-8x7b"


def config(arch: str = ARCH, layers: int = 0):
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def scheduler(cfg, hdp: int = H, use_offload: bool = False,
              sched_async: bool = False):
    """PP-Balance plans for 2 stages at ``hdp`` ranks, the same whatever
    the runtime that executes them."""
    from repro_torch.data.distribution import LengthDistribution
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    ds = SyntheticDataset(LengthDistribution(*DIST), cfg.vocab_size,
                          tokens_per_step=TOKENS, context=CONTEXT)
    return GlobalScheduler(ds, cfg, capacity=CAP, hdp=hdp, mode="pp",
                           num_stages=S, use_offload=use_offload,
                           sched_async=sched_async)


def trainer(comm, stage_comm, flat, impl="ref", arch=ARCH, layers=0,
            **tcfg):
    """The port's `Trainer` on ``comm``'s HDP ranks and ``stage_comm``'s
    stages (None: one) from the reference's flat parameters (seeded ones
    if ``flat`` is None), recording each step's plan fingerprint in
    ``.plans``."""
    from repro_torch import bridge
    from repro_torch.obs.numerics import plan_fingerprint
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = config(arch, layers)
    rt = Runtime(device="cpu", comm=comm, stage_comm=stage_comm)
    sched = scheduler(cfg, rt.hdp_size, tcfg.get("use_offload", False),
                      tcfg.get("sched_async", False))
    plans = []
    plan_step = sched.plan_step

    def recorded(step):
        plan = plan_step(step)
        plans.append(plan_fingerprint(plan))
        return plan
    sched.plan_step = recorded
    params = None if flat is None else bridge.params_from_flat(
        flat, cfg, "cpu", stage=(rt.stage_rank, rt.num_stages))
    tr = Trainer(cfg, rt, AdamWConfig(lr=LR, total_steps=TOTAL_STEPS), sched,
                 TrainerConfig(capacity=CAP, calibrate=False, attn_impl=impl,
                               mode="pp", **tcfg), params=params)
    tr.plans = plans
    return tr


def reduced_embed(tr, acc):
    """The step's embedding gradient summed over every rank of the world
    (a copy: the accumulator itself is left to the apply)."""
    g = acc["embed"].clone()
    for c in (tr.rt.stage_comm, tr.rt.comm):
        if c is not None:
            c.all_reduce(g)
    return g.numpy()


def run_history(comm, stage_comm, flat, run, res, impl="ref", arch=ARCH,
                steps=STEPS) -> None:
    """``steps`` steps under the key ``run``; per step the fingerprint,
    loss, grad norm, wave and round losses, the embedding's reduced
    gradient and this rank's parameters after it (p0: before)."""
    from repro_torch import bridge
    tr = trainer(comm, stage_comm, flat, impl, arch)
    apply_step = tr.apply_step

    def apply(params, state, acc):
        res[f"{run}/embed_grad/{tr.step}"] = reduced_embed(tr, acc)
        return apply_step(params, state, acc)
    tr.apply_step = apply
    try:
        for key, v in bridge.params_to_flat(tr.params).items():
            res[f"{run}/p0/{key}"] = v
        for s in range(steps):
            rec = tr.train_step()
            nu = tr.last_numerics
            for key, v in bridge.params_to_flat(tr.params).items():
                res[f"{run}/p{s + 1}/{key}"] = v
            res[f"{run}/wave_losses/{s}"] = np.array(nu["wave_losses"])
            if "round_losses" in nu:
                res[f"{run}/round_losses/{s}"] = np.array(
                    nu["round_losses"])
                res[f"{run}/rounds/{s}"] = np.array(
                    [len(ids) for ids in nu["rounds"]])
            for k in ("loss", "grad_norm", "waves"):
                res.setdefault(f"{run}/{k}", []).append(rec[k])
            res.setdefault(f"{run}/applied", []).append(nu["applied"])
            res.setdefault(f"{run}/bubble", []).append(
                rec.get("bubble_frac_pipeline", -1.0))
        res[f"{run}/fp"] = np.array(tr.plans)
    finally:
        tr.sched.stop()


def local(tree, stage, owned, src):
    """``src`` (a global tree) cut to this stage: the stage's window of
    every stage-owned leaf, the others whole; the tree of ``tree``."""
    from repro_torch.models.transformer import stage_periods
    from repro_torch.tree import leaves, tree_map
    out = []
    for x, o in zip(leaves(src), owned):
        if o:
            w = stage_periods(x.shape[0], stage)
            x = x[w.start:w.stop]
        out.append(x)
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def apply_check(comm, stage_comm, flat, res) -> None:
    """The ZeRO-1 apply at 2 stages × hdp 2 against the unsharded apply
    on the same reduced gradients: HDP rank 0 of each stage passes its
    window of a stage-owned leaf's gradient, world rank 0 a replicated
    leaf's, and every other rank zeros, so the reduction (a stage-owned
    leaf over the HDP ranks; a replicated one over the world) sums
    exactly them.  Each rank writes its parameters and
    master shard after the apply; world rank 0 also the unsharded apply's
    global trees."""
    from repro_torch import bridge
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.parallel import zero1
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.train_step import make_accum_steps
    from repro_torch.tree import leaves, tree_map
    cfg = config()
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    full = bridge.params_from_flat(flat, cfg, "cpu")
    grads_full, state_full = opt_inputs(cfg, full)
    stage = (stage_comm.rank, S)
    params = bridge.params_from_flat(flat, cfg, "cpu", stage=stage)
    owned = zero1.stage_owned(params)
    taken = zero1.stage_taken(params, S)
    grads = local(params, stage, owned, grads_full)
    first_h, first_s = comm.rank == 0, stage_comm.rank == 0
    acc = tree_map(lambda g: g.clone(), grads)
    for a, o in zip(leaves(acc), owned):
        if not first_h or not (o or first_s):
            a.zero_()
    state = init_state(params, comm, taken)
    for k in ("master", "m", "v"):
        src = local(params, stage, owned, state_full[k])
        for mine, x, p, t in zip(leaves(state[k]), leaves(src),
                                 leaves(params), taken):
            dim = zero1.zero1_dim(p.shape, comm.size, t)
            mine.copy_(x if dim is None
                       else zero1.shard(x, dim, comm.rank, comm.size))
    state["step"] = state_full["step"].clone()
    _, apply_step = make_accum_steps(
        cfg, Runtime(device="cpu", comm=comm, stage_comm=stage_comm), ocfg,
        guard=True)
    _, _, om = apply_step(params, state, acc)
    for key, v in bridge.params_to_flat(params).items():
        res[f"apply/sharded/params/{key}"] = v
    for key, v in bridge.params_to_flat(state["master"]).items():
        res[f"apply/sharded/master/{key}"] = v
    res["apply/om_keys"] = np.array(sorted(om))
    res["apply/sharded/om"] = np.array([float(om[k]) for k in sorted(om)])
    if first_h and first_s:
        _, apply_one = make_accum_steps(cfg, Runtime(device="cpu"), ocfg,
                                        guard=True)
        _, _, om1 = apply_one(full, state_full, grads_full)
        for key, v in bridge.params_to_flat(full).items():
            res[f"apply/full/params/{key}"] = v
        for key, v in bridge.params_to_flat(state_full["master"]).items():
            res[f"apply/full/master/{key}"] = v
        res["apply/full/om"] = np.array([float(om1[k]) for k in sorted(om1)])


def guard_check(comm, stage_comm, flat, res) -> None:
    """The nan_fault drill at 2 × 2: step 1's round 0 has a NaN
    denominator; the guarded apply must skip on every rank and leave
    params, this rank's state shards and the step counter unchanged bit
    for bit."""
    from repro_torch import bridge
    tr = trainer(comm, stage_comm, flat, nan_fault={"step": 1, "wave": 0})
    try:
        tr.train_step()
        before = (bridge.params_to_flat(tr.params), state_flat(tr.opt_state),
                  int(tr.opt_state["step"]))
        tr.train_step()
        skipped = dict(tr.last_numerics)
        after = (bridge.params_to_flat(tr.params), state_flat(tr.opt_state),
                 int(tr.opt_state["step"]))
        res["guard/unchanged"] = all(
            np.array_equal(a[k], b[k], equal_nan=True)
            for a, b in zip(after[:2], before[:2]) for k in b) \
            and after[2] == before[2] == 1
        res["guard/applied"] = skipped["applied"]
        res["guard/nonfinite"] = skipped["grad_nonfinite"]
        rec = tr.train_step()
        res["guard/next_applied"] = tr.last_numerics["applied"]
        res["guard/next_loss"] = rec["loss"]
    finally:
        tr.sched.stop()


def offload_check(comm, stage_comm, res) -> None:
    """One step of 4 layers (2 periods a stage) with the offloading
    rounds of the plan, the bytes ledger on, and the same step with the
    offload switched off in execution only (the same plans, remat
    "full"); seeded weights.  Writes each run's losses and parameters,
    and the offloading run's ledger records and the stage-local k of its
    rounds."""
    from repro_torch import bridge
    from repro_torch.obs import ledger
    for run, offload in (("offload", True), ("full", False)):
        ledger.set_ledger_enabled(run == "offload")
        tr = trainer(comm, stage_comm, None, layers=OFF_LAYERS,
                     use_offload=True)
        tr.offload_ok = offload
        keys = []
        tr.telemetry_fn = lambda ws, *_, **__: keys.append(
            (tuple(ws[0].composition), ws[0].c_mult,
             round(max(w.offload_ratio for w in ws), 2)))
        try:
            rec = tr.train_step()
            res[f"off/{run}/loss"] = rec["loss"]
            res[f"off/{run}/wave_losses"] = np.array(
                tr.last_numerics["wave_losses"])
            for key, v in bridge.params_to_flat(tr.params).items():
                res[f"off/{run}/p1/{key}"] = v
            if offload:
                recs = tr.ledger.recent(64)
                res["off/ledger/comp"] = np.array(
                    [str(tuple(r["comp"])) for r in recs])
                res["off/ledger/c_mult"] = np.array(
                    [r["c_mult"] for r in recs])
                res["off/ledger/n_waves"] = np.array(
                    [r["n_waves"] for r in recs])
                kinds = ("ring", "pp", "offload_d2h", "offload_h2d")
                res["off/ledger/pred"] = np.array(
                    [[r["pred"][k] for k in kinds] for r in recs])
                res["off/ledger/meas"] = np.array(
                    [[r["meas"][k] for k in kinds] for r in recs])
                res["off/ledger/r"] = np.array([key[2] for key in keys])
                res["off/ledger/k"] = np.array(
                    [tr._exec_cache[key].offload_periods for key in keys])
                res["off/pinned"] = tr.offload_store.pinned_bytes
        finally:
            ledger.set_ledger_enabled(False)
            tr.sched.stop()


def ckpt_check(comm, stage_comm, flat, res, out_dir: str) -> None:
    """Save at 2 stages × hdp 2, resume at 1 × 2 and at 2 × 1:

    1. every rank: 2 × 2, 2 steps, a checkpoint at step 2 (world rank 0
       writes ``ckpt22``), then step 3 (no save): the uninterrupted run;
    2. ranks 0 and 2 (the stage group of HDP position 0) resume ``ckpt22``
       at 2 stages × hdp 1, ranks 1 and 3 (the stage group of position 1,
       as an HDP group) at 1 stage × hdp 2; each writes its restored
       parameters and state shards, and trains step 3; ranks 1 and 3
       resume from ``ckpt12`` (a copy of ``ckpt22``'s step 2), save step 3
       there at 1 stage and train step 4;
    3. every rank resumes ``ckpt12`` at 2 × 2 and trains step 4."""
    import shutil
    import torch.distributed as dist
    from repro_torch import bridge
    d, d12 = f"{out_dir}/ckpt22", f"{out_dir}/ckpt12"
    tr = trainer(comm, stage_comm, flat, ckpt_dir=d, ckpt_every=2)
    try:
        for _ in tr.run(2):
            pass
        rec = tr.train_step()
        res["ckpt/uninterrupted/loss"] = rec["loss"]
        res["ckpt/uninterrupted/grad_norm"] = rec["grad_norm"]
        res["ckpt/uninterrupted/last_ckpt_step"] = tr.last_ckpt_step
    finally:
        tr.sched.stop()
    if comm.rank == 0:
        run, args = "s2h1", (None, stage_comm)
    else:
        run, args = "s1h2", (stage_comm, None)
        if stage_comm.rank == 0:
            shutil.copytree(f"{d}/step_2", f"{d12}/step_2")
    tr = trainer(*args, None, ckpt_dir=d if comm.rank == 0 else d12,
                 ckpt_save=comm.rank != 0)
    try:
        assert tr.resume_if_possible()
        res["ckpt/run"] = run
        res["ckpt/resumed_at"] = tr.step
        res["ckpt/opt_step"] = int(tr.opt_state["step"])
        res["ckpt/stage"] = np.array([tr.rt.stage_rank, tr.rt.num_stages])
        res["ckpt/hdp"] = np.array([0 if tr.rt.comm is None
                                    else tr.rt.comm.rank, tr.rt.hdp_size])
        for key, v in bridge.params_to_flat(tr.params).items():
            res[f"ckpt/params/{key}"] = v
        for key, v in state_flat(tr.opt_state).items():
            res[f"ckpt/state/{key}"] = v
        for rec in tr.run(1):          # at 1 x 2: saves step 3 in ckpt12
            res["ckpt/loss"] = rec["loss"]
            res["ckpt/grad_norm"] = rec["grad_norm"]
        if comm.rank != 0:
            res["ckpt/s1h2_step4_loss"] = tr.train_step()["loss"]
    finally:
        tr.sched.stop()
    dist.barrier()
    tr = trainer(comm, stage_comm, None, ckpt_dir=d12, ckpt_save=False)
    try:
        assert tr.resume_if_possible()
        res["ckpt/from_1stage/resumed_at"] = tr.step
        res["ckpt/from_1stage/loss"] = tr.train_step()["loss"]
    finally:
        tr.sched.stop()


def async_check(comm, stage_comm, flat, res) -> None:
    """Rounds of at most 2 waves, synchronous and from the planner
    thread's pre-built round buffers (calibrate off): the same history."""
    for run, sched_async in (("sync", False), ("async", True)):
        tr = trainer(comm, stage_comm, flat, max_round_waves=2,
                     sched_async=sched_async)
        try:
            hist = [tr.train_step() for _ in range(2)]
        finally:
            tr.sched.stop()
        res[f"cap/{run}/hist"] = np.array(
            [[r["loss"], r["grad_norm"], r["rounds"]] for r in hist])
    # the planner thread with calibrate is refused at construction over
    # several ranks, also over stages alone (hdp 1: each stage its own
    # planner thread and calibrator)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    for name, c in (("grid", comm), ("stages", None)):
        rt = Runtime(device="cpu", comm=c, stage_comm=stage_comm)
        sched = scheduler(config(), rt.hdp_size, sched_async=True)
        try:
            Trainer(config(), rt, AdamWConfig(), sched,
                    TrainerConfig(capacity=CAP, sched_async=True,
                                  calibrate=True))
            res[f"async/calibrate_refused/{name}"] = ""
        except NotImplementedError as e:
            res[f"async/calibrate_refused/{name}"] = str(e)
        finally:
            sched.stop()


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
    from repro_torch.parallel.comm import stage_grid
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm, stage_comm = stage_grid(S, H)
        res: dict = {}
        run_history(comm, stage_comm, None, "moe", res, arch=MOE_ARCH,
                    steps=1)
        run_history(comm, None, None, "moe-1stage", res, arch=MOE_ARCH,
                    steps=1)
        offload_check(comm, stage_comm, res)
        _wait_for(f"{out_dir}/jax_params.npz")
        flat = dict(np.load(f"{out_dir}/jax_params.npz"))
        for impl in IMPLS:
            run_history(comm, stage_comm, flat, impl, res, impl)
        for impl in IMPLS:
            run_history(comm, None, flat, f"1stage-{impl}", res, impl)
        apply_check(comm, stage_comm, flat, res)
        guard_check(comm, stage_comm, flat, res)
        async_check(comm, stage_comm, flat, res)
        ckpt_check(comm, stage_comm, flat, res, out_dir)
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
