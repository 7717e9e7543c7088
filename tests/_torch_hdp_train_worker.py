"""The port's side of `tests/test_torch_hdp_train.py`: the multi-rank
`Trainer` under ZeRO-1 on 4 gloo ranks (one process per rank), written to
npz for the test to hold against the reference.

    python tests/_torch_hdp_train_worker.py OUT_DIR
    python tests/_torch_hdp_train_worker.py --ledger OUT_DIR

Imports torch and the port only (no JAX), so the four spawned ranks start
light.  Every scenario waits for the reference's initial parameters
(``OUT_DIR/jax_params.npz``, and ``OUT_DIR/jax_params_offload.npz`` for
the offload runs; written by the JAX side before it trains), so both sides
start from the same weights.  Each rank writes ``OUT_DIR/torch_rank{r}.npz``.

The checkpoint scenario (`ckpt_check`) writes under ``OUT_DIR/ckpt4``
(hdp = 4, steps 1 and 2) and ``OUT_DIR/ckpt1`` (hdp = 1, step 2), which
the JAX side resumes once they appear.

``--ledger`` runs only the offload scenario, with the bytes ledger on and
seeded weights (`tests/test_torch_ledger.py`); each rank writes
``OUT_DIR/ledger_rank{r}.npz``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

R = 4                               # ranks
CAP, TOKENS, CONTEXT = 256, 2048, 1024
STEPS = 3
LR, TOTAL_STEPS = 1e-3, 8
DIST = ("tiny", 4.5, 0.8, 0.1, 1.5, 256)      # tests/test_system.py
IMPLS = ("ref", "flash")
APPLY_DTYPES = ("float32", "bfloat16")
# the offload scenario: 4 layers, so that 0 < k < n is reachable; this
# mix plans a (4,) ring wave that also offloads (r 0.375, k 2) and
# singleton waves at k = 4 and k = 2
OFF_LAYERS, OFF_TOKENS, OFF_CONTEXT = 4, 2048, 2048
OFF_RUNS = tuple(f"offload-{impl}" for impl in IMPLS)
LEDGER_KINDS = ("ring", "offload_d2h", "offload_h2d")


def config(dtype: str = "float32", layers: int = 0):
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              dtype=dtype)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def scheduler(cfg, seed: int = 0, sched_async: bool = False,
              use_offload: bool = False, hdp: int = R):
    from repro_torch.data.distribution import LengthDistribution
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    tokens, context = (OFF_TOKENS, OFF_CONTEXT) if use_offload \
        else (TOKENS, CONTEXT)
    ds = SyntheticDataset(LengthDistribution(*DIST), cfg.vocab_size,
                          tokens_per_step=tokens, context=context, seed=seed)
    return GlobalScheduler(ds, cfg, capacity=CAP, hdp=hdp,
                           use_offload=use_offload, sched_async=sched_async)


def trainer(comm, flat, impl="ref", seed=0, **tcfg):
    """The port's `Trainer` on ``comm``'s ranks (one rank if None) from
    the reference's parameters (seeded ones if ``flat`` is None),
    recording each step's plan fingerprint in ``.plans``.
    ``use_offload`` runs the offload scenario's model and data."""
    from repro_torch import bridge
    from repro_torch.obs.numerics import plan_fingerprint
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    off = tcfg.get("use_offload", False)
    cfg = config(layers=OFF_LAYERS if off else 0)
    sched = scheduler(cfg, seed, tcfg.get("sched_async", False), off,
                      1 if comm is None else comm.size)
    plans = []
    plan_step = sched.plan_step

    def recorded(step):
        plan = plan_step(step)
        plans.append(plan_fingerprint(plan))
        return plan
    sched.plan_step = recorded
    tr = Trainer(cfg, Runtime(device="cpu", comm=comm),
                 AdamWConfig(lr=LR, total_steps=TOTAL_STEPS), sched,
                 TrainerConfig(capacity=CAP, calibrate=False, attn_impl=impl,
                               **tcfg),
                 params=None if flat is None
                 else bridge.params_from_flat(flat, cfg, "cpu"))
    tr.plans = plans
    return tr


def state_flat(state) -> dict:
    from repro_torch import bridge
    return {f"{k}/{key}": v for k in ("master", "m", "v")
            for key, v in bridge.params_to_flat(state[k]).items()}


def run_history(comm, flat, impl, res, offload: bool = False) -> None:
    """STEPS steps; per step the fingerprint, loss, grad norm, wave losses
    and the parameters after it (p0: after the broadcast).  ``offload``:
    the offload scenario under the key ``offload-{impl}``, with the bytes
    ledger on: each wave's (composition, c_mult, r, k) and its predicted
    and measured bytes (`ledger_arrays`)."""
    from repro_torch import bridge
    from repro_torch.obs import ledger
    run = f"offload-{impl}" if offload else impl
    ledger.set_ledger_enabled(offload)
    tr = trainer(comm, flat, impl, use_offload=offload)
    ratios = []
    tr.telemetry_fn = lambda ws, *_, **__: ratios.append(ws[0].offload_ratio)
    try:
        for key, v in bridge.params_to_flat(tr.params).items():
            res[f"{run}/p0/{key}"] = v
        if not offload:
            res["state_shapes"] = np.array(
                [f"{key}:{tuple(v.shape)}" for key, v in
                 bridge.params_to_flat(tr.opt_state["master"]).items()])
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
        if offload:
            res.update(ledger_arrays(tr, run, ratios))
    finally:
        ledger.set_ledger_enabled(False)
        tr.sched.stop()


def ledger_arrays(tr, run: str, rs) -> dict:
    """Every ledger record of the run (one a wave, in order; ``rs`` the
    waves' offload ratios): composition, c_mult, r, the periods the wave
    offloaded, predicted and measured bytes by kind."""
    from repro_torch.core.offload import offload_periods
    recs = tr.ledger.recent(1024)
    assert len(recs) == len(rs)
    return {
        f"{run}/ledger/comp": np.array([str(tuple(r["comp"])) for r in recs]),
        f"{run}/ledger/c_mult": np.array([r["c_mult"] for r in recs]),
        f"{run}/ledger/r": np.array(rs),
        f"{run}/ledger/k": np.array([offload_periods(tr.cfg, r)
                                     for r in rs]),
        f"{run}/ledger/pred": np.array([[r["pred"][k] for k in LEDGER_KINDS]
                                        for r in recs]),
        f"{run}/ledger/meas": np.array([[r["meas"][k] for k in LEDGER_KINDS]
                                        for r in recs]),
        f"{run}/ledger/n": np.array(tr.ledger.summary()["n"])}


def opt_inputs(cfg, params):
    """Full-size grads and a mid-run optimiser state from numpy (the same
    on every rank), as `tests/test_torch_train.py::_opt_inputs` draws
    them."""
    import torch
    from repro_torch.tree import tree_map
    rng = np.random.RandomState(3)

    def r(p, s):
        return torch.tensor(rng.randn(*p.shape) * s, dtype=torch.float32)
    grads = tree_map(lambda p: r(p, 0.05), params)
    state = {"step": torch.tensor(4, dtype=torch.int32),
             "master": tree_map(lambda p: p.float().clone(), params),
             "m": tree_map(lambda p: r(p, 0.01), params),
             "v": tree_map(lambda p: r(p, 1e-4).abs(), params)}
    return grads, state


def apply_check(comm, flat, dtype, res) -> None:
    """The ZeRO-1 apply against the unsharded apply on the same reduced
    gradients: rank 0 passes the grads and the other ranks zeros, so the
    reduce-scatter sums exactly them.  Each rank writes its parameters
    after the sharded apply and its gathered state; rank 0 also the
    unsharded apply's."""
    import torch
    from repro_torch import bridge
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.parallel import zero1
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.train_step import make_accum_steps
    from repro_torch.tree import leaves, tree_map
    cfg = config(dtype)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    params = bridge.params_from_flat(flat, cfg, "cpu")
    grads, full = opt_inputs(cfg, params)
    state = init_state(params, comm)
    for k in ("master", "m", "v"):
        for mine, src, p in zip(leaves(state[k]), leaves(full[k]),
                                leaves(params)):
            dim = zero1.zero1_dim(p.shape, comm.size)
            mine.copy_(src if dim is None
                       else zero1.shard(src, dim, comm.rank, comm.size))
    state["step"] = full["step"].clone()
    acc = grads if comm.rank == 0 else tree_map(torch.zeros_like, grads)
    _, apply_step = make_accum_steps(
        cfg, Runtime(device="cpu", comm=comm), ocfg, guard=True)
    unsharded = tree_map(lambda p: p.clone(), params)
    _, _, om = apply_step(params, state, acc)
    out = f"apply/{dtype}"
    for key, v in bridge.params_to_flat(params).items():
        res[f"{out}/sharded/params/{key}"] = v
    for k in ("master", "m", "v"):
        gathered = []
        for mine, p in zip(leaves(state[k]), leaves(params)):
            dim = zero1.zero1_dim(p.shape, comm.size)
            if dim is None:
                gathered.append(mine)
                continue
            whole = torch.empty(p.shape, dtype=torch.float32)
            zero1.gather_leaf(whole, mine, dim, comm)
            gathered.append(whole)
        it = iter(gathered)
        for key, v in bridge.params_to_flat(
                tree_map(lambda _: next(it), params)).items():
            res[f"{out}/sharded/{k}/{key}"] = v
    res[f"{out}/sharded/om"] = np.array([float(om[k]) for k in sorted(om)])
    res[f"{out}/om_keys"] = np.array(sorted(om))
    if comm.rank == 0:
        _, apply_one = make_accum_steps(cfg, Runtime(device="cpu"), ocfg,
                                        guard=True)
        _, _, om1 = apply_one(unsharded, full, grads)
        for key, v in bridge.params_to_flat(unsharded).items():
            res[f"{out}/full/params/{key}"] = v
        for key, v in state_flat(full).items():
            res[f"{out}/full/{key}"] = v
        res[f"{out}/full/om"] = np.array([float(om1[k])
                                          for k in sorted(om1)])


def guard_check(comm, flat, res) -> None:
    """The nan_fault drill at hdp = 4: step 1's wave 0 has a NaN
    denominator on every rank; the guarded apply must skip on every rank
    and leave params and this rank's state shards unchanged bit for bit."""
    from repro_torch import bridge
    tr = trainer(comm, flat, "ref", nan_fault={"step": 1, "wave": 0})
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


def mismatch_check(comm, flat, res) -> None:
    """Rank 1 plans from another dataset seed: every rank must raise
    before the first wave."""
    tr = trainer(comm, flat, "ref", seed=1 if comm.rank == 1 else 0)
    try:
        tr.train_step()
        res["mismatch/error"] = ""
    except RuntimeError as e:
        res["mismatch/error"] = str(e)
    finally:
        tr.sched.stop()


def async_check(comm, flat, res) -> None:
    """Plans and waves from the planner thread (calibrate off) give the
    synchronous history; with calibrate on over several ranks the trainer
    refuses to start."""
    tr = trainer(comm, flat, "ref", sched_async=True)
    try:
        hist = [tr.train_step() for _ in range(2)]
    finally:
        tr.sched.stop()
    res["async/hist"] = np.array([[r["loss"], r["grad_norm"], r["waves"]]
                                  for r in hist])
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = config()
    sched = scheduler(cfg, sched_async=True)
    try:
        Trainer(cfg, Runtime(device="cpu", comm=comm), AdamWConfig(), sched,
                TrainerConfig(capacity=CAP, sched_async=True,
                              calibrate=True))
        res["async/calibrate_refused"] = ""
    except NotImplementedError as e:
        res["async/calibrate_refused"] = str(e)
    finally:
        sched.stop()


CKPT_RUNS = ("h2", "h1", "h4_from_h1")   # resumes held to the reference's


def resume_and_step(comm, ckpt_dir: str, res: dict, run: str) -> None:
    """A Trainer on ``comm``'s ranks (one if None) resumes ``ckpt_dir``
    and trains one step: its restored state shards, then the step's loss,
    grad norm and waves and the parameters after it."""
    from repro_torch import bridge
    tr = trainer(comm, None, "ref", ckpt_dir=ckpt_dir, ckpt_save=False)
    try:
        assert tr.resume_if_possible()
        res[f"ckpt/{run}/resumed_at"] = tr.step
        res[f"ckpt/{run}/opt_step"] = int(tr.opt_state["step"])
        for key, v in state_flat(tr.opt_state).items():
            res[f"ckpt/{run}/state/{key}"] = v
        rec = tr.train_step()
        for k in ("loss", "grad_norm", "waves"):
            res[f"ckpt/{run}/{k}"] = rec[k]
        for key, v in bridge.params_to_flat(tr.params).items():
            res[f"ckpt/{run}/after/{key}"] = v
    finally:
        tr.sched.stop()


def ckpt_check(comm, flat, res, out_dir: str) -> None:
    """Save at hdp = 4, restore at other sizes:

    1. every rank: hdp = 4, 2 steps, a checkpoint each (rank 0 writes
       ``ckpt4``); each rank's state shards and the save's numbers;
    2. ranks 0 and 1 resume ``ckpt4`` at hdp = 2 (a group of their own)
       and rank 2 at hdp = 1, each training one step; rank 3 trains 2
       steps at hdp = 1 and saves ``ckpt1``;
    3. every rank resumes ``ckpt1`` at hdp = 4 and trains one step;
    4. rank 1 resumes a directory holding only ``ckpt4``'s step 1, the
       others ``ckpt4`` (step 2): every rank must raise."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.comm import ProcessGroupComm
    ckpt4, ckpt1 = f"{out_dir}/ckpt4", f"{out_dir}/ckpt1"
    tr = trainer(comm, flat, "ref", ckpt_dir=ckpt4, ckpt_every=1)
    try:
        for _ in tr.run(2):
            pass
    finally:
        tr.sched.stop()
    for key, v in state_flat(tr.opt_state).items():
        res[f"ckpt/h4/state/{key}"] = v
    res["ckpt/h4/gathered_bytes"] = tr.ckpt_stats["gathered_bytes"]
    res["ckpt/h4/last_ckpt_step"] = tr.last_ckpt_step
    pair = dist.new_group([0, 1])
    if comm.rank in (0, 1):
        resume_and_step(ProcessGroupComm(pair), ckpt4, res, "h2")
    elif comm.rank == 2:
        resume_and_step(None, ckpt4, res, "h1")
    else:
        one = trainer(None, flat, "ref", ckpt_dir=ckpt1)
        try:
            for _ in one.run(2):
                pass
        finally:
            one.sched.stop()
    comm.all_gather(torch.zeros(1))     # ckpt1 is on disk
    resume_and_step(comm, ckpt1, res, "h4_from_h1")
    planted = f"{out_dir}/planted"
    if comm.rank == 1:
        os.makedirs(planted)
        shutil.copytree(f"{ckpt4}/step_1", f"{planted}/step_1")
    tr = trainer(comm, None, "ref", ckpt_save=False,
                 ckpt_dir=planted if comm.rank == 1 else ckpt4)
    try:
        tr.resume_if_possible()
        res["ckpt/planted/error"] = ""
    except RuntimeError as e:
        res["ckpt/planted/error"] = str(e)
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
    from repro_torch.parallel.comm import ProcessGroupComm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm = ProcessGroupComm()
        _wait_for(f"{out_dir}/jax_params.npz")
        flat = dict(np.load(f"{out_dir}/jax_params.npz"))
        res: dict = {}
        for impl in IMPLS:
            run_history(comm, flat, impl, res)
        _wait_for(f"{out_dir}/jax_params_offload.npz")
        flat_off = dict(np.load(f"{out_dir}/jax_params_offload.npz"))
        for impl in IMPLS:
            run_history(comm, flat_off, impl, res, offload=True)
        for dtype in APPLY_DTYPES:
            apply_check(comm, flat, dtype, res)
        guard_check(comm, flat, res)
        mismatch_check(comm, flat, res)
        async_check(comm, flat, res)
        ckpt_check(comm, flat, res, out_dir)
        np.savez(f"{out_dir}/torch_rank{rank}.npz",
                 **{k: np.asarray(v) for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def _ledger_rank_main(rank: int, out_dir: str) -> None:
    """The offload scenario alone, from seeded weights, both impls."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.comm import ProcessGroupComm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm = ProcessGroupComm()
        res: dict = {}
        for impl in IMPLS:
            run_history(comm, None, impl, res, offload=True)
        np.savez(f"{out_dir}/ledger_rank{rank}.npz",
                 **{k: np.asarray(v) for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    import torch.multiprocessing as mp
    rank_main = _rank_main
    if argv and argv[0] == "--ledger":
        rank_main, argv = _ledger_rank_main, argv[1:]
    (out_dir,) = argv
    mp.start_processes(rank_main, args=(out_dir,), nprocs=R, join=True,
                       start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    sys.exit(main(sys.argv[1:]))
