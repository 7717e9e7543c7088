"""Training launcher of the port:

    python -m repro_torch.launch.train --arch llama3.2-3b [--reduced] \\
        --steps N --capacity C --tokens-per-step N --context L \\
        --dataset D --strategy S --lr X --attn-impl {flash,ref} \\
        [--offload] [--mesh NxM] [--ckpt-dir D] [--layers N] [--device cpu]

Port of `repro/launch/train.py` (mode ``dp``, no PP).  Runs on ``cuda``
unless ``--device cpu`` is given, and refuses to start without a GPU
otherwise.  Prints one line per step, as the reference does.
``--offload`` (off by default, as the reference launcher runs) plans with
Eq. 3's offload term and runs the offloading waves' leading layer periods
with their residuals in pinned host memory (``TrainerConfig.use_offload``).
The bytes ledger (`obs/ledger.py`) is on while ``train`` runs.

``--mesh Nx1`` (the reference's ``--mesh``) trains on N HDP ranks, one
process each: one per card over NCCL (``torch.cuda.set_device(rank)``
before ``init_process_group``), or over gloo with ``--device cpu``.  The
kernels are built once here, before the ranks are spawned; the optimiser
state is sharded by ZeRO-1 over the ranks.  Rank 0 prints the step lines
and, last, one JSON line: per step loss, grad norm, wall and trained
tokens/s; each wave's composition, c_mult, offload ratio r and offloaded
periods k; ms per warm wave by composition (the slowest rank's); every
rank's peak device memory; the pinned host memory the offload buffers
hold; the ZeRO-1 bytes of a step; the ledger's
totals (predicted and measured ring and offload bytes, predicted and
measured peak memory); the step it resumed at, the checkpoint's seconds
(gather, snapshot, write, hash, restore) and bytes, and rank 0's peak
host memory.  M > 1 (tensor parallelism) is not ported.

``--layers N`` cuts the model's depth to N layers at its full width (a
measurement aid, as ``chip_smoke.py`` cuts depth: Mistral-8x7B's 46.7 G
parameters do not fit four cards under ZeRO-1, 4 of its 32 layers do).

``--ckpt-dir D`` (the reference's) checkpoints into D every 5 steps and
after the last, and first resumes from the newest valid checkpoint in D,
printing "resumed at step N"; ``--steps`` is the step to reach, as in
the reference.  A checkpoint holds the ZeRO-1 state whole, so a run
written at ``--mesh 4x1`` resumes at ``--mesh 2x1`` or ``1x1``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import subprocess
import tempfile
from collections import defaultdict

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.offload import offload_periods
from repro_torch.data.distribution import DISTRIBUTIONS, LengthDistribution
from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
from repro_torch.obs import ledger
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import Runtime
from repro_torch.parallel.zero1 import zero1_bytes
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves


def _resolve_config(args):
    """The model config (with the --reduced clamps applied to args in
    place) plus the synthetic dataset for the requested distribution."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        args.capacity = min(args.capacity, 512)
        args.tokens_per_step = min(args.tokens_per_step, 8192)
        args.context = min(args.context, 2048)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dist = DISTRIBUTIONS.get(args.dataset) or \
        LengthDistribution("tiny", 4.5, 0.8, 0.1, 1.5, 256)
    ds = SyntheticDataset(dist, cfg.vocab_size, args.tokens_per_step,
                          args.context)
    return cfg, ds


def _mesh(text: str):
    try:
        hdp, tp = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected NxM, e.g. 4x1") from None
    if hdp < 1 or tp < 1:
        raise ValueError(f"--mesh {text!r}: both sizes must be >= 1")
    if tp > 1:
        raise NotImplementedError(
            f"--mesh {text}: tensor parallelism (M > 1) comes with ROADMAP "
            f"queue 1 item 7")
    return hdp


def train(args, comm=None, say=print):
    """Builds the trainer on ``comm``'s ranks (None: one) and runs
    ``args.steps`` steps -> (trainer, every dispatched wave as
    (composition, fresh, per-rank seconds, (c_mult, r, k)), this rank's
    peak device memory in bytes (None on the CPU))."""
    rt = Runtime(device=args.device, attn_impl=args.attn_impl, comm=comm)
    cfg, ds = _resolve_config(args)
    sched = GlobalScheduler(ds, cfg, capacity=args.capacity,
                            hdp=rt.hdp_size, strategy=args.strategy,
                            use_offload=args.offload)
    waves, step_waves = [], []
    was_on = ledger.ledger_enabled()
    ledger.set_ledger_enabled(True)
    try:
        trainer = Trainer(cfg, rt, AdamWConfig(lr=args.lr,
                                               total_steps=args.steps),
                          sched, TrainerConfig(capacity=args.capacity,
                                               use_offload=args.offload,
                                               ckpt_dir=args.ckpt_dir))
        if args.ckpt_dir and trainer.resume_if_possible():
            say(f"resumed at step {trainer.step}", flush=True)
        if args.steps <= trainer.step:
            raise ValueError(f"--steps {args.steps}: the checkpoint is at "
                             f"step {trainer.step} already")

        def telemetry(ws, measured, fresh, wall_s=None):
            w = ws[0]
            k = offload_periods(cfg, w.offload_ratio) \
                if trainer.offload_ok else 0
            step_waves.append((str(tuple(w.composition)), fresh,
                               (w.c_mult, w.offload_ratio, k)))
        trainer.telemetry_fn = telemetry
        for rec in trainer.run(args.steps - trainer.step):
            secs = trainer.last_numerics["wave_seconds"]
            waves += [(comp, fresh, np.atleast_1d(s).tolist(), key)
                      for (comp, fresh, key), s in zip(step_waves, secs)]
            step_waves.clear()
            say(f"step {rec['step']:4d} loss {rec['loss']:.4f} "
                f"waves {rec['waves']} wall {rec['wall_s']:.1f}s",
                flush=True)
    finally:
        sched.stop()      # the planner thread must not outlive the loop
        ledger.set_ledger_enabled(was_on)
    return trainer, waves, trainer.peak.high_water()


def summary(args, trainer, waves, peaks) -> dict:
    """The run's JSON record (see the module docstring)."""
    by_comp = defaultdict(list)
    for comp, fresh, secs, (c_mult, _, _) in waves:
        if not fresh:
            by_comp[f"{comp} x{c_mult}"].append(max(secs) * 1e3)
    hdp = trainer.rt.hdp_size
    led = trainer.ledger.summary()
    totals = trainer.ledger.totals
    return {
        "arch": args.arch, "reduced": args.reduced, "mesh": f"{hdp}x1",
        "layers": trainer.cfg.num_layers,
        "device": str(trainer.rt.device),
        "params_b": sum(p.numel() for p in leaves(trainer.params)) / 1e9,
        "steps": [{**{k: r[k] for k in ("step", "loss", "grad_norm",
                                        "waves", "tokens", "wall_s")},
                   "tokens_per_s": r["tokens"] / r["wall_s"]}
                  for r in trainer.history],
        "warm_ms_per_wave_by_composition_x_c_mult": {
            k: float(np.mean(v)) for k, v in sorted(by_comp.items())},
        "warm_waves_by_composition_x_c_mult": {
            k: len(v) for k, v in sorted(by_comp.items())},
        "waves": [{"composition": comp, "c_mult": c_mult, "r": r, "k": k}
                  for comp, _, _, (c_mult, r, k) in waves],
        "offload": bool(trainer.offload_ok),
        "pinned_host_gb": trainer.offload_store.pinned_bytes / 1e9
        if trainer.offload_store is not None else 0.0,
        "peak_mem_gb_by_rank": peaks,
        "zero1_bytes": zero1_bytes(trainer.params, hdp),
        "resumed_at": trainer.ckpt_stats.get("resumed_at"),
        "ckpt": trainer.ckpt_stats,
        "host_peak_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "ledger": {"pred": totals["pred"], "meas": totals["meas"],
                   "hbm_pred_peak_gb": led["hbm_pred_peak"] / 1e9,
                   "hbm_meas_peak_gb": led["hbm_meas_peak"] / 1e9,
                   "comm_residual": led["comm_residual"],
                   "dispatches": led["n"]}}


def _rank_main(rank: int, hdp: int, args, store: str) -> None:
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel.comm import ProcessGroupComm
    cuda = args.device is None or args.device.startswith("cuda")
    if cuda:
        torch.cuda.set_device(rank)
        args.device = f"cuda:{rank}"
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // hdp))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", world_size=hdp,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        comm = ProcessGroupComm()
        say = print if rank == 0 else (lambda *a, **k: None)
        trainer, waves, peak = train(args, comm, say)
        peak = torch.tensor([peak / 1e9 if cuda else float("nan")],
                            dtype=torch.float64, device=comm.device)
        peaks = comm.all_gather(peak).flatten().tolist()
        if rank == 0:
            print(json.dumps(summary(args, trainer, waves,
                                     peaks if cuda else None)), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--capacity", type=int, default=8192)
    ap.add_argument("--tokens-per-step", type=int, default=65_536)
    ap.add_argument("--context", type=int, default=32_768)
    ap.add_argument("--dataset", default="github",
                    choices=list(DISTRIBUTIONS) + ["tiny"])
    ap.add_argument("--strategy", default="balance",
                    choices=["static", "naive", "balance"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--attn-impl", default="flash", choices=["flash", "ref"],
                    help="attention and cross-entropy backend: the "
                         "hand-written kernels (flash; their plain versions "
                         "on the CPU) or the plain oracle (ref)")
    ap.add_argument("--offload", action="store_true",
                    help="selective activation offload (Eq. 3 plans, the "
                         "leading periods' residuals in pinned host memory)")
    ap.add_argument("--mesh", default="1x1",
                    help="NxM: N HDP ranks, one process each (M, tensor "
                         "parallelism, must be 1)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its newest "
                         "valid checkpoint, save every 5 steps and at the "
                         "end")
    ap.add_argument("--layers", type=int, default=0,
                    help="a measurement aid: cut the depth to N layers at "
                         "full width (0: the config's depth)")
    ap.add_argument("--device", default=None,
                    help="default cuda; pass cpu to run on the CPU")
    args = ap.parse_args(argv)
    hdp = _mesh(args.mesh)
    if hdp == 1:
        return train(args)[0]

    import torch.multiprocessing as mp
    if args.device is None or args.device.startswith("cuda"):
        if torch.cuda.device_count() < hdp:
            raise RuntimeError(f"--mesh {args.mesh} needs {hdp} CUDA "
                               f"devices, found {torch.cuda.device_count()}")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        from repro_torch.kernels import build
        build.build_all(["flash_fwd", "flash_bwd", "fused_ce"])   # once
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        mp.start_processes(_rank_main, args=(hdp, args,
                                             os.path.join(tmp, "store")),
                           nprocs=hdp, join=True, start_method="spawn")
    return None


if __name__ == "__main__":
    main()
