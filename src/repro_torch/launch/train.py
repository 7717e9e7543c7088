"""Training launcher of the port:

    python -m repro_torch.launch.train --arch llama3.2-3b [--reduced] \\
        --steps N --capacity C --tokens-per-step N --context L \\
        --dataset D --strategy S --lr X --attn-impl {flash,ref} \\
        [--offload] [--mesh NxM] [--num-stages S] [--max-round-waves M] \\
        [--ckpt-dir D] [--layers N] [--device cpu]

Port of `repro/launch/train.py`.  Runs on ``cuda``
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
host memory.

``--mesh NxM`` with M > 1 trains the attention decoders (dense, MoE,
MLA, Gemma-style) and RWKV-6 with tensor parallelism on N·M ranks: world
rank h·M + m is HDP position h, model rank m (the reference's ``("data",
"model")`` mesh); each rank holds its model rank's slices of the split
leaves (an MoE's experts E/M a rank: expert parallelism,
`models/moe.py`; RWKV-6's WKV heads H/M a rank) and ZeRO-1 shards over
the HDP group of its model rank.  It combines with ``--offload`` (each
model rank offloads its own copy of the residual) and with
``--num-stages``.  A checkpoint keeps the global layout, so a run written
at ``--mesh 2x2`` resumes at ``--mesh 4x1`` where the two layouts pad the
heads alike.

``--num-stages S`` (the reference dry-run's flag; its launcher reads a
three-number ``--mesh`` as pod × data × model and never builds a stage
axis) trains with pipeline parallelism on S·N·M ranks: world rank
s·(N·M) + h·M + m is stage s, HDP position h, model rank m
(`parallel/comm.py::grid`, the reference's ``("stage", "data",
"model")`` mesh), the plans are PP-Balance's (``mode="pp"``,
``num_stages=S``) and the waves run as rounds of at most
``--max-round-waves`` (0: no cap) through `parallel/pipeline.py`.  The
JSON line then also holds, per stage:
tokens/s, the slowest rank's ms a warm round, the measured bubble share
1 − Σ busy / (ranks × wall) over the warm rounds (busy: the stage's
compute between its transfers; wall: the slowest rank's round), the
peaks, and beside them the analytic `pipeline_schedule_stats` bubble
share of each step and the ledger's ``pp`` bytes.

``--layers N`` cuts the model's depth to N layers at its full width (a
measurement aid, as ``chip_smoke.py`` cuts depth: Mistral-8x7B's 46.7 G
parameters do not fit four cards under ZeRO-1, 4 of its 32 layers do).

On CUDA the launcher sets ``PYTORCH_CUDA_ALLOC_CONF`` to
``expandable_segments:True`` before CUDA starts in any rank, unless the
user has set it: without it Mistral-8x7B at 4 layers at ``--mesh 4x1``
on 80 GB H100s can run out of memory in a backward with 11.79 GiB of
the card reserved by the caching allocator but free in segments too
small for the 3.50 GiB it asks for; with it the run trains at the same
peak allocation (70.34 GB a rank).  The JSON line gives the setting the
run had.

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
import sys
import tempfile
import traceback
from collections import defaultdict

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import check_supported
from repro_torch.core.offload import offload_periods
from repro_torch.data.distribution import DISTRIBUTIONS, LengthDistribution
from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
from repro_torch.obs import ledger
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import Runtime
from repro_torch.parallel.zero1 import stage_taken, zero1_bytes
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
    """``NxM`` -> (N HDP ranks, M model ranks)."""
    try:
        hdp, tp = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected NxM, e.g. 4x1") from None
    if hdp < 1 or tp < 1:
        raise ValueError(f"--mesh {text!r}: both sizes must be >= 1")
    return hdp, tp


def train(args, comm=None, say=print, stage_comm=None, tp_comm=None):
    """Builds the trainer on ``comm``'s HDP ranks (None: one), under PP
    ``stage_comm``'s stages and under TP ``tp_comm``'s model ranks, and
    runs ``args.steps`` steps ->
    (trainer, every dispatch (a wave, or under PP a round) as
    (composition, fresh, per-rank seconds, (c_mult, r, k)), this rank's
    peak device memory in bytes (None on the CPU), (this rank's step
    walls, under PP its (seconds, busy seconds, fresh) of every round))."""
    rt = Runtime(device=args.device, attn_impl=args.attn_impl, comm=comm,
                 stage_comm=stage_comm, tp_comm=tp_comm)
    cfg, ds = _resolve_config(args)
    stages = rt.num_stages
    sched = GlobalScheduler(ds, cfg, capacity=args.capacity,
                            hdp=rt.hdp_size, strategy=args.strategy,
                            use_offload=args.offload,
                            mode="pp" if stages > 1 else "dp",
                            num_stages=stages)
    waves, step_waves, rounds = [], [], []
    was_on = ledger.ledger_enabled()
    ledger.set_ledger_enabled(True)
    try:
        trainer = Trainer(cfg, rt, AdamWConfig(lr=args.lr,
                                               total_steps=args.steps),
                          sched, TrainerConfig(
                              capacity=args.capacity,
                              use_offload=args.offload,
                              ckpt_dir=args.ckpt_dir,
                              mode="pp" if stages > 1 else "dp",
                              max_round_waves=args.max_round_waves))
        if args.ckpt_dir and trainer.resume_if_possible():
            say(f"resumed at step {trainer.step}", flush=True)
        if args.steps <= trainer.step:
            raise ValueError(f"--steps {args.steps}: the checkpoint is at "
                             f"step {trainer.step} already")

        def telemetry(ws, measured, fresh, wall_s=None):
            w = ws[0]
            r = max(x.offload_ratio for x in ws)
            k = offload_periods(cfg, r, stages) if trainer.offload_ok else 0
            step_waves.append((str(tuple(w.composition)), fresh,
                               (w.c_mult, r, k)))
        trainer.telemetry_fn = telemetry
        for rec in trainer.run(args.steps - trainer.step):
            nu = trainer.last_numerics
            waves += [(comp, fresh, np.atleast_1d(s).tolist(), key)
                      for (comp, fresh, key), s in zip(step_waves,
                                                       nu["wave_seconds"])]
            if stages > 1:
                rounds += [(s, b, fresh) for s, b, (_, fresh, _) in zip(
                    nu["round_seconds"], nu["round_busy_s"], step_waves)]
            step_waves.clear()
            say(f"step {rec['step']:4d} loss {rec['loss']:.4f} "
                f"waves {rec['waves']} wall {rec['wall_s']:.1f}s",
                flush=True)
    finally:
        sched.stop()      # the planner thread must not outlive the loop
        ledger.set_ledger_enabled(was_on)
    return trainer, waves, trainer.peak.high_water(), \
        ([r["wall_s"] for r in trainer.history], rounds)


def stage_summary(trainer, peaks, ranks) -> dict:
    """The per-stage numbers of a pipelined run (module docstring) from
    every rank's (its step walls, its ``(seconds, busy seconds, fresh)``
    of each round) (``ranks``, world order) and peaks (GB, None on the
    CPU).  Tokens/s counts the steps after the first (which builds the
    kernels), over the stage's slowest rank's step walls; a stage's ranks
    are its HDP positions times its model ranks."""
    stages = trainer.rt.num_stages
    n = trainer.rt.hdp_size * trainer.rt.tp       # ranks a stage
    walls = np.array([w for w, _ in ranks])               # [world, steps]
    secs = np.array([[s for s, _, _ in r] for _, r in ranks])
    busy = np.array([[b for _, b, _ in r] for _, r in ranks])
    warm = np.array([not f for _, _, f in ranks[0][1]])
    wall = secs[:, warm].max(axis=0)          # the slowest rank's round
    later = slice(1 if walls.shape[1] > 1 else 0, None)
    tokens = sum(r["tokens"] for r in trainer.history[later])
    out = {}
    for s in range(stages):
        rows = slice(s * n, (s + 1) * n)
        out[str(s)] = {
            "tokens_per_s": tokens
            / float(walls[rows, later].max(axis=0).sum()),
            "ms_per_warm_round": (secs[rows][:, warm].max(axis=0)
                                  * 1e3).tolist(),
            "bubble_measured": 1.0 - float(busy[rows][:, warm].sum())
            / (n * float(wall.sum())) if warm.any() else None,
            "peak_mem_gb": None if peaks is None else peaks[rows]}
    return {"by_stage": out,
            "bubble_measured": 1.0 - float(busy[:, warm].sum())
            / (stages * n * float(wall.sum())) if warm.any() else None,
            "bubble_analytic_by_step": [r["bubble_frac_pipeline"]
                                        for r in trainer.history],
            "rounds_by_step": [r["rounds"] for r in trainer.history]}


def summary(args, trainer, waves, peaks, ranks=None) -> dict:
    """The run's JSON record (see the module docstring); ``ranks``: under
    PP every rank's rounds (`stage_summary`)."""
    by_comp = defaultdict(list)
    for comp, fresh, secs, (c_mult, _, _) in waves:
        if not fresh:
            by_comp[f"{comp} x{c_mult}"].append(max(secs) * 1e3)
    hdp, tp = trainer.rt.hdp_size, trainer.rt.tp
    led = trainer.ledger.summary()
    totals = trainer.ledger.totals
    out = {
        "arch": args.arch, "reduced": args.reduced, "mesh": f"{hdp}x{tp}",
        "num_stages": trainer.rt.num_stages,
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
        "cuda_alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
        # under TP the reference Trainer's: the global tree, no specs
        "zero1_bytes": zero1_bytes(trainer.params, hdp,
                                   stage_taken(trainer.params,
                                               trainer.rt.num_stages))
        if tp == 1 else zero1_bytes(trainer._global_meta(), hdp),
        "resumed_at": trainer.ckpt_stats.get("resumed_at"),
        "ckpt": trainer.ckpt_stats,
        "host_peak_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "ledger": {"pred": totals["pred"], "meas": totals["meas"],
                   "hbm_pred_peak_gb": led["hbm_pred_peak"] / 1e9,
                   "hbm_meas_peak_gb": led["hbm_meas_peak"] / 1e9,
                   "comm_residual": led["comm_residual"],
                   "dispatches": led["n"]}}
    if ranks is not None:
        out["pipeline"] = stage_summary(trainer, peaks, ranks)
    return out


def _rank_main(rank: int, hdp: int, stages: int, args, store: str,
               tp: int = 1) -> None:
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel.comm import grid
    cuda = args.device is None or args.device.startswith("cuda")
    world = hdp * stages * tp
    if cuda:
        torch.cuda.set_device(rank)
        args.device = f"cuda:{rank}"
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        comm, stage_comm, tp_comm = grid(stages, hdp, tp)
        say = print if rank == 0 else (lambda *a, **k: None)
        trainer, waves, peak, rounds = train(args, comm, say, stage_comm,
                                             tp_comm)
        got = [None] * world
        dist.all_gather_object(got, (peak / 1e9 if cuda else None, rounds))
        peaks = [p for p, _ in got] if cuda else None
        if rank == 0:
            print(json.dumps(summary(args, trainer, waves, peaks,
                                     [r for _, r in got]
                                     if stages > 1 else None)), flush=True)
        dist.barrier()
    except BaseException:
        # a failed rank leaves without tearing its group down, which
        # blocks while the other ranks wait in a collective; its exit
        # makes `mp.start_processes` end the others
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
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
                    help="NxM: N HDP ranks x M model ranks (tensor "
                         "parallelism), one process each")
    ap.add_argument("--num-stages", type=int, default=1,
                    help="pipeline stages S: S x N ranks, PP-Balance plans "
                         "run as rounds through the stages")
    ap.add_argument("--max-round-waves", type=int, default=0,
                    help="pipelined executor: cap waves per round (0 = "
                         "uncapped) to bound in-flight activation memory")
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
    hdp, tp = _mesh(args.mesh)
    stages = args.num_stages
    if stages < 1:
        raise ValueError(f"--num-stages {stages}: must be >= 1")
    cfg = get_config(args.arch)          # its refusals, before any rank
    check_supported(cfg.reduced() if args.reduced else cfg, tp)
    if args.device is None or args.device.startswith("cuda"):
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    world = hdp * stages * tp
    if world == 1:
        return train(args)[0]

    import torch.multiprocessing as mp
    if args.device is None or args.device.startswith("cuda"):
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"--mesh {args.mesh} --num-stages {stages} "
                               f"needs {world} CUDA devices, found "
                               f"{torch.cuda.device_count()}")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        from repro_torch.kernels import build
        build.build_all(["flash_fwd", "flash_bwd", "fused_ce"])   # once
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        mp.start_processes(_rank_main, args=(hdp, stages, args,
                                             os.path.join(tmp, "store"), tp),
                           nprocs=world, join=True, start_method="spawn")
    return None


if __name__ == "__main__":
    main()
