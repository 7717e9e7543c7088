"""Where a training step's time goes on the card: steps of llama3.2-3b at
full width and depth through `Trainer.train_step`, one under
`torch.profiler`.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        [--arch mistral-8x7b --layers 2]

The configuration of `chip_smoke.py`'s train phase: random weights from
seed 0 in bf16, github lengths, 16384 tokens per step, context and wave
capacity 4096, strategy balance, AdamW lr 3e-4.  Runs a cold step (kernel
build, first-use costs), a warm step, and a warm step under the profiler.
Prints the card, each step's waves and wall time, the device-busy share of
the profiled step, and its kernels by total device time, grouped into
families.  ``--arch`` profiles another registered model and ``--layers
N`` cuts its depth at full width (a measurement aid: Mistral-8x7B's
state fits one card at 2 layers).  Raises without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from collections import defaultdict

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
from repro_torch.launch.profile_serve import family
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import Runtime
from repro_torch.train.trainer import Trainer, TrainerConfig


def timed_step(tr) -> dict:
    t0 = time.perf_counter()
    rec = tr.train_step()
    torch.cuda.synchronize()
    return {"waves": rec["waves"], "loss": rec["loss"],
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--layers", type=int, default=0,
                    help="a measurement aid: cut the depth to N layers at "
                         "full width (0: the config's depth)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    ds = SyntheticDataset("github", cfg.vocab_size, tokens_per_step=16384,
                          context=4096)
    sched = GlobalScheduler(ds, cfg, capacity=4096, hdp=1,
                            strategy="balance", use_offload=False)
    tr = Trainer(cfg, Runtime(device="cuda"),
                 AdamWConfig(lr=3e-4, warmup_steps=0), sched,
                 TrainerConfig(capacity=4096))
    try:
        cold = timed_step(tr)
        warm = timed_step(tr)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            prof_step = timed_step(tr)
    finally:
        sched.stop()
    # device-side events only (kernels, copies): the host operators that
    # launched them carry the same time again
    by_name = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] += evt.self_device_time_total
    device_ms = sum(by_name.values()) / 1e3
    fams = defaultdict(float)
    for name, us in by_name.items():
        fams[family(name)] += us / 1e3
    print(card)
    print(json.dumps({"arch": cfg.name, "layers": cfg.num_layers,
                      "cold": cold, "warm": warm,
                      "profiled": prof_step,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    wall_ms = prof_step["wall_s"] * 1e3
    print(json.dumps({"profiled_wall_ms": wall_ms,
                      "device_busy_ms": device_ms,
                      "device_busy_share": device_ms / wall_ms,
                      "families_ms": dict(sorted(fams.items(),
                                                 key=lambda kv: -kv[1]))}))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{us / 1e3:10.2f} ms  {family(name):34s} {name[:80]}")


if __name__ == "__main__":
    main()
