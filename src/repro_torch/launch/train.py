"""Training launcher of the port, one process on one device:

    python -m repro_torch.launch.train --arch llama3.2-3b [--reduced] \\
        --steps N --capacity C --tokens-per-step N --context L \\
        --dataset D --strategy S --lr X --attn-impl {flash,ref} \\
        [--device cpu]

Port of `repro/launch/train.py`'s single-process path (hdp = 1, mode
``dp``, no PP, no TP, no offload).  Runs on ``cuda`` unless ``--device
cpu`` is given, and refuses to start without a GPU otherwise.  Prints one
line per step, as the reference does.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_config
from repro_torch.data.distribution import DISTRIBUTIONS, LengthDistribution
from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import Runtime
from repro_torch.train.trainer import Trainer, TrainerConfig


def _resolve_config(args):
    """The model config (with the --reduced clamps applied to args in
    place) plus the synthetic dataset for the requested distribution."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        args.capacity = min(args.capacity, 512)
        args.tokens_per_step = min(args.tokens_per_step, 8192)
        args.context = min(args.context, 2048)
    dist = DISTRIBUTIONS.get(args.dataset) or \
        LengthDistribution("tiny", 4.5, 0.8, 0.1, 1.5, 256)
    ds = SyntheticDataset(dist, cfg.vocab_size, args.tokens_per_step,
                          args.context)
    return cfg, ds


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
    ap.add_argument("--device", default=None,
                    help="default cuda; pass cpu to run on the CPU")
    args = ap.parse_args(argv)

    rt = Runtime(device=args.device, attn_impl=args.attn_impl)
    cfg, ds = _resolve_config(args)
    sched = GlobalScheduler(ds, cfg, capacity=args.capacity, hdp=1,
                            strategy=args.strategy, use_offload=False)
    try:
        trainer = Trainer(cfg, rt, AdamWConfig(lr=args.lr,
                                               total_steps=args.steps),
                          sched, TrainerConfig(capacity=args.capacity))
        for rec in trainer.run(args.steps):
            print(f"step {rec['step']:4d} loss {rec['loss']:.4f} "
                  f"waves {rec['waves']} wall {rec['wall_s']:.1f}s",
                  flush=True)
    finally:
        sched.stop()      # the planner thread must not outlive the loop
    return trainer


if __name__ == "__main__":
    main()
