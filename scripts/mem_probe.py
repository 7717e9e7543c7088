"""Device memory of every rank of a `repro_torch.launch.train` run, step by
step:

    PYTHONPATH=<a checkout's src> python scripts/mem_probe.py OUT_DIR \\
        -- <launch.train arguments>

Runs the launcher as it is, with each spawned rank recording, at the end
of every step's backward (the entry of the optimizer apply, when the
step's gradients are held), the bytes the caching allocator has handed
out (``memory_allocated``) and holds (``memory_reserved``), and after
every step the run's peak allocation so far (the trainer's `PeakMeter`),
the largest reservation seen at those points, the allocator's retries
and out-of-memory count, and ``PYTORCH_CUDA_ALLOC_CONF``.  Rank r writes
``OUT_DIR/rank{r}.json`` after every record, so a run that fails keeps
what it saw up to then.  It needs only ``Trainer.apply_step``,
``Trainer.train_step``, ``Trainer.peak`` and ``launch.train._rank_main``,
so it measures older checkouts of the port as well.
"""
from __future__ import annotations

import json
import os
import sys


def _install(out_dir: str, rank: int) -> None:
    """Wraps the Trainer of this process so that it records (module
    docstring)."""
    import torch
    from repro_torch.train import trainer as T
    rows: list = []
    seen = {"reserved_max": 0}
    cuda = torch.cuda.is_available()     # on the CPU the plumbing only

    def mem():
        """(allocated, reserved) bytes, after the queued work."""
        if not cuda:
            return 0, 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    def dump():
        stats = torch.cuda.memory_stats() if cuda else {}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "steps": rows,
                       "reserved_max_gb": seen["reserved_max"] / 1e9,
                       "num_alloc_retries": stats.get("num_alloc_retries"),
                       "num_ooms": stats.get("num_ooms"),
                       "alloc_conf": os.environ.get(
                           "PYTORCH_CUDA_ALLOC_CONF")}, f)

    init, train_step = T.Trainer.__init__, T.Trainer.train_step

    def __init__(self, *a, **k):
        init(self, *a, **k)
        apply_step = self.apply_step

        def apply(params, state, acc):
            alloc, res = mem()
            seen["reserved_max"] = max(seen["reserved_max"], res)
            rows.append({"step": self.step + 1,
                         "allocated_end_of_backward_gb": alloc / 1e9,
                         "reserved_end_of_backward_gb": res / 1e9})
            dump()
            return apply_step(params, state, acc)
        self.apply_step = apply

    def step(self):
        rec = train_step(self)
        seen["reserved_max"] = max(seen["reserved_max"], mem()[1])
        rows[-1]["peak_allocated_gb"] = (self.peak.high_water() or 0) / 1e9
        dump()
        return rec

    T.Trainer.__init__, T.Trainer.train_step = __init__, step


def _probe_rank_main(rank: int, *args) -> None:
    """A spawned rank: the probe, then the launcher's own rank body."""
    _install(os.environ["MEM_PROBE_OUT"], rank)
    from repro_torch.launch import train as L
    L._rank_main(rank, *args)


def main(argv) -> int:
    if "--" not in argv or argv.index("--") != 1:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, launch_args = argv[0], argv[2:]
    os.makedirs(out_dir, exist_ok=True)
    os.environ["MEM_PROBE_OUT"] = os.path.abspath(out_dir)
    from repro_torch.launch import train as L
    L._rank_main = _probe_rank_main     # what L.main hands to the ranks
    L.main(launch_args)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
