"""The port's side of `tests/test_torch_rwkv.py` on 4 gloo ranks (one
process each): reduced rwkv6-7b in float32 with a sequence sharded over
HDP ranks, written to npz for the test to hold against hdp = 1 and the
reference.

    python tests/_torch_rwkv_worker.py OUT_DIR

Imports torch and the port only (no JAX), so the spawned ranks start
light.  The ranks wait for the reference's initial parameters
(``OUT_DIR/jax_params.npz``, written by the test before anything else)
and then run, in order:

* every wave of `WAVES`: the forward logits of this rank's rows, its loss
  share and its gradients, and the measured ``"ring"`` bytes of the
  forward (the bytes ledger on).  The hdp = 4 waves run on the world, the
  hdp = 2 ones on the groups {0, 1} and {2, 3} side by side;
* 2 `Trainer` steps at hdp = 2 on the group {0, 1}: the losses and the
  parameters after each step;
* on the group {2, 3}, teacher-forced decode at hdp = 2 under the
  ``"batch"`` slab (`DECODE_SLOTS["batch"]` slots) and the ``"seq"`` slab:
  every step's logits.

Each rank writes ``OUT_DIR/torch_rank{r}.npz``.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import time

import numpy as np

R = 4                               # ranks
C = 64                              # tokens a rank (a multiple of the
                                    # reduced chunk 16)
ARCH = "rwkv6-7b"
# name -> (composition, per rank its pieces (sequence id, start, end)):
# "flush" waves' pieces fill their ranks' buffers; "ragged" ones are laid
# as the planner lays a sequence over g ranks (ceil(len / g) tokens a
# rank, each piece at the start of its buffer, padding after it)
WAVES = {
    "4-flush": ((4,), [[(1, 0, 64)], [(1, 64, 128)], [(1, 128, 192)],
                       [(1, 192, 256)]]),
    "4-ragged": ((4,), [[(1, 0, 50)], [(1, 50, 100)], [(1, 100, 150)],
                        [(1, 150, 200)]]),
    "121-ragged": ((1, 2, 1), [[(2, 0, 40), (3, 0, 20)], [(1, 0, 55)],
                               [(1, 55, 110)], [(4, 0, 64)]]),
    "121-flush": ((1, 2, 1), [[(2, 0, 30)], [(1, 0, 64)], [(1, 64, 128)],
                              [(3, 0, 50)]]),
    "2-flush": ((2,), [[(1, 0, 64)], [(1, 64, 128)]]),
    "2-ragged": ((2,), [[(1, 0, 45)], [(1, 45, 90)]]),
}
PAIRS = ("2-flush", "2-ragged")     # on the groups {0, 1} and {2, 3}
# the Trainer at hdp = 2 (and its references at hdp = 1)
TRAIN_CAP, TRAIN_TOKENS, TRAIN_CONTEXT = 128, 512, 256
DIST = ("tiny", 4.5, 0.8, 0.1, 1.5, 256)      # tests/test_system.py
STEPS, LR, TOTAL_STEPS = 2, 1e-3, 8
DECODE_LEN = 12                     # teacher-forced tokens a slot
DECODE_SLOTS = {"batch": 4, "seq": 3}


def config(dtype: str = "float32"):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)


def seq_tokens(seq: int, vocab: int) -> np.ndarray:
    """Sequence ``seq``'s tokens (its labels are the next ones)."""
    return np.random.RandomState(100 + seq).randint(0, vocab, 300).astype(
        np.int32)


def wave_batch(name: str, vocab: int) -> dict:
    """The global buffers of wave ``name`` ([g·C] each, rank r at rows
    [r·C, (r+1)·C)), as `data.loader.WaveMaterializer` lays them."""
    _, slots = WAVES[name]
    t = len(slots) * C
    out = {k: np.zeros(t, np.int32) for k in ("tokens", "labels", "seg",
                                              "pos")}
    for r, slot in enumerate(slots):
        cur = r * C
        for sid, a, b in slot:
            toks = seq_tokens(sid, vocab)
            n = b - a
            out["tokens"][cur:cur + n] = toks[a:b]
            out["labels"][cur:cur + n] = toks[a + 1:b + 1]
            out["seg"][cur:cur + n] = sid
            out["pos"][cur:cur + n] = np.arange(a, b)
            cur += n
    return out


def compacted(batch: dict, length: int = R * C) -> tuple:
    """The same tokens in one buffer of ``length`` rows with every
    sequence contiguous: the valid rows in rank order, the padding at the
    end -> (batch, the rows of ``batch`` that are valid, in that order)."""
    valid = np.flatnonzero(batch["seg"] > 0)
    out = {k: np.zeros(length, v.dtype) for k, v in batch.items()}
    for k, v in batch.items():
        out[k][:len(valid)] = v[valid]
    return out, valid


def _wait_for(path: str, timeout: float = 300.0) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.05)


def wave_grads(params, cfg, comm, comp, batch, sl: slice, tag: str,
               res: dict) -> None:
    """Rows ``sl`` of one wave (this rank's): logits, loss share,
    gradients and the forward's measured ring bytes -> ``res[tag/...]``."""
    import torch
    from repro_torch import bridge
    from repro_torch.obs import ledger
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.models.transformer import forward_hidden, logits_head
    from repro_torch.train.train_step import loss_fn
    from repro_torch.tree import leaves, tree_map
    rt = Runtime(device="cpu", comm=comm, composition=comp)
    b = {k: torch.tensor(v[sl]) for k, v in batch.items()}
    b["denom"] = torch.tensor(float((batch["seg"] > 0).sum()))
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    ledger.set_ledger_enabled(True)
    with ledger.capture() as tally:
        loss, _ = loss_fn(live, cfg, rt, b)
    with ledger.paused():
        grads = torch.autograd.grad(loss, leaves(live))
    with torch.no_grad():
        logits = logits_head(params, cfg, forward_hidden(params, cfg, rt, b))
    it = iter(grads)
    for key, g in bridge.params_to_flat(tree_map(lambda _: next(it),
                                                 params)).items():
        res[f"{tag}/grad/{key}"] = g
    res[f"{tag}/loss"] = np.float64(loss.item())
    res[f"{tag}/logits"] = logits.numpy()
    res[f"{tag}/ring_bytes"] = np.float64(tally.get("ring", 0.0))


def train_steps(comm, flat, res: dict):
    """STEPS `Trainer` steps of the planner's plans at ``comm``'s size
    from the reference's parameters: the losses, the parameters after
    each step and the count of sharded pieces shorter than their rank's
    buffer -> ``res``; returns the trainer."""
    from repro_torch import bridge
    from repro_torch.data.distribution import LengthDistribution
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = config()
    hdp = 1 if comm is None else comm.size
    ds = SyntheticDataset(LengthDistribution(*DIST), cfg.vocab_size,
                          tokens_per_step=TRAIN_TOKENS,
                          context=TRAIN_CONTEXT)
    sched = GlobalScheduler(ds, cfg, capacity=TRAIN_CAP, hdp=hdp,
                            use_offload=False)
    plan_step = sched.plan_step
    res["train/sharded_ragged"] = 0

    def recorded(step):
        plan = plan_step(step)
        for w in plan.waves:
            c = TRAIN_CAP * w.c_mult
            res["train/sharded_ragged"] += sum(
                sum(p.length for p in slot) < c
                for slot, g in zip(w.slots, _group_sizes(w.composition))
                if g > 1)
        return plan
    sched.plan_step = recorded
    tr = Trainer(cfg, Runtime(device="cpu", comm=comm),
                 AdamWConfig(lr=LR, total_steps=TOTAL_STEPS), sched,
                 TrainerConfig(capacity=TRAIN_CAP, calibrate=False),
                 params=bridge.params_from_flat(flat, cfg, "cpu"))
    try:
        for s in range(STEPS):
            rec = tr.train_step()
            res.setdefault("train/loss", []).append(rec["loss"])
            res.setdefault("train/applied", []).append(
                tr.last_numerics["applied"])
            for key, v in bridge.params_to_flat(tr.params).items():
                res[f"train/p{s + 1}/{key}"] = v
    finally:
        sched.stop()
    return tr


def _group_sizes(composition) -> list:
    """Per rank, the size of its group."""
    return [g for g in composition for _ in range(g)]


def decode_logits(params, cfg, comm, layout: str) -> np.ndarray:
    """Teacher-forced decode of `DECODE_SLOTS[layout]` slots, DECODE_LEN
    steps -> this rank's logits [steps, slots, V] (under ``"batch"`` its
    slots only)."""
    import torch
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train import serve_step as S
    rt = Runtime(device="cpu", comm=comm)
    b = DECODE_SLOTS[layout]
    cache = S.init_decode_cache(cfg, rt, b, DECODE_LEN)
    assert S.slab_shard(rt, b, DECODE_LEN).layout == (
        layout if comm is not None else "batch")
    step = S.make_decode_step(cfg, rt, b, DECODE_LEN)
    toks = np.stack([seq_tokens(10 + i, cfg.vocab_size)[:DECODE_LEN]
                     for i in range(b)])
    out = []
    with torch.no_grad():
        for i in range(DECODE_LEN):
            lg, cache = step(params, cache, torch.tensor(toks[:, i]), i)
            out.append(lg.numpy())
    return np.stack(out)


def _rank_main(rank: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.parallel.comm import ProcessGroupComm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res: dict = {}
        world = ProcessGroupComm()
        pair_groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = ProcessGroupComm(pair_groups[rank // 2])
        _wait_for(f"{out_dir}/jax_params.npz")
        flat = dict(np.load(f"{out_dir}/jax_params.npz"))
        cfg = config()
        params = bridge.params_from_flat(flat, cfg, "cpu")
        for name, (comp, _) in WAVES.items():
            if name in PAIRS:
                continue
            wave_grads(params, cfg, world, comp,
                       wave_batch(name, cfg.vocab_size),
                       slice(rank * C, (rank + 1) * C), name, res)
        name = PAIRS[rank // 2]
        wave_grads(params, cfg, pair, WAVES[name][0],
                   wave_batch(name, cfg.vocab_size),
                   slice(pair.rank * C, (pair.rank + 1) * C), name, res)
        if rank < 2:
            train_steps(pair, flat, res)
        else:
            for layout in DECODE_SLOTS:
                res[f"decode/{layout}"] = decode_logits(params, cfg, pair,
                                                        layout)
        res = {k: np.asarray(v) for k, v in res.items()}
        np.savez(f"{out_dir}/torch_rank{rank}.tmp.npz", **res)
        os.replace(f"{out_dir}/torch_rank{rank}.tmp.npz",
                   f"{out_dir}/torch_rank{rank}.npz")
        dist.barrier()
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
