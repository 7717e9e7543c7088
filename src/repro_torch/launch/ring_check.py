"""The HDP ring on the planner's waves, checked and timed on GPUs over
NCCL, one process per card.

    PYTHONPATH=src python -m repro_torch.launch.ring_check [--ranks 4]

The waves are step 1 of the port's planner at hdp = ``--ranks`` (github
lengths, context 16384, 65536 tokens a step, capacity 4096 a rank,
strategy balance); the check runs each of its (4,), (2, 2), (1, 2, 1)
and (1, 1, 1, 1) waves that the plan holds.  Each rank draws the same
seeded q, kv and do (bf16, llama3.2-3b's attention widths: 24 q heads, 8
kv heads, head_dim 128), runs the forward and backward ring on its slice
(direct calls of `kernels/ring_flash.py`), and holds out, dq, dk and dv
to the single-rank flash route over its group's concatenated slices,
computed on its own card (2e-2 element-wise and relative L2).  Its
carry, dq and dkv launches must equal 1 + the visiting blocks that
`_block_relevant` keeps for it.  Prints, from rank 0, the card, each
composition's ring ms (the slowest rank's fwd+bwd) beside the
single-rank ms of the largest group, then llama3.2-3b at full width and
depth (random weights from seed 0): the (2, 2) wave's forward loss at
hdp = 4, each rank its slice, against the hdp = 1 forward of the same
tokens on rank 0 (1e-2 relative).  Raises without enough CUDA devices.

`chip_smoke.py` runs the same checks on one card through
`parallel.comm.ThreadRanks`; the helpers here take any `HdpComm`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

RING_CAP = 4096                 # tokens a rank
RING_COMPS = [(4,), (2, 2), (1, 2, 1), (1, 1, 1, 1)]   # the last: control
HQ, G_KV, HEAD_DIM = 24, 8, 128      # llama3.2-3b's attention widths
TOL = 2e-2                      # the flash kernels' bf16 gate
LOSS_TOL = 1e-2                 # hdp = 4 forward loss against hdp = 1


def planner_waves(cfg, hdp: int, comps=RING_COMPS):
    """Step 1 of the planner at ``hdp`` -> ({composition: loaded wave} for
    the first wave of each composition in ``comps`` the plan holds, the
    step's denom, every wave's composition)."""
    from repro_torch.data.loader import (GlobalScheduler, SyntheticDataset,
                                         WaveMaterializer)
    ds = SyntheticDataset("github", cfg.vocab_size, tokens_per_step=65536,
                          context=16384)
    sched = GlobalScheduler(ds, cfg, capacity=RING_CAP, hdp=hdp,
                            strategy="balance", use_offload=False)
    try:
        plan = sched.plan_step(1)
    finally:
        sched.stop()
    mat = WaveMaterializer(ds, cfg, RING_CAP)
    waves = {}
    for w in plan.waves:
        comp = tuple(w.composition)
        if comp in comps and comp not in waves and w.c_mult == 1:
            waves[comp] = mat.materialize(1, w)
    return waves, plan.denom, [tuple(w.composition) for w in plan.waves]


def groups(comp):
    """-> [(rank, its group's first rank, group size)]."""
    out, start = [], 0
    for g in comp:
        out += [(start + j, start, g) for j in range(g)]
        start += g
    return out


def expected_launches(comp, seg_np, pos_np, c: int = RING_CAP) -> list:
    """Per rank of ``c`` rows: 1 (the local block) + the visiting blocks it
    can see, from `_block_relevant` on the rank metas (at step s rank j of
    a group holds the block of rank j - s)."""
    from repro_torch.core.ring import _block_meta, _block_relevant
    metas = [_block_meta(torch.tensor(seg_np[r * c:(r + 1) * c]),
                         torch.tensor(pos_np[r * c:(r + 1) * c]))
             for r in range(sum(comp))]
    return [1 + sum(bool(_block_relevant(
        metas[r], metas[start + (r - start - s) % g], causal=True,
        window=0)) for s in range(1, g))
        for r, start, g in groups(comp)]


def ring_inputs(lw, seed: int, device) -> dict:
    """q [T, 24, 128], kv [T, 8, 256], do [T, 24, 128] bf16 from a seeded
    generator, and the wave's int32 seg/pos, on ``device``."""
    t = lw.batch["seg"].shape[0]
    rng = np.random.RandomState(seed)

    def bf16(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.bfloat16,
                            device=device)
    return {"q": bf16(t, HQ, HEAD_DIM), "kv": bf16(t, G_KV, 2 * HEAD_DIM),
            "do": bf16(t, HQ, HEAD_DIM),
            "seg": torch.tensor(lw.batch["seg"], device=device),
            "pos": torch.tensor(lw.batch["pos"], device=device)}


def ring_config(comp):
    from repro_torch.kernels.ring_flash import RingConfig
    return RingConfig(composition=comp, kv_split=(HEAD_DIM,) * 3,
                      gather=False, scale=HEAD_DIM ** -0.5)


def _fwd_bwd(rcfg, x, sl, comm=None):
    from repro_torch.kernels import ring_flash as RF
    with torch.no_grad():
        out, res = RF.ring_flash_fwd(rcfg, x["q"][sl], x["kv"][sl],
                                     x["seg"][sl], x["seg"][sl],
                                     x["pos"][sl], x["pos"][sl], None, comm)
        dq, dkv = RF.ring_flash_bwd(rcfg, res, x["do"][sl], comm)
    return out, dq, dkv, res[-1]


def rank_ring(comm, comp, x):
    """This rank's forward and backward ring -> (out, dq, dkv, live steps
    the ring ran)."""
    c = RING_CAP
    out, dq, dkv, live = _fwd_bwd(ring_config(comp), x,
                                  slice(comm.rank * c, (comm.rank + 1) * c),
                                  comm)
    return out, dq, dkv, int(live[comm.rank].sum())


def group_reference(comp, x, start: int, g: int):
    """The single-rank flash route over ranks [start, start + g)'s
    concatenated slices -> (out, dq, dkv)."""
    c = RING_CAP
    one = dataclasses.replace(ring_config(comp), composition=(1,))
    return _fwd_bwd(one, x, slice(start * c, (start + g) * c))[:3]


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def hold_rank(name, got, ref, j):
    """Rank j of its group: out, dq, dk, dv against the group reference's
    rows, 2e-2 element-wise and relative L2 -> {key: (max err, rel L2)}."""
    c, d = RING_CAP, HEAD_DIM
    rows = slice(j * c, (j + 1) * c)
    res = {}
    for key, a, b in (("out", got[0], ref[0][rows]),
                      ("dq", got[1], ref[1][rows]),
                      ("dk", got[2][..., :d], ref[2][rows, :, :d]),
                      ("dv", got[2][..., d:], ref[2][rows, :, d:])):
        err = (a.float() - b.float()).abs().max().item()
        rl2 = rel_l2(a, b)
        if not torch.allclose(a.float(), b.float(), atol=TOL, rtol=TOL) \
                or not rl2 <= TOL:
            raise AssertionError(f"{name} {key}: max abs error {err}, "
                                 f"relative L2 {rl2} against the "
                                 f"single-rank route")
        res[key] = (err, rl2)
    return res


def model_loss(params, cfg, rt, batch, sl, denom) -> float:
    """Forward loss share of rows ``sl`` under ``rt`` (no grad)."""
    from repro_torch.core.loss import token_ce_loss
    from repro_torch.models.transformer import forward_hidden
    with torch.no_grad():
        h = forward_hidden(params, cfg, rt, {
            k: batch[k][sl] for k in ("tokens", "seg", "pos")})
        loss, _ = token_ce_loss(params, cfg, rt, h, batch["labels"][sl],
                                batch["seg"][sl], denom)
    return loss.item()


# ---------------------------------------------------------------------------
# one process per card over NCCL
# ---------------------------------------------------------------------------

def _counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_ce as CE
    ws = {"flash_fwd_carry": FA.flash_attention_fwd_carry,
          "flash_bwd_dq": FA.flash_attention_bwd_dq,
          "flash_bwd_dkv": FA.flash_attention_bwd_dkv,
          "fused_ce_fwd": CE.fused_ce_fwd}
    return {k: w.launches for k, w in ws.items()}


def _time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _rank_main(rank: int, ranks: int, store: str) -> None:
    import datetime
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.comm import ProcessGroupComm
    from repro_torch.parallel.sharding import Runtime
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        comm = ProcessGroupComm()
        dev = torch.device("cuda", rank)
        say = print if rank == 0 else (lambda *a, **k: None)
        cfg = get_config("llama3.2-3b")
        waves, denom, comps = planner_waves(cfg, ranks)
        say(f"[ring_check] planner step 1 at hdp={ranks}: waves {comps}",
            flush=True)
        for i, comp in enumerate(RING_COMPS):
            if comp not in waves:
                continue
            x = ring_inputs(waves[comp], 10 + i, dev)
            live = expected_launches(comp, waves[comp].batch["seg"],
                                     waves[comp].batch["pos"])
            before = _counts()
            got = rank_ring(comm, comp, x)
            torch.cuda.synchronize()
            n = {k: v - before[k] for k, v in _counts().items()}
            want = live[rank]
            if got[3] != want or any(n[k] != want for k in
                                     ("flash_fwd_carry", "flash_bwd_dq",
                                      "flash_bwd_dkv")):
                raise AssertionError(f"rank {rank} {comp}: launches {n}, "
                                     f"live {got[3]}, want {want}")
            _, start, g = groups(comp)[rank]
            errs = hold_rank(f"rank {rank} {comp}", got,
                             group_reference(comp, x, start, g), rank - start)
            ring_ms = _time_ms(lambda: rank_ring(comm, comp, x))
            _, big_start, big = max(groups(comp), key=lambda r: r[2])
            ref_ms = _time_ms(lambda: group_reference(comp, x, big_start,
                                                      big))
            slow = torch.tensor([ring_ms], device=dev)
            dist.all_reduce(slow, op=dist.ReduceOp.MAX)
            worst = torch.tensor([max(e[1] for e in errs.values())],
                                 device=dev)
            dist.all_reduce(worst, op=dist.ReduceOp.MAX)
            say(json.dumps({"composition": list(comp), "live_per_rank": live,
                            "ring_ms_slowest_rank": float(slow),
                            "single_rank_ms_largest_group": ref_ms,
                            "rel_l2_max": float(worst)}), flush=True)
        comp = (2, 2)
        if comp in waves and ranks == 4:
            lw = waves[comp]
            batch = {k: torch.tensor(v, device=dev)
                     for k, v in lw.batch.items()}
            den = torch.tensor(float(denom), device=dev)
            params = init_params(cfg, seed=0, device=dev)
            c = RING_CAP
            rt = Runtime(device=dev, comm=comm, composition=comp)
            share = model_loss(params, cfg, rt, batch,
                               slice(rank * c, (rank + 1) * c), den)
            total = torch.tensor([share], device=dev, dtype=torch.float64)
            dist.all_reduce(total)
            if rank == 0:
                loss1 = model_loss(params, cfg, Runtime(device=dev), batch,
                                   slice(None), den)
                rel = abs(float(total) - loss1) / abs(loss1)
                say(json.dumps({"model": cfg.name, "composition": list(comp),
                                "loss_hdp4": float(total),
                                "loss_hdp1": loss1, "rel_err": rel}),
                    flush=True)
                if not rel <= LOSS_TOL:
                    raise AssertionError(f"hdp=4 loss {float(total)} vs "
                                         f"hdp=1 {loss1}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < args.ranks:
        raise RuntimeError(f"ring_check needs {args.ranks} CUDA devices, "
                           f"found {torch.cuda.device_count()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    import torch.multiprocessing as mp
    from repro_torch.kernels import build
    build.build_all(["flash_fwd", "flash_bwd", "fused_ce"])   # once, here
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        mp.start_processes(_rank_main, args=(args.ranks,
                                             os.path.join(tmp, "store")),
                           nprocs=args.ranks, join=True,
                           start_method="spawn")


if __name__ == "__main__":
    main()
