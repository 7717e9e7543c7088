"""Where the serving time goes on the card: drains of the chip-smoke
request pool through `ServeEngine`, on one card or over several.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --mesh 4x1 \\
        [--arch llama-7b] [--max-slots 6] [--capacity 1024] [--layers N]

One card (``--mesh 1x1``, the default): builds the model at full width
and depth with random weights from seed 0 on the GPU and drains the
8-request pool three times: cold (the kernel build and first-use costs),
warm, and warm under the profiler.  Prints the card, the per-phase wall
times of each drain (prefill per wave, decode per wave), and the
device-busy share of the profiled drain with its device time by kernel
family and its 12 costliest kernels.  Raises without a CUDA device.

``--mesh Nx1`` serves at hdp = N, one process per rank: one per card over
NCCL (the kernels are built once here, before the ranks are spawned), or
over gloo with ``--device cpu`` (with ``--reduced``, a rehearsal on the
CPU).  Every rank holds rank 0's weights (seed 0, broadcast) and drains
the same pool twice (cold, then warm).  ``--max-slots`` picks the decode
slab's layout (slots that tile the ranks split over them; otherwise the
cache positions do) and ``--capacity`` the prefill capacity a rank, which
decides the ring compositions.  Rank 0 prints the card and one JSON line:
the layout, prefill ms per warm wave by composition, decode ms per wave,
TTFT per request, every rank's peak device memory and KV-slab bytes,
whether every rank took the same tokens and logits, the warm drain held
to an hdp = 1 engine that rank 0 runs on the same pool afterwards
(`hold_to_single_rank`), and on the cards a third drain with rank 0
under the profiler (device time by kernel family; a collective's kernel
counts while it waits for the other ranks).  For an MoE model that hold
compares two functions wherever a capacity drops pairs: a prefill wave
at hdp = N routes each rank's rows with a per-rank capacity, at hdp = 1
the whole wave's (the line gives the capacity factor).  ``--layers N`` cuts the
depth at full width, a measurement aid for a model whose replica does not
fit one card (Mistral-8x7B: 8 of its 32 layers hold 11.9 G parameters).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.train import _mesh
from repro_torch.models.transformer import init_params
from repro_torch.parallel.sharding import Runtime
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train.serve_step import cache_bytes
from repro_torch.tree import leaves

PROMPT_LENS = [3000, 1800, 900, 400, 200, 120, 64, 33]
NEW_TOKENS = 16
MAX_CONTEXT = 4096
SERVE_TOL = 0.08                # tests/test_serve.py
FAMILIES = (("nccl", "collectives (NCCL)"),
            ("flash_fwd_kernel", "flash attention (CUDA kernel)"),
            ("flash_bwd_dq", "flash backward dq (CUDA kernel)"),
            ("flash_bwd_dkv", "flash backward dkv (CUDA kernel)"),
            ("ce_fwd_kernel", "fused CE (CUDA kernels)"),
            ("ce_bwd_kernel", "fused CE (CUDA kernels)"),
            ("gemm", "matmul"), ("gemv", "matmul"), ("cutlass", "matmul"),
            ("xmma", "matmul"), ("nvjet", "matmul"),
            ("reduce", "reductions"), ("elementwise", "elementwise"),
            ("index", "gather/scatter"), ("scatter", "gather/scatter"),
            ("cat", "copies"), ("copy", "copies"), ("Memcpy", "copies"),
            ("Memset", "copies"))


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key.lower() in low:
            return fam
    return "other"


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def prompts(vocab: int) -> list:
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n) for n in PROMPT_LENS]


def ms_by_composition(prefill_log) -> dict:
    """``ServeEngine.prefill_log`` -> {"(comp)xc_mult": [ms of each wave]}."""
    out = defaultdict(list)
    for w in prefill_log:
        out[f"{w['composition']}x{w['c_mult']}"].append(1e3 * w["s"])
    return dict(out)


def drain(eng, pool):
    """Submits ``pool`` (NEW_TOKENS each) and drains the engine -> (times,
    the finished requests in submission order)."""
    rids = [eng.submit(p, NEW_TOKENS) for p in pool]
    p0 = dict(eng.stats)
    log0 = len(eng.prefill_log)
    t0 = time.perf_counter()
    eng.drain(max_steps=200)
    if eng.rt.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [eng.pool.get(r) for r in rids]
    waves = eng.stats["prefill_waves"] - p0["prefill_waves"]
    dwaves = eng.stats["decode_waves"] - p0["decode_waves"]
    return {"wall_s": wall, "prefill_waves": waves, "decode_waves": dwaves,
            "prefill_ms_per_wave": 1e3 * sum(r.prefill_s for r in reqs)
            / waves,
            "decode_ms_per_wave": 1e3 * sum(r.decode_s for r in reqs)
            / dwaves,
            "prefill_ms_by_composition": ms_by_composition(
                eng.prefill_log[log0:]),
            "ttft_s": [r.t_first - r.t_submit for r in reqs]}, reqs


def hold_to_single_rank(got, ref, tol: float = SERVE_TOL) -> dict:
    """``got``, ``ref``: per request (greedy tokens, logit rows [n, V]) of
    a multi-rank engine and an hdp = 1 engine on one pool.  The tokens
    must agree up to a first divergence, which is allowed only where the
    hdp = 1 engine's top-two logits at that position lie within ``tol`` (a
    near tie: the ring meets the KV blocks in another order, which moves
    bf16 logits); the logits are compared over the rows both engines
    computed from the same tokens, through the first divergence.  ->
    {"same_tokens", "near_ties", "faults" (divergences that are no near
    tie), "rms", "max_abs"}."""
    near, faults, diffs = [], [], []
    for n, ((tg, lg), (tr, lr)) in enumerate(zip(got, ref)):
        k = len(tr)
        for j, (a, b) in enumerate(zip(tg, tr)):
            if a != b:
                top2 = np.sort(lr[j])[-2:]
                gap = float(top2[1] - top2[0])
                (near if gap < tol else faults).append(
                    {"request": n, "position": j, "tokens": [int(a), int(b)],
                     "gap": gap})
                k = j + 1
                break
        diffs.append((np.asarray(lg[:k]) - np.asarray(lr[:k])).ravel())
    d = np.concatenate(diffs)
    return {"same_tokens": not near and not faults and all(
        len(tg) == len(tr) for (tg, _), (tr, _) in zip(got, ref)),
        "near_ties": near, "faults": faults,
        "rms": float(np.sqrt(np.mean(d ** 2))),
        "max_abs": float(np.abs(d).max())}


def tokens_and_logits(reqs) -> list:
    return [(list(r.generated), np.stack(r.logits)) for r in reqs]


def _digest(reqs) -> int:
    """A 60-bit prefix of the sha256 of every request's tokens and logit
    rows (bit-identical ranks give equal digests)."""
    h = hashlib.sha256()
    for toks, rows in tokens_and_logits(reqs):
        h.update(np.asarray(toks, np.int64).tobytes())
        h.update(np.ascontiguousarray(rows).tobytes())
    return int(h.hexdigest()[:15], 16)


def _model(args, device):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg, init_params(cfg, seed=0, device=device)


def _serve_config(args) -> ServeConfig:
    return ServeConfig(max_slots=args.max_slots, max_context=MAX_CONTEXT,
                       prefill_capacity=args.capacity, collect_logits=True)


def profiled_drain(eng, pool):
    """A drain under ``torch.profiler`` -> (its times, device ms by kernel
    name).  Device-side events only (kernels, copies): the host operators
    that launched them carry the same time again."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run, _ = drain(eng, pool)
    by_name = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] += evt.self_device_time_total / 1e3
    return run, dict(by_name)


def device_summary(run, by_name) -> dict:
    fams = defaultdict(float)
    for name, ms in by_name.items():
        fams[family(name)] += ms
    busy = sum(by_name.values())
    wall_ms = run["wall_s"] * 1e3
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "families_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:12])}


def profile_one_card(args) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cfg, params = _model(args, "cuda")
    eng = ServeEngine(params, cfg, Runtime(device="cuda"), _serve_config(args))
    pool = prompts(cfg.vocab_size)
    cold, _ = drain(eng, pool)
    warm, _ = drain(eng, pool)
    prof_run, by_name = profiled_drain(eng, pool)
    print(card)
    print(json.dumps({"layers": cfg.num_layers, "cold": cold, "warm": warm,
                      "profiled": prof_run}))
    print(json.dumps(device_summary(prof_run, by_name)))


def _rank_main(rank: int, hdp: int, args, store: str) -> None:
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel.comm import ProcessGroupComm
    cuda = args.device is None or args.device.startswith("cuda")
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // hdp))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", world_size=hdp,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        comm = ProcessGroupComm()
        dev = comm.device
        cfg, params = _model(args, dev)
        for x in leaves(params):
            comm.broadcast(x)
        pool = prompts(cfg.vocab_size)
        eng = ServeEngine(params, cfg, Runtime(device=dev, comm=comm),
                          _serve_config(args))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        cold, _ = drain(eng, pool)
        warm, reqs = drain(eng, pool)
        profiled = None
        if cuda:                     # rank 0 under the profiler, the rest
            if rank == 0:            # alongside it
                profiled = device_summary(*profiled_drain(eng, pool))
            else:
                drain(eng, pool)
        mine = torch.tensor([torch.cuda.max_memory_allocated() / 1e9
                             if cuda else float("nan"),
                             cache_bytes(eng.cache)], dtype=torch.float64,
                            device=dev)
        stats = comm.all_gather(mine).tolist()
        digests = comm.all_gather(torch.tensor(
            [_digest(reqs)], dtype=torch.int64, device=dev)).flatten()
        layout = eng.shard.layout
        del eng
        if rank == 0:
            ref_eng = ServeEngine(params, cfg, Runtime(device=dev),
                                  _serve_config(args))
            _, ref = drain(ref_eng, pool)
            del ref_eng
            print(json.dumps({
                "arch": cfg.name, "layers": cfg.num_layers,
                "moe_capacity_factor": cfg.moe.capacity_factor
                if cfg.moe is not None else None,
                "mesh": f"{hdp}x1", "device": str(dev), "layout": layout,
                "max_slots": args.max_slots, "capacity": args.capacity,
                "max_context": MAX_CONTEXT, "prompt_lens": PROMPT_LENS,
                "new_tokens": NEW_TOKENS,
                "cold_wall_s": cold["wall_s"], "warm": warm,
                "rank0_profiled": profiled,
                "peak_mem_gb_by_rank": [s[0] for s in stats],
                "kv_slab_bytes_by_rank": [int(s[1]) for s in stats],
                "ranks_identical": len(set(digests.tolist())) == 1,
                "vs_hdp1": hold_to_single_rank(tokens_and_logits(reqs),
                                               tokens_and_logits(ref))}),
                flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (a CPU rehearsal)")
    ap.add_argument("--mesh", default="1x1",
                    help="NxM: N HDP ranks, one process each (M, tensor "
                         "parallelism, must be 1)")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="decode slab width")
    ap.add_argument("--capacity", type=int, default=4096,
                    help="prefill capacity a rank")
    ap.add_argument("--layers", type=int, default=0,
                    help="a measurement aid: cut the depth to N layers at "
                         "full width (0: the config's depth)")
    ap.add_argument("--device", default=None,
                    help="default cuda; --mesh runs take cpu (gloo)")
    args = ap.parse_args(argv)
    hdp = _mesh(args.mesh)
    if hdp == 1:
        return profile_one_card(args)

    import torch.multiprocessing as mp
    if args.device is None or args.device.startswith("cuda"):
        if torch.cuda.device_count() < hdp:
            raise RuntimeError(f"--mesh {args.mesh} needs {hdp} CUDA "
                               f"devices, found {torch.cuda.device_count()}")
        print(card_line(), flush=True)
        from repro_torch.kernels import build
        build.build_all(["flash_fwd"])          # once, before the ranks
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        mp.start_processes(_rank_main, args=(hdp, args,
                                             os.path.join(tmp, "store")),
                           nprocs=hdp, join=True, start_method="spawn")
    return None


if __name__ == "__main__":
    main()
