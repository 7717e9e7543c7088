"""Where the serving time goes on the card: warm drains of the
chip-smoke request pool through `ServeEngine`, one under `torch.profiler`.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

Builds llama3.2-3b at full width and depth with random weights from
seed 0 on the GPU and drains the 8-request pool three times: cold (the
kernel build and first-use costs), warm, and warm under the profiler.
Prints the card, the per-phase wall times of each drain (prefill per
wave, decode per wave), the device-busy share of the profiled drain, and
the kernels by total device time, grouped into families.  Raises without
a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import init_params
from repro_torch.parallel.sharding import Runtime
from repro_torch.serve import ServeConfig, ServeEngine

PROMPT_LENS = [3000, 1800, 900, 400, 200, 120, 64, 33]
NEW_TOKENS = 16
FAMILIES = (("flash_fwd_kernel", "flash attention (CUDA kernel)"),
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


def drain(eng, rng, vocab):
    for n in PROMPT_LENS:
        eng.submit(rng.randint(0, vocab, n), NEW_TOKENS)
    p0 = dict(eng.stats)
    t0 = time.perf_counter()
    done = eng.drain(max_steps=200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    waves = eng.stats["prefill_waves"] - p0["prefill_waves"]
    dwaves = eng.stats["decode_waves"] - p0["decode_waves"]
    return {"wall_s": wall, "prefill_waves": waves, "decode_waves": dwaves,
            "prefill_ms_per_wave": 1e3 * sum(r.prefill_s for r in done)
            / waves,
            "decode_ms_per_wave": 1e3 * sum(r.decode_s for r in done)
            / dwaves}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = get_config("llama3.2-3b")
    params = init_params(cfg, seed=0, device="cuda")
    eng = ServeEngine(params, cfg, Runtime(device="cuda"), ServeConfig(
        max_slots=8, max_context=4096, prefill_capacity=4096))
    rng = np.random.RandomState(0)
    cold = drain(eng, rng, cfg.vocab_size)
    warm = drain(eng, rng, cfg.vocab_size)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_run = drain(eng, rng, cfg.vocab_size)
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
    print(json.dumps({"layers": cfg.num_layers, "cold": cold, "warm": warm,
                      "profiled": prof_run}))
    wall_ms = prof_run["wall_s"] * 1e3
    print(json.dumps({"profiled_wall_ms": wall_ms,
                      "device_busy_ms": device_ms,
                      "device_busy_share": device_ms / wall_ms,
                      "families_ms": dict(sorted(fams.items(),
                                                 key=lambda kv: -kv[1]))}))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{us / 1e3:10.2f} ms  {family(name):28s} {name[:90]}")


if __name__ == "__main__":
    main()
