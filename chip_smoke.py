#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA
   versions; TF32 switched off for matmuls and cuDNN.
2. build   — compiles every CUDA kernel of the port from the checkout's
   sources (one nvcc per source, all started together).
3. kernels — holds each flash kernel against its plain PyTorch version on
   the card: the serving slice's shape [8,3,4096,128] bf16 with packed
   segments, padding rows and a non-zero carry-in; a ragged T=S=4000; a
   window=16/softcap=30 case; Dv=64 != Dk=128.  Tolerance 2e-2 (bf16, the
   reference's kernel-test tolerance); padding rows must be exactly zero
   with lse exactly -1e30 (finalising) or keep their carry-in exactly.
   Prints max error, kernel_ms, plain_ms, library_ms and the bound.
4. serve   — llama3.2-3b at full width and depth (random weights from
   seed 0) in bf16 on the card through `ServeEngine`: 8 prompts, 16 new
   tokens each; checks finite logits, >= 2 prefill waves and the carry
   kernel launched 28 times per prefill wave; holds the longest request's
   engine logits to a float32 teacher-forced forward (rms within 0.08:
   element-wise, bf16 noise at this depth and vocabulary reaches 0.1);
   then the same width cut to 2 layers, every request held element-wise
   to its teacher-forced forward at test_serve's atol = rtol = 0.08.
5. report  — one JSON line of every ported kernel (launches on the serve
   run, errors and times), then the result line.

Imports nothing of JAX and nothing of the JAX package.  Exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
TOL = 2e-2                      # bf16, tests/test_kernels.py
SERVE_TOL = 0.08                # tests/test_serve.py
PROMPT_LENS = [3000, 1800, 900, 400, 200, 120, 64, 33]
NEW_TOKENS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all(["flash_fwd"])
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log("flash_fwd").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def packed_meta(rng, n: int, lens):
    """Segments of the given lengths packed from row 0, padding (seg 0)
    after them — the layout of one prefill wave."""
    import numpy as np
    seg = np.zeros(n, np.int32)
    pos = np.zeros(n, np.int32)
    cur = 0
    for i, ln in enumerate(lens):
        seg[cur:cur + ln] = i + 1
        pos[cur:cur + ln] = np.arange(ln)
        cur += ln
    assert cur < n, "leave padding rows"
    return seg, pos


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(g, hg, t, s, dk, dv, n_pairs, carry: bool):
    """Least time on the card: operations the data needs (unmasked
    (q, k) pairs x 2*(Dk+Dv) per head) over the bf16 tensor-core peak,
    against bytes read once and written once over the memory rate."""
    flops = 2.0 * (dk + dv) * g * hg * n_pairs
    nbytes = 2 * (g * hg * t * dk + g * s * (dk + dv)) + 4 * 2 * (t + s)
    state = 4 * g * hg * t * (dv + 2)
    nbytes += 2 * state if carry else 2 * g * hg * t * dv + 4 * g * hg * t
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def kernel_case(torch, FA, name, *, g, hg, t, s, dk, dv, lens_q, window=0,
                softcap=0.0, seed=0):
    import numpy as np
    from repro_torch.core.attention import attention_mask
    rng = np.random.RandomState(seed)
    dev = "cuda"
    q = torch.tensor(rng.randn(g, hg, t, dk), dtype=torch.bfloat16,
                     device=dev)
    k = torch.tensor(rng.randn(g, s, dk), dtype=torch.bfloat16, device=dev)
    v = torch.tensor(rng.randn(g, s, dv), dtype=torch.bfloat16, device=dev)
    seg_np, pos_np = packed_meta(rng, t, lens_q)
    seg = torch.tensor(seg_np, device=dev)
    pos = torch.tensor(pos_np, device=dev)
    if s != t:
        raise ValueError("cases use self-attention over one packed buffer")
    scale = dk ** -0.5
    kw = dict(scale=scale, causal=True, window=window, softcap=softcap)
    args = (q, k, v, seg, seg, pos, pos)
    pad = torch.tensor(seg_np == 0, device=dev)

    # finalising kernel vs its plain version
    out, lse = FA.flash_attention_fwd(*args, **kw)
    out_p, lse_p = FA.flash_attention_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    err_f = (out.float() - out_p.float()).abs().max().item()
    if not torch.allclose(out.float(), out_p.float(), atol=TOL, rtol=TOL):
        raise AssertionError(f"{name}: flash_fwd out differs by {err_f}")
    live = ~pad[None, None, :].expand_as(lse)
    if not torch.allclose(lse[live], lse_p[live], atol=TOL, rtol=TOL):
        raise AssertionError(f"{name}: flash_fwd lse differs")
    if out[:, :, pad].abs().max().item() != 0.0 or \
            not bool((lse[:, :, pad] == FA.NEG_INF).all()):
        raise AssertionError(f"{name}: padding rows not exactly 0 / -1e30")

    # carry kernel vs its plain version, from a non-zero carry-in
    acc0 = torch.tensor(rng.randn(g, hg, t, dv), dtype=torch.float32,
                        device=dev)
    m0 = torch.tensor(rng.randn(g, hg, t), dtype=torch.float32, device=dev)
    l0 = torch.tensor(rng.rand(g, hg, t) + 0.5, dtype=torch.float32,
                      device=dev)
    acc, m, l = FA.flash_attention_fwd_carry(*args, acc0.clone(), m0.clone(),
                                             l0.clone(), **kw)
    acc_p, m_p, l_p = FA.flash_attention_fwd_carry_plain(*args, acc0, m0, l0,
                                                         **kw)
    torch.cuda.synchronize()
    o_c, lse_c = FA.finalize(acc, m, l, torch.float32)
    o_cp, lse_cp = FA.finalize(acc_p, m_p, l_p, torch.float32)
    err_c = (o_c - o_cp).abs().max().item()
    if not (torch.allclose(o_c, o_cp, atol=TOL, rtol=TOL)
            and torch.allclose(lse_c, lse_cp, atol=TOL, rtol=TOL)
            and torch.allclose(m, m_p, atol=TOL, rtol=TOL)):
        raise AssertionError(f"{name}: flash_fwd_carry differs by {err_c}")
    if not (torch.equal(acc[:, :, pad], acc0[:, :, pad])
            and torch.equal(m[:, :, pad], m0[:, :, pad])
            and torch.equal(l[:, :, pad], l0[:, :, pad])):
        raise AssertionError(f"{name}: padding rows changed their carry")

    res = {"fwd_err": err_f, "carry_err": err_c}
    n_pairs = int(np.sum((seg_np[:, None] == seg_np[None, :])
                         & (seg_np[:, None] > 0)
                         & (pos_np[None, :] <= pos_np[:, None])
                         & ((pos_np[:, None] - pos_np[None, :] < window)
                            if window else True)))
    res["fwd_ms"] = time_ms(torch, lambda: FA.flash_attention_fwd(
        *args, **kw), 20)
    res["carry_ms"] = time_ms(torch, lambda: FA.flash_attention_fwd_carry(
        *args, acc, m, l, **kw), 20)
    res["fwd_plain_ms"] = time_ms(
        torch, lambda: FA.flash_attention_fwd_plain(*args, **kw), 3)
    res["carry_plain_ms"] = time_ms(
        torch, lambda: FA.flash_attention_fwd_carry_plain(
            *args, acc0, m0, l0, **kw), 3)
    # yardstick only: one PyTorch call computing the same attention
    mask = attention_mask(seg, seg, pos, pos, causal=True,
                          window=window)
    kq = k[:, None].expand(g, hg, s, dk)
    vq = v[:, None].expand(g, hg, s, dv)
    F = torch.nn.functional
    res["library_ms"] = (None if softcap else time_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q, kq, vq, attn_mask=mask, scale=scale), 10))
    res["fwd_bound"] = bound_ms(g, hg, t, s, dk, dv, n_pairs, False)
    res["carry_bound"] = bound_ms(g, hg, t, s, dk, dv, n_pairs, True)
    res["n_pairs"] = n_pairs
    # drop the wrappers' counts: comparison launches are not the path's
    FA.flash_attention_fwd.launches = 0
    FA.flash_attention_fwd_carry.launches = 0
    fmt = {k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in res.items()}
    log(f"[kernels] {name}: {json.dumps(fmt)}")
    return res


def phase_kernels(torch):
    from repro_torch.kernels import flash_attention as FA
    slice_lens = [3000, 900, 120]       # a packed prefill wave + padding
    cases = [
        kernel_case(torch, FA, "slice [8,3,4096,128]", g=8, hg=3, t=4096,
                    s=4096, dk=128, dv=128, lens_q=slice_lens),
        kernel_case(torch, FA, "ragged T=S=4000", g=8, hg=3, t=4000, s=4000,
                    dk=128, dv=128, lens_q=[2500, 1000, 433], seed=1),
        kernel_case(torch, FA, "window=16 softcap=30", g=2, hg=2, t=256,
                    s=256, dk=64, dv=64, lens_q=[100, 90, 40], window=16,
                    softcap=30.0, seed=2),
        kernel_case(torch, FA, "Dk=128 Dv=64", g=2, hg=4, t=512, s=512,
                    dk=128, dv=64, lens_q=[300, 150, 33], seed=3),
    ]
    return cases


# ---------------------------------------------------------------------------
# 4. serve
# ---------------------------------------------------------------------------

def serve_pool(torch, cfg, params, rt):
    """The 8-request pool through `ServeEngine`, drained; launch counts
    are zeroed just before the drain and read just after."""
    import numpy as np
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(params, cfg, rt, ServeConfig(
        max_slots=8, max_context=4096, prefill_capacity=4096,
        collect_logits=True))
    rng = np.random.RandomState(0)
    rids = [eng.submit(rng.randint(0, cfg.vocab_size, n), NEW_TOKENS)
            for n in PROMPT_LENS]
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention_fwd.launches = 0
    FA.flash_attention_fwd_carry.launches = 0
    t0 = time.perf_counter()
    eng.drain(max_steps=200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd_carry": FA.flash_attention_fwd_carry.launches,
                "flash_fwd": FA.flash_attention_fwd.launches}

    waves = eng.stats["prefill_waves"]
    if waves < 2:
        raise AssertionError(f"expected >= 2 prefill waves, got {waves}")
    if launches["flash_fwd_carry"] != cfg.num_layers * waves:
        raise AssertionError(
            f"carry kernel launched {launches['flash_fwd_carry']} times, "
            f"want {cfg.num_layers} x {waves} prefill waves")
    reqs = [eng.pool.get(r) for r in rids]
    for r in reqs:
        if r.error or len(r.generated) != NEW_TOKENS:
            raise AssertionError(f"request {r.rid}: error={r.error} "
                                 f"{len(r.generated)} tokens")
        if not np.isfinite(np.stack(r.logits)).all():
            raise AssertionError(f"request {r.rid}: non-finite logits")
    return eng, reqs, launches, wall


def teacher_forced(torch, params, cfg, rt, req):
    """Logit rows of one request from a packed forward over its prompt
    and generated tokens (prompt + generated[:-1]), as float32 numpy."""
    import numpy as np
    from repro_torch.models.transformer import forward_hidden, logits_head
    toks = np.concatenate([req.prompt, np.asarray(req.generated[:-1])])
    n = len(toks)
    dev = rt.device
    with torch.inference_mode():
        h = forward_hidden(params, cfg, rt, {
            "tokens": torch.tensor(toks, dtype=torch.int32, device=dev),
            "seg": torch.ones(n, dtype=torch.int32, device=dev),
            "pos": torch.arange(n, dtype=torch.int32, device=dev)})
        return logits_head(params, cfg, h[req.plen - 1:]).float().cpu() \
            .numpy()


def _to_float32(tree):
    if isinstance(tree, dict):
        return {k: _to_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_float32(v) for v in tree]
    return tree.float()


def phase_serve(torch):
    """Full width and depth: counts, finiteness, and the engine against a
    float32 teacher-forced reference (rms gate, see below).  Then the same
    width cut to 2 layers, held element-wise at test_serve's tolerance."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.sharding import Runtime

    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    rt = Runtime(device="cuda")                 # attn_impl="flash"
    n_params = sum(x.numel() for x in _leaves(params))
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{n_params / 1e9:.3f} B params {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.1f} s")
    eng, reqs, launches, wall = serve_pool(torch, cfg, params, rt)
    peak = torch.cuda.max_memory_allocated()

    # Reference: the longest request teacher-forced in float32 (weights
    # upcast, plain attention — the CUDA kernel takes bf16).  At full depth
    # and a 128256-entry vocabulary the bf16 engine's error against it is
    # noise of rms ~0.02 whose largest element reaches ~0.1 (the bf16
    # teacher-forced forward, reported beside it, differs from the engine
    # as much), so test_serve's 0.08 is held as an rms here and
    # element-wise at 2 layers below.
    req = reqs[0]
    tf_bf16_max = float(np.abs(np.stack(req.logits) - teacher_forced(
        torch, params, cfg, rt, req)).max())
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref = teacher_forced(torch, _to_float32(params), cfg32,
                         Runtime(device="cuda", attn_impl="ref"), req)
    got = np.stack(req.logits)
    tf_rms = float(np.sqrt(np.mean((got - ref) ** 2)))
    tf_max = float(np.abs(got - ref).max())
    if not tf_rms <= SERVE_TOL:
        raise AssertionError(f"engine vs float32 teacher-forced logits: rms "
                             f"{tf_rms} > {SERVE_TOL}")

    prefill_s = sum(r.prefill_s for r in reqs)
    decode_s = sum(r.decode_s for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    ttft = sorted(r.t_first - r.t_submit for r in reqs)
    waves = eng.stats["prefill_waves"]
    res = {"prefill_waves": waves,
           "decode_waves": eng.stats["decode_waves"],
           "carry_launches": launches["flash_fwd_carry"],
           "prefill_ms_per_wave": prefill_s / waves * 1e3,
           "ttft_s_first": ttft[0], "ttft_s_last": ttft[-1],
           "decode_tokens_per_s": decode_tokens / decode_s,
           "decode_ms_per_wave": decode_s / eng.stats["decode_waves"] * 1e3,
           "drain_s": wall, "peak_mem_gb": peak / 1e9,
           "tf32ref_rms_err": tf_rms, "tf32ref_max_abs_err": tf_max,
           "tfbf16_max_abs_err": tf_bf16_max,
           "tf32ref_same_tokens":
               [int(x) for x in ref.argmax(-1)] == req.generated}
    del eng, params
    torch.cuda.empty_cache()

    # depth cut to 2 layers, full width and vocabulary: every request
    # element-wise against its bf16 teacher-forced forward (test_serve)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = init_params(cfg2, seed=0, device="cuda")
    eng2, reqs2, launches2, _ = serve_pool(torch, cfg2, params2, rt)
    err2 = 0.0
    for r in reqs2:
        ref2 = teacher_forced(torch, params2, cfg2, rt, r)
        got2 = np.stack(r.logits)
        err2 = max(err2, float(np.abs(got2 - ref2).max()))
        if not np.allclose(got2, ref2, atol=SERVE_TOL, rtol=SERVE_TOL):
            raise AssertionError(f"2-layer request {r.rid}: engine vs "
                                 f"teacher-forced logits differ by {err2}")
    res["layers2_max_abs_err"] = err2
    res["layers2_carry_launches"] = launches2["flash_fwd_carry"]
    fmt = {k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in res.items()}
    log(f"[serve] {json.dumps(fmt)}")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# 5. report
# ---------------------------------------------------------------------------

def kernels_line(cases, launches):
    head = cases[0]
    err = {"flash_fwd": max(c["fwd_err"] for c in cases),
           "flash_fwd_carry": max(c["carry_err"] for c in cases)}
    rows = []
    for name, key, line in (("flash_fwd_carry", "carry", 153),
                            ("flash_fwd", "fwd", 79)):
        bound, by = head[f"{key}_bound"]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": head[f"{key}_ms"], "plain_ms": head[f"{key}_plain_ms"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": head["library_ms"]})
    return {"kernels": rows}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    phase_device(torch)
    phase_build()
    cases = phase_kernels(torch)
    launches = phase_serve(torch)
    log(json.dumps(kernels_line(cases, launches)))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
