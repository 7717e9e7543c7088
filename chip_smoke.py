#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA
   versions; TF32 switched off for matmuls and cuDNN.
2. build   — compiles every CUDA kernel of the port from the checkout's
   sources (flash_fwd, flash_bwd, fused_ce: one nvcc per source, all
   started together) and prints ptxas' registers and spills per kernel;
   fails unless the report holds all nine instantiations of the dq
   kernel (Dk, Dv in 32, 64, 128) and none of them spills.
3. kernels — holds each kernel against its plain PyTorch version on the
   card.  Flash forward: the slice's shape [8,3,4096,128] bf16 with packed
   segments (3000/900/120), padding rows and a non-zero carry-in; the
   skip-heavy case, 64 segments of 64 tokens at the same shape (only the
   diagonal tiles live); a ragged T=S=4000; a window=16/softcap=30 case;
   Dv=64 != Dk=128.  Flash backward (dq, then dkv from dq's delta): the
   same five cases from the forward kernel's (out, lse); dq's delta is
   held to rowsum(do * out) within 1e-4, and the Dk=128 Dv=64 case has
   Hg = 4, which the dq kernel's three heads per block do not divide.
   Each attention case prints the fraction of 64x64 tiles the kernels
   visit, from the port's tile predicate (`core/ring.py::tile_liveness`),
   and each backward row its instantiation's ptxas registers and spills.  Fused
   cross-entropy forward and backward: [4096,128256] bf16 with padding
   rows (label 0, g = 0) and V=4096.  Tolerance 2e-2 element-wise (bf16,
   the reference's kernel-test tolerance) and 2e-2 relative L2 per output;
   padding rows must come out exactly 0 (dq, dk/dv of padding keys,
   dlogits) with lse exactly -1e30 (finalising forward) or keep their
   carry-in exactly.  Prints max error, relative L2, ms, plain_ms,
   library_ms and the bound with what binds it.
4. serve   — llama3.2-3b at full width and depth (random weights from
   seed 0) in bf16 on the card through `ServeEngine`: 8 prompts, 16 new
   tokens each; checks finite logits, >= 2 prefill waves, the carry
   kernel launched 28 times per prefill wave and no backward or
   cross-entropy kernel; holds the longest request's engine logits to a
   float32 teacher-forced forward (rms within 0.08: element-wise, bf16
   noise at this depth and vocabulary reaches 0.1); then the same width
   cut to 2 layers, every request held element-wise to its teacher-forced
   forward at test_serve's atol = rtol = 0.08, and its greedy tokens to
   that forward's argmax (`tests/test_serve.py`) but where its top-two
   logits are within 0.08 (a near-tie, printed).
5. train   — llama3.2-3b at full width and depth in bf16 through
   `Trainer.train_step`: github lengths, 16384 tokens per step, context
   and wave capacity 4096, strategy balance, AdamW lr 3e-4 without warmup,
   3 steps.  Checks every wave loss and grad norm finite, applied == 1 on
   every step and per wave exactly 56 carry launches (28 forward + 28
   recomputed), 28 dq, 28 dkv, 1 CE forward and 1 CE backward.  Then the
   same width cut to 2 layers, one wave: the kernel route against the
   float32 plain route (weights upcast, attn_impl="ref", plain CE), loss
   within 1e-2 relative and every gradient leaf within 5e-2 relative L2,
   with the bf16 plain route's errors printed beside them.
6. ring    — the HDP ring at hdp = 4 on the one card through
   `ThreadRanks(4)` (four ranks as threads, the one-device stand-in for
   a process group).  The waves are step 1 of the port's planner at hdp =
   4 (github, context 16384, 65536 tokens a step, capacity 4096, balance):
   its (4,), (2, 2) and (1, 2, 1) waves and the (1, 1, 1, 1) control, 4096
   tokens a rank.  For each, q/kv/do in bf16 at llama3.2-3b's attention
   widths (24 q heads, 8 kv heads, head_dim 128) from a seeded generator
   go through the forward and backward ring (direct calls, no autograd);
   out, dq, dk and dv are held (2e-2 element-wise and relative L2) to the
   single-rank flash route over each group's concatenated slices; carry,
   dq and dkv launches equal the sum over ranks of 1 + the visiting blocks
   `_block_relevant` keeps, and the ring's own per-rank table equals that
   count (the helpers of `repro_torch.launch.ring_check`, which runs the
   same checks over NCCL on several cards).  Prints the ring's ms beside
   the single-rank ms of the same groups and the card.  Then llama3.2-3b
   at full width and depth (seed 0): the forward loss of the (2, 2) wave
   at hdp = 4 (each rank its slice, shares summed) within 1e-2 relative
   of the hdp = 1 forward of the same tokens, with 28 x (1 + live
   visiting blocks) carry launches.
7. hdp_train — the multi-rank `Trainer` under ZeRO-1 at hdp = 4:
   llama3.2-3b at full width cut to 2 layers (random weights from seed
   0), the planner's hdp = 4 steps 0 and 1 (as phase 6: github, context
   16384, 65536 tokens a step, capacity 4096, balance; step 1 holds the
   (4,), (1, 1, 1, 1), (2, 2) and (1, 2, 1) waves), calibration off.  Four
   processes share the card (rank 0 is this one): NCCL refuses two ranks
   on one GPU and threads cannot exchange inside an autograd backward,
   so the ranks form a gloo group through
   `parallel/comm.py::HostStagedComm`; every kernel runs on the card and
   only the bytes between ranks cross host memory, so the phase's times
   measure no card-to-card transfer.  Fails unless the card's compute
   mode is Default.  Rank 0 also runs the hdp = 1 route over each global
   wave from the same parameters: each wave's loss (summed over the
   ranks) and the grad norm within 1e-2 relative of it, the step-1
   reduced gradients within 5e-2 relative L2 per leaf; the ZeRO-1 apply
   against the unsharded apply on those same gradients (fp32 master, m
   and v within 1e-6; bf16 parameters within one ulp, or within 1e-6 for
   values under 2.4e-4, whose ulp is finer than the masters' hold and
   where the clip factor's last bit, summed from shards, shows); every
   rank's
   parameters equal to rank 0's after each step; per rank exactly layers
   x (1 + its live visiting blocks) carry launches in the forward and as
   many in the remat recompute, as many dq and dkv, one CE each way, per
   wave; applied == 1.  Prints per-rank peak memory and step wall.  Its
   four processes then run phase 10 (b).
8. offload — selective activation offload on the card: llama3.2-3b at
   full width and depth, hdp = 1, github at context 16384, 16384 tokens a
   step, capacity 4096, balance, Eq. 3 on.  (a) The plan's waves
   (composition, c_mult, r, k) are printed and one must offload (step 0:
   one (1,) wave at c_mult 4, r 0.875, k 24).  That wave then goes
   through ``grad_step`` outside the Trainer (seed-0 weights) under
   ``remat="full"`` and ``remat="offload"``: (b) loss and gradients
   bit-equal (or, were the kernels not run-to-run deterministic, within
   the full route's own spread); (c) exactly k x 16384 x 3072 x 2 bytes
   copied each way, the ledger's continuous-r prediction within half a
   period of it; (d) the forward leaving exactly k period inputs less for
   the backward, and the wave's peak lower by at least half of them.
   Prints warm ms both ways, the copy stream's busy time, the card's
   pinned copy bandwidth (256 MB each way) and Eq. 3's overlap bound per
   offloaded wave at the reference's constants and at that bandwidth.
   (e) Three `Trainer` steps with ``use_offload`` and the bytes ledger
   on: phase 5's checks, and each ledger record's offload bytes exactly
   k whole periods each way; the ledger's summary is printed.
9. hdp_serve — `ServeEngine` at hdp = 4 on the one card through
   `ThreadRanks(4)` (serving is forward only, so threads may exchange):
   llama3.2-3b at full width and depth (seed 0), phase 4's 8 prompts and
   16 new tokens at max_context 4096 and prefill capacity 1024 a rank, so
   the 3000- and 1800-token prompts need ring groups; once at 8 slots
   (the slab's slots split over the ranks, 2 a rank) and once at 6 (every
   rank holds 1024 of every slot's positions, attention through the
   flash-decoding combine; two requests wait for a second admission
   round).  Fails unless a wave has a group > 1; each rank's carry
   launches (counted between its exchanges) equal layers x (1 + its live
   visiting blocks) summed over the admitted waves
   (`launch/ring_check.py::expected_launches`); no other kernel runs;
   every rank's tokens and logit rows are bit-identical; each rank's KV
   slab is exactly layers x 2 x its slots x positions x 8 x 128 x 2 bytes
   (939,524,096 at 8 slots); and against an hdp = 1 engine on the same
   pool (its launches left out of the counts) the tokens agree up to a
   first divergence, allowed only where the hdp = 1 top-two logits lie
   within 0.08, with the logits' rms through it within 0.08
   (`launch/profile_serve.py::hold_to_single_rank`).  Prints prefill ms
   per wave by composition, decode ms per wave and TTFT at hdp = 4 and 1,
   the card's peak with the four ranks and the slab bytes.
10. ckpt    — checkpoint and resume (`ckpt/checkpoint.py`, the
   reference's format) at llama3.2-3b's width cut to 2 layers (seed 0):
   arrays.npz of 595.3 M parameters x 16 bytes (9.52 GB), under the
   checkout's build/ (free space checked first, directories deleted
   after).  (a) hdp = 1, phase 5's data, calibration off: Trainer A
   (``ckpt_every=2``) runs 3 steps, writing steps 2 and 3; one byte in
   the middle of step 3's arrays.npz is flipped; a fresh Trainer B
   resumes: step 3 skipped on a printed line, step 3 still the latest and
   step 2 the latest valid, every restored tensor equal to the file's;
   B's step 3 bit-equal to A's (loss, grad norm, every parameter) or,
   were the kernels not run-to-run deterministic, within A's own spread
   over two runs of that step.  (b) hdp = 4 -> 1 in phase 7's four
   processes, after its gates: the Trainers save at the end of ``run``
   (every rank gathers its ZeRO-1 shards, rank 0 writes), every rank's
   params and master/m/v shards equal the file's (its `zero1_dim` slice);
   the four run step 3; rank 0 alone resumes the file at hdp = 1 (state
   equal to the file) and runs step 3: the same denom, loss and grad
   norm within 1e-3 relative of hdp = 4's.  Exact launches per wave and
   per rank in both.  Prints the snapshot (it blocks the step), write,
   hash, restore and gather seconds, the file's GB and GB/s both ways.
11. moe     — Mistral-8x7B at full width (d 4096, 32/8 heads, 8
   experts, top-2, d_expert 14336, vocab 32000; seed 0), ~20 s.  (a) The
   MoE block alone on 4096 bf16 rows against a float32 loop over the
   experts on the same top-k indices and capacity rule: keep masks equal,
   relative L2 within 2e-2, at capacity factor 1.25 and 0.25 (which must
   drop pairs).  (b) Serving at 8 layers (11.9 G parameters), phase 4's
   pool at hdp = 1 at the config's capacity factor 1.25: phase 4's gates
   (carry launches 8 per prefill wave), the pairs of tokens its capacity
   dropped counted.  The drain again with every MoE call recorded, its
   tokens and logits bit-equal to the first: each call's kept pairs are
   the capacity rule's over the reference's group (a prefill wave; the
   decode slab), and each request's greedy tokens are held to the argmax
   of its bf16 teacher-forced forward replaying, row by row, the experts
   and the kept pairs the engine computed (near-ties below 0.08 printed;
   logits within 0.08 rms): a capacity drop depends on the group a row
   routes in, and a routing margin within bf16's error flips an expert
   between two evaluations.  (d) Serving at hdp = 4 through
   `ThreadRanks(4)`, 8 slots ("batch", the decode slab's routing from
   the ranks' all-gathered top-k indices): exact carry launches per
   rank, ranks bit-identical, held to hdp = 1 only if neither run dropped
   a pair of a token (both counts printed); then recorded and held as in
   (b), each rank's prefill rows one group, the ranks' decode rows
   together the slab.  (c) Training at 2 layers (3.17 G parameters),
   phase 5's data, 3 `Trainer` steps: finite losses, exactly 4/2/2/1/1
   launches a wave; then one wave, the kernel
   route against the float32 plain route replaying its expert choices:
   loss within 1e-2, every gradient leaf within 5e-2 relative L2, with
   the share of (token, k) pairs the float32 route's own routing sends to
   another expert printed.
12. report — one JSON line of every kernel (launches on the paths that
   run it: serve for the forward kernels, train for the rest, plus the
   ring's, the hdp = 4 trainer's, the offloading trainer's, the hdp = 4
   engine's, the checkpoint phase's and the MoE phase's; errors, times,
   bounds), then the result line.

Imports nothing of JAX and nothing of the JAX package.  Exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
TOL = 2e-2                      # bf16, tests/test_kernels.py
SERVE_TOL = 0.08                # tests/test_serve.py
TRAIN_LOSS_TOL = 1e-2           # 2-layer kernel route vs float32 plain
TRAIN_GRAD_TOL = 5e-2           # per gradient leaf, relative L2
APPLY_TOL = 1e-6                # ZeRO-1 vs unsharded apply: fp32 state; a
                                # bf16 parameter within one ulp, or this
                                # much where one ulp is finer (the masters'
                                # own hold admits more there)
PROMPT_LENS = [3000, 1800, 900, 400, 200, 120, 64, 33]
NEW_TOKENS = 16
SLICE_LENS = [3000, 900, 120]   # a packed wave of the slices + padding
DEVICE = "cuda"
RING_HDP = 4                    # phase 6: ranks (threads on the one card)
RING_KERNELS = ("flash_fwd_carry", "flash_bwd_dq", "flash_bwd_dkv")

CSRC = "src/repro_torch/kernels/csrc"
# every TPU kernel's counterpart: (name, source, replaced Pallas kernel,
# wrapper module, wrapper holding the launch count)
KERNELS = [
    ("flash_fwd", f"{CSRC}/flash_fwd.cu",
     "src/repro/kernels/flash_attention.py:79", "flash_attention",
     "flash_attention_fwd"),
    ("flash_fwd_carry", f"{CSRC}/flash_fwd.cu",
     "src/repro/kernels/flash_attention.py:153", "flash_attention",
     "flash_attention_fwd_carry"),
    ("flash_bwd_dq", f"{CSRC}/flash_bwd.cu",
     "src/repro/kernels/flash_attention.py:238", "flash_attention",
     "flash_attention_bwd_dq"),
    ("flash_bwd_dkv", f"{CSRC}/flash_bwd.cu",
     "src/repro/kernels/flash_attention.py:281", "flash_attention",
     "flash_attention_bwd_dkv"),
    ("fused_ce_fwd", f"{CSRC}/fused_ce.cu",
     "src/repro/kernels/fused_ce.py:24", "fused_ce", "fused_ce_fwd"),
    ("fused_ce_bwd", f"{CSRC}/fused_ce.cu",
     "src/repro/kernels/fused_ce.py:57", "fused_ce", "fused_ce_bwd"),
]
SERVE_KERNELS = ("flash_fwd", "flash_fwd_carry")   # launches from serve
# exact launches per training wave at llama3.2-3b's 28 layers
TRAIN_WAVE_LAUNCHES = {"flash_fwd": 0, "flash_fwd_carry": 56,
                       "flash_bwd_dq": 28, "flash_bwd_dkv": 28,
                       "fused_ce_fwd": 1, "fused_ce_bwd": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def wrappers() -> dict:
    return {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{mod}"), attr)
        for name, _, _, mod, attr in KERNELS}


def zero_counts() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in wrappers().items()}


def fmt(res: dict) -> str:
    return json.dumps({k: (float(f"{v:.5g}") if isinstance(v, float) else v)
                       for k, v in res.items()})


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

DQ_KERNELS = {f"flash_bwd_dq_kernel<{dk},{dv}>"
              for dk in (32, 64, 128) for dv in (32, 64, 128)}


def phase_build() -> dict:
    """-> {kernel<template args>: (registers, spill stores, spill loads)};
    raises if an instantiation of the dq kernel is missing from the report
    or spills."""
    from repro_torch.kernels import build
    names = sorted({Path(src).stem for _, src, _, _, _ in KERNELS})
    t0 = time.perf_counter()
    libs = build.build_all(names)
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    report = {}
    for name in names:
        for kern, regs, st, ld in build.ptxas_report(build.build_log(name)):
            log(f"[build] {name}: {kern} registers {regs} spill stores "
                f"{st} B, spill loads {ld} B")
            report[kern] = (regs, st, ld)
    missing = DQ_KERNELS - set(report)
    if missing:
        raise AssertionError(f"no ptxas report for {sorted(missing)}")
    spills = {k: report[k] for k in DQ_KERNELS if report[k][1] or report[k][2]}
    if spills:
        raise AssertionError(f"the dq kernel spills: {spills}")
    return report


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def packed_meta(rng, n: int, lens):
    """Segments of the given lengths packed from row 0, padding (seg 0)
    after them — the layout of one wave."""
    import numpy as np
    seg = np.zeros(n, np.int32)
    pos = np.zeros(n, np.int32)
    cur = 0
    for i, ln in enumerate(lens):
        seg[cur:cur + ln] = i + 1
        pos[cur:cur + ln] = np.arange(ln)
        cur += ln
    assert cur <= n
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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """Least time on the card: the larger of operations over the peak rate
    of their type and bytes read once and written once over the memory
    rate -> (ms, what binds it)."""
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def hold(torch, name, got, want):
    """Element-wise 2e-2 and relative L2 <= 2e-2 -> (max abs err, rel L2)."""
    err = (got.float() - want.float()).abs().max().item()
    rl2 = rel_l2(got, want)
    if not torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL) \
            or not rl2 <= TOL:
        raise AssertionError(f"{name}: max abs error {err}, relative L2 "
                             f"{rl2} against its plain version")
    return err, rl2


def attn_inputs(torch, g, hg, t, dk, dv, lens, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    dev = "cuda"
    q = torch.tensor(rng.randn(g, hg, t, dk), dtype=torch.bfloat16,
                     device=dev)
    k = torch.tensor(rng.randn(g, t, dk), dtype=torch.bfloat16, device=dev)
    v = torch.tensor(rng.randn(g, t, dv), dtype=torch.bfloat16, device=dev)
    seg_np, pos_np = packed_meta(rng, t, lens)
    seg = torch.tensor(seg_np, device=dev)
    pos = torch.tensor(pos_np, device=dev)
    return rng, (q, k, v, seg, seg, pos, pos), seg_np, pos_np


def live_fraction(torch, seg_np, pos_np, window) -> float:
    """Share of the 64x64 tiles the flash kernels visit (self-attention
    over one packed buffer, causal)."""
    from repro_torch.core.ring import tile_liveness
    seg, pos = torch.tensor(seg_np), torch.tensor(pos_np)
    return float(tile_liveness(seg, seg, pos, pos, causal=True,
                               window=window).float().mean())


def visible_pairs(seg_np, pos_np, window) -> int:
    import numpy as np
    return int(np.sum((seg_np[:, None] == seg_np[None, :])
                      & (seg_np[:, None] > 0)
                      & (pos_np[None, :] <= pos_np[:, None])
                      & ((pos_np[:, None] - pos_np[None, :] < window)
                         if window else True)))


def fwd_case(torch, FA, name, *, g, hg, t, dk, dv, lens, window=0,
             softcap=0.0, seed=0):
    """Both forward kernels (self-attention over one packed buffer)."""
    from repro_torch.core.attention import attention_mask
    rng, args, seg_np, pos_np = attn_inputs(torch, g, hg, t, dk, dv, lens,
                                            seed)
    q, k, v, seg = args[:4]
    scale = dk ** -0.5
    kw = dict(scale=scale, causal=True, window=window, softcap=softcap)
    pad = torch.tensor(seg_np == 0, device="cuda")

    # finalising kernel vs its plain version
    out, lse = FA.flash_attention_fwd(*args, **kw)
    out_p, lse_p = FA.flash_attention_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    err_f, rl2_f = hold(torch, f"{name} flash_fwd out", out, out_p)
    live = ~pad[None, None, :].expand_as(lse)
    hold(torch, f"{name} flash_fwd lse", lse[live], lse_p[live])
    if bool((out[:, :, pad] != 0).any()) or \
            not bool((lse[:, :, pad] == FA.NEG_INF).all()):
        raise AssertionError(f"{name}: padding rows not exactly 0 / -1e30")

    # carry kernel vs its plain version, from a non-zero carry-in
    acc0 = torch.tensor(rng.randn(g, hg, t, dv), dtype=torch.float32,
                        device="cuda")
    m0 = torch.tensor(rng.randn(g, hg, t), dtype=torch.float32, device="cuda")
    l0 = torch.tensor(rng.rand(g, hg, t) + 0.5, dtype=torch.float32,
                      device="cuda")
    acc, m, l = FA.flash_attention_fwd_carry(*args, acc0.clone(), m0.clone(),
                                             l0.clone(), **kw)
    acc_p, m_p, l_p = FA.flash_attention_fwd_carry_plain(*args, acc0, m0, l0,
                                                         **kw)
    torch.cuda.synchronize()
    o_c, lse_c = FA.finalize(acc, m, l, torch.float32)
    o_cp, lse_cp = FA.finalize(acc_p, m_p, l_p, torch.float32)
    err_c, rl2_c = hold(torch, f"{name} flash_fwd_carry out", o_c, o_cp)
    hold(torch, f"{name} flash_fwd_carry lse", lse_c, lse_cp)
    hold(torch, f"{name} flash_fwd_carry m", m, m_p)
    if not (torch.equal(acc[:, :, pad], acc0[:, :, pad])
            and torch.equal(m[:, :, pad], m0[:, :, pad])
            and torch.equal(l[:, :, pad], l0[:, :, pad])):
        raise AssertionError(f"{name}: padding rows changed their carry")

    n_pairs = visible_pairs(seg_np, pos_np, window)
    flops = 2.0 * (dk + dv) * g * hg * n_pairs
    in_bytes = 2 * (g * hg * t * dk + g * t * (dk + dv)) + 4 * 4 * t
    state = 4 * g * hg * t * (dv + 2)
    # yardstick only: one PyTorch call computing the same attention
    mask = attention_mask(seg, seg, args[5], args[6], causal=True,
                          window=window)
    kq = k[:, None].expand(g, hg, t, dk)
    vq = v[:, None].expand(g, hg, t, dv)
    F = torch.nn.functional
    library = None if softcap else time_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q, kq, vq, attn_mask=mask, scale=scale), 10)
    rows = {
        "flash_fwd": {
            "err": err_f, "rel_l2": rl2_f,
            "ms": time_ms(torch, lambda: FA.flash_attention_fwd(*args, **kw),
                          20),
            "plain_ms": time_ms(torch, lambda: FA.flash_attention_fwd_plain(
                *args, **kw), 3),
            "bound": bound(flops, in_bytes + 2 * g * hg * t * dv
                           + 4 * g * hg * t),
            "library_ms": library},
        "flash_fwd_carry": {
            "err": err_c, "rel_l2": rl2_c,
            "ms": time_ms(torch, lambda: FA.flash_attention_fwd_carry(
                *args, acc, m, l, **kw), 20),
            "plain_ms": time_ms(
                torch, lambda: FA.flash_attention_fwd_carry_plain(
                    *args, acc0, m0, l0, **kw), 3),
            "bound": bound(flops, in_bytes + 2 * state),
            "library_ms": library}}
    extra = {"n_pairs": n_pairs,
             "live_tiles": live_fraction(torch, seg_np, pos_np, window)}
    for key, row in rows.items():
        log(f"[kernels] {name} {key}: "
            f"{fmt({**row, 'bound': row['bound'][0], **extra})}")
    return rows


def ptxas_of(ptxas, kernel, dk, dv) -> dict:
    """Registers and spill bytes of the instantiation of ``kernel`` for
    (dk, dv) in the build report; raises if the report lacks it."""
    regs, st, ld = ptxas[f"{kernel}<{dk},{dv}>"]
    return {"registers": regs, "spill_bytes": st + ld}


def bwd_case(torch, FA, ptxas, name, *, g, hg, t, dk, dv, lens, window=0,
             softcap=0.0, seed=0):
    """Both backward kernels from the forward kernel's (out, lse)."""
    rng, args, seg_np, pos_np = attn_inputs(torch, g, hg, t, dk, dv, lens,
                                            seed)
    q, k, v = args[:3]
    scale = dk ** -0.5
    kw = dict(scale=scale, causal=True, window=window, softcap=softcap)
    pad = torch.tensor(seg_np == 0, device="cuda")
    out, lse = FA.flash_attention_fwd(*args, **kw)
    do = torch.tensor(rng.randn(g, hg, t, dv), dtype=torch.bfloat16,
                      device="cuda")
    res = (*args, out, lse, do)

    dq, delta = FA.flash_attention_bwd_dq(*res, **kw)
    dk_, dv_ = FA.flash_attention_bwd_dkv(*res, delta, **kw)
    dq_p, dk_p, dv_p = FA.flash_attention_bwd_plain(*res, **kw)
    torch.cuda.synchronize()
    err_q, rl2_q = hold(torch, f"{name} dq", dq, dq_p)
    err_k, rl2_k = hold(torch, f"{name} dk", dk_, dk_p)
    err_v, rl2_v = hold(torch, f"{name} dv", dv_, dv_p)
    want_delta = FA._delta(out, do)
    if not torch.allclose(delta, want_delta, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"{name}: delta off rowsum(do * out) by "
                             f"{(delta - want_delta).abs().max().item()}")
    if bool((dq[:, :, pad] != 0).any()) or bool((dk_[:, pad] != 0).any()) \
            or bool((dv_[:, pad] != 0).any()):
        raise AssertionError(f"{name}: padding rows' dq / dk / dv not "
                             f"exactly 0")

    n_pairs = visible_pairs(seg_np, pos_np, window)
    heads = g * hg
    # reads: q, k, v, out, do, lse, seg/pos once each
    in_bytes = 2 * (heads * t * (dk + 2 * dv) + g * t * (dk + dv)) \
        + 4 * heads * t + 4 * 4 * t
    # yardstick only: autograd backward of one masked SDPA call
    library = None
    if not softcap:
        from repro_torch.core.attention import attention_mask
        mask = attention_mask(args[3], args[4], args[5], args[6],
                              causal=True, window=window)
        qq = q.detach().requires_grad_(True)
        kq = k[:, None].expand(g, hg, t, dk).detach().requires_grad_(True)
        vq = v[:, None].expand(g, hg, t, dv).detach().requires_grad_(True)
        o = torch.nn.functional.scaled_dot_product_attention(
            qq, kq, vq, attn_mask=mask, scale=scale)
        library = time_ms(torch, lambda: torch.autograd.grad(
            o, (qq, kq, vq), do, retain_graph=True), 10)
        del o
    rows = {
        "flash_bwd_dq": {
            "err": err_q, "rel_l2": rl2_q,
            "ms": time_ms(torch, lambda: FA.flash_attention_bwd_dq(
                *res, **kw), 20),
            "plain_ms": time_ms(torch, lambda: FA.flash_attention_bwd_plain(
                *res, **kw), 3),
            "bound": bound(2.0 * (2 * dk + dv) * heads * n_pairs,
                           in_bytes + 2 * heads * t * dk),
            "library_ms": library},
        "flash_bwd_dkv": {
            "err": max(err_k, err_v), "rel_l2": max(rl2_k, rl2_v),
            "ms": time_ms(torch, lambda: FA.flash_attention_bwd_dkv(
                *res, delta, **kw), 20),
            "bound": bound(2.0 * (2 * dk + 2 * dv) * heads * n_pairs,
                           in_bytes + 2 * g * t * (dk + dv)),
            "library_ms": library}}
    # one plain version computes dq, dk and dv together: both rows carry it
    rows["flash_bwd_dkv"]["plain_ms"] = rows["flash_bwd_dq"]["plain_ms"]
    extra = {"n_pairs": n_pairs,
             "live_tiles": live_fraction(torch, seg_np, pos_np, window)}
    for key, row in rows.items():
        log(f"[kernels] {name} {key}: "
            f"{fmt({**row, 'bound': row['bound'][0], **extra})} "
            f"{fmt(ptxas_of(ptxas, f'{key}_kernel', dk, dv))}")
    return rows


def ce_case(torch, CE, name, *, t, v, n_pad, seed=0):
    """Both cross-entropy kernels; the last n_pad rows are padding (label
    0, g = 0)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    dev = "cuda"
    logits = torch.tensor(rng.randn(t, v) * 3, dtype=torch.bfloat16,
                          device=dev)
    labels_np = rng.randint(0, v, t).astype(np.int32)
    labels_np[t - n_pad:] = 0
    g_np = rng.randn(t).astype(np.float32)
    g_np[t - n_pad:] = 0.0
    labels = torch.tensor(labels_np, device=dev)
    g = torch.tensor(g_np, device=dev)

    nll, lse, tgt = CE.fused_ce_fwd(logits, labels)
    nll_p, lse_p, tgt_p = CE.fused_ce_fwd_plain(logits, labels)
    dl = CE.fused_ce_bwd(logits, labels, lse, g)
    dl_p = CE.fused_ce_bwd_plain(logits, labels, lse, g)
    torch.cuda.synchronize()
    err_n, rl2_n = hold(torch, f"{name} nll", nll, nll_p)
    err_l, rl2_l = hold(torch, f"{name} lse", lse, lse_p)
    hold(torch, f"{name} tgt", tgt, tgt_p)
    err_d, rl2_d = hold(torch, f"{name} dlogits", dl, dl_p)
    if dl[t - n_pad:].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: padding rows' dlogits not exactly 0")

    F = torch.nn.functional
    labels64 = labels.long()
    x = logits.float().requires_grad_(True)
    ce = F.cross_entropy(x, labels64, reduction="none")
    elems = float(t) * v
    rows = {
        "fused_ce_fwd": {
            "err": max(err_n, err_l), "rel_l2": max(rl2_n, rl2_l),
            "ms": time_ms(torch, lambda: CE.fused_ce_fwd(logits, labels), 20),
            "plain_ms": time_ms(torch, lambda: CE.fused_ce_fwd_plain(
                logits, labels), 3),
            # max, subtract, exp, add per logit in fp32
            "bound": bound(4 * elems, 2 * elems + 4 * t * 4,
                           PEAK_FP32_FLOPS),
            "library_ms": time_ms(torch, lambda: F.cross_entropy(
                logits.float(), labels64, reduction="none"), 10)},
        "fused_ce_bwd": {
            "err": err_d, "rel_l2": rl2_d,
            "ms": time_ms(torch, lambda: CE.fused_ce_bwd(
                logits, labels, lse, g), 20),
            "plain_ms": time_ms(torch, lambda: CE.fused_ce_bwd_plain(
                logits, labels, lse, g), 3),
            # subtract, exp, subtract, multiply per logit in fp32
            "bound": bound(4 * elems, 2 * 2 * elems + 3 * t * 4,
                           PEAK_FP32_FLOPS),
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                ce, x, g, retain_graph=True), 10)}}
    for key, row in rows.items():
        log(f"[kernels] {name} {key}: "
            f"{fmt({**row, 'bound': row['bound'][0]})}")
    return rows


def phase_kernels(torch, ptxas):
    """-> list of cases, each {kernel name: row}; the first case of each
    kernel is at the slice's shape."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_ce as CE
    attn = [
        ("slice [8,3,4096,128]", dict(g=8, hg=3, t=4096, dk=128, dv=128,
                                      lens=SLICE_LENS)),
        ("64x64-token segments [8,3,4096,128]",
         dict(g=8, hg=3, t=4096, dk=128, dv=128, lens=[64] * 64, seed=4)),
        ("ragged T=S=4000", dict(g=8, hg=3, t=4000, dk=128, dv=128,
                                 lens=[2500, 1000, 433], seed=1)),
        ("window=16 softcap=30", dict(g=2, hg=2, t=256, dk=64, dv=64,
                                      lens=[100, 90, 40], window=16,
                                      softcap=30.0, seed=2)),
        ("Dk=128 Dv=64", dict(g=2, hg=4, t=512, dk=128, dv=64,
                              lens=[300, 150, 33], seed=3)),
    ]
    cases = [fwd_case(torch, FA, name, **kw) for name, kw in attn]
    cases += [bwd_case(torch, FA, ptxas, name, **kw) for name, kw in attn]
    cases.append(ce_case(torch, CE, "CE [4096,128256]", t=4096, v=128256,
                         n_pad=76))
    cases.append(ce_case(torch, CE, "CE [512,4096]", t=512, v=4096,
                         n_pad=9, seed=1))
    # comparison launches are not the path's
    zero_counts()
    return cases


# ---------------------------------------------------------------------------
# 4. serve
# ---------------------------------------------------------------------------

def serve_pool(torch, cfg, params, rt, during=None):
    """The 8-request pool through `ServeEngine`, drained; launch counts
    are zeroed just before the drain and read just after.  ``during(eng,
    rids)``: a context manager kept open over the drain."""
    import numpy as np
    from repro_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(params, cfg, rt, ServeConfig(
        max_slots=8, max_context=4096, prefill_capacity=4096,
        collect_logits=True))
    rng = np.random.RandomState(0)
    rids = [eng.submit(rng.randint(0, cfg.vocab_size, n), NEW_TOKENS)
            for n in PROMPT_LENS]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if during is None
          else during(eng, rids)):
        eng.drain(max_steps=200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    waves = eng.stats["prefill_waves"]
    if waves < 2:
        raise AssertionError(f"expected >= 2 prefill waves, got {waves}")
    if launches["flash_fwd_carry"] != cfg.num_layers * waves:
        raise AssertionError(
            f"carry kernel launched {launches['flash_fwd_carry']} times, "
            f"want {cfg.num_layers} x {waves} prefill waves")
    if any(launches[n] for n in launches if n not in SERVE_KERNELS):
        raise AssertionError(f"serving launched a training kernel: "
                             f"{launches}")
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


def phase_serve(torch):
    """Full width and depth: counts, finiteness, and the engine against a
    float32 teacher-forced reference (rms gate, see below).  Then the same
    width cut to 2 layers, held element-wise at test_serve's tolerance."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    rt = Runtime(device="cuda")                 # attn_impl="flash"
    n_params = sum(x.numel() for x in leaves(params))
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
    ref = teacher_forced(torch, tree_map(lambda x: x.float(), params), cfg32,
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
    near_ties = 0
    for r in reqs2:
        ref2 = teacher_forced(torch, params2, cfg2, rt, r)
        got2 = np.stack(r.logits)
        err2 = max(err2, float(np.abs(got2 - ref2).max()))
        if not np.allclose(got2, ref2, atol=SERVE_TOL, rtol=SERVE_TOL):
            raise AssertionError(f"2-layer request {r.rid}: engine vs "
                                 f"teacher-forced logits differ by {err2}")
        # greedy tokens: the teacher-forced argmax (tests/test_serve.py),
        # but for near-ties that the logit hold above already covers
        for j, (tok, want) in enumerate(zip(r.generated, ref2.argmax(-1))):
            if tok == want:
                continue
            top2 = np.sort(ref2[j])[-2:]
            gap = float(top2[1] - top2[0])
            log(f"[serve] 2-layer request {r.rid} position {j}: engine "
                f"token {tok}, teacher-forced argmax {int(want)}, top-two "
                f"gap {gap}")
            if not gap < SERVE_TOL:
                raise AssertionError(
                    f"2-layer request {r.rid} position {j}: greedy token "
                    f"{tok} is not the teacher-forced argmax {int(want)} "
                    f"and the top-two gap {gap} is no near-tie")
            near_ties += 1
    res["layers2_max_abs_err"] = err2
    res["layers2_token_near_ties"] = near_ties
    res["layers2_carry_launches"] = launches2["flash_fwd_carry"]
    log(f"[serve] {fmt(res)}")
    return launches


# ---------------------------------------------------------------------------
# 5. train
# ---------------------------------------------------------------------------

def train_setup(cfg, *, tokens_per_step=16384, capacity=4096):
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    ds = SyntheticDataset("github", cfg.vocab_size,
                          tokens_per_step=tokens_per_step, context=4096)
    return GlobalScheduler(ds, cfg, capacity=capacity, hdp=1,
                           strategy="balance", use_offload=False)


def train_full(torch, cfg, steps=3, sched=None, tcfg=None, tag="train",
               want=None):
    """Full width and depth through `Trainer.train_step` (phase 5's
    scheduler and config unless given); per-wave launch counts through the
    trainer's telemetry hook (zeroed before the run, read after every
    wave), each held to ``want`` (default: llama3.2-3b's).  -> (launches,
    the run's record, its ledger records if the ledger is on)."""
    import numpy as np
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig

    sched = sched if sched is not None else train_setup(cfg)
    t0 = time.perf_counter()
    tr = Trainer(cfg, Runtime(device=DEVICE),
                 AdamWConfig(lr=3e-4, warmup_steps=0), sched,
                 tcfg if tcfg is not None else TrainerConfig(capacity=4096))
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, params + optimiser "
        f"state {torch.cuda.memory_allocated() / 1e9:.2f} GB, init "
        f"{time.perf_counter() - t0:.1f} s")
    waves = []

    def telemetry(wave_list, measured, fresh, wall_s=None):
        counts = read_counts()
        zero_counts()
        tokens = sum(p.length for w in wave_list for slot in w.slots
                     for p in slot)
        waves.append({"step": tr.step, "wall_s": wall_s, "fresh": fresh,
                      "tokens": tokens, "counts": counts})

    tr.telemetry_fn = telemetry
    torch.cuda.reset_peak_memory_stats()
    steps_out = []
    zero_counts()
    try:
        for _ in range(steps):
            rec = tr.train_step()
            nu = tr.last_numerics
            steps_out.append({**rec, "applied": nu["applied"],
                              "wave_losses": nu["wave_losses"]})
    finally:
        sched.stop()
    totals = read_counts()
    for w in waves:
        for name, n in w["counts"].items():
            totals[name] += n
    peak = tr.peak.high_water()     # over the ledger's per-wave resets

    for s in steps_out:
        if s["applied"] != 1:
            raise AssertionError(f"step {s['step']}: the guarded apply "
                                 f"skipped (applied = {s['applied']})")
        if not (np.isfinite(s["wave_losses"]).all()
                and np.isfinite(s["grad_norm"])):
            raise AssertionError(f"step {s['step']}: non-finite loss or "
                                 f"grad norm {s}")
    want = TRAIN_WAVE_LAUNCHES if want is None else want
    for i, w in enumerate(waves):
        if w["counts"] != want:
            raise AssertionError(f"wave {i} of step {w['step']}: launches "
                                 f"{w['counts']}, want {want}")
    warm = [w["wall_s"] for w in waves if not w["fresh"]]
    res = {"steps": len(steps_out),
           "waves_per_step": [s["waves"] for s in steps_out],
           "losses": [s["loss"] for s in steps_out],
           "grad_norms": [s["grad_norm"] for s in steps_out],
           "first_wave_ms": waves[0]["wall_s"] * 1e3,
           "warm_ms_per_wave": float(np.mean(warm)) * 1e3,
           "step_wall_s": [s["wall_s"] for s in steps_out],
           "tokens_per_step": [sum(w["tokens"] for w in waves
                                   if w["step"] == i) for i in range(steps)],
           "peak_mem_gb": peak / 1e9}
    if tr.offload_store is not None:
        res["pinned_host_gb"] = tr.offload_store.pinned_bytes / 1e9
    res["tokens_per_s_warm_steps"] = float(
        sum(res["tokens_per_step"][1:]) / sum(res["step_wall_s"][1:]))
    records = []
    if tr.ledger is not None:
        res["ledger"] = tr.ledger.summary()
        records = tr.ledger.recent(1024)
    log(f"[{tag}] {json.dumps(res)}")
    del tr
    torch.cuda.empty_cache()
    return totals, res, records


def train_layers2(torch, cfg):
    """One wave at full width cut to 2 layers: the kernel route (bf16,
    flash + fused CE) and the bf16 plain route against the float32 plain
    route (weights upcast, attn_impl="ref", plain CE)."""
    from repro_torch.data.loader import WaveMaterializer
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.train_step import make_accum_steps, zeros_accum
    from repro_torch.tree import leaves, tree_map

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    sched = train_setup(cfg2)
    plan = sched.plan_step(0)
    sched.stop()
    lw = WaveMaterializer(sched.ds, cfg2, 4096).materialize(0, plan.waves[0])
    batch = {k: torch.tensor(v, device=DEVICE) for k, v in lw.batch.items()}
    batch["denom"] = torch.tensor(float(plan.denom), device=DEVICE)
    params = init_params(cfg2, seed=0, device=DEVICE)

    def run(route_cfg, p, attn_impl):
        rt = Runtime(device=DEVICE, attn_impl=attn_impl)
        grad_step, _ = make_accum_steps(route_cfg, rt, AdamWConfig())
        acc, m = grad_step(p, zeros_accum(p), batch, rt)
        return m["loss"].item(), acc

    loss_k, g_k = run(cfg2, params, "flash")
    loss_b, g_b = run(cfg2, params, "ref")
    loss_32, g_32 = run(dataclasses.replace(cfg2, dtype="float32"),
                        tree_map(lambda x: x.float(), params), "ref")
    rel = [rel_l2(a, b) for a, b in zip(leaves(g_k), leaves(g_32))]
    rel_b = [rel_l2(a, b) for a, b in zip(leaves(g_b), leaves(g_32))]
    res = {"wave_tokens": int((lw.batch["seg"] > 0).sum()),
           "loss_kernel": loss_k, "loss_f32": loss_32, "loss_bf16_plain":
           loss_b, "loss_rel_err": abs(loss_k - loss_32) / abs(loss_32),
           "loss_rel_err_bf16_plain": abs(loss_b - loss_32) / abs(loss_32),
           "grad_rel_l2_max": max(rel), "grad_rel_l2_max_bf16_plain":
           max(rel_b), "n_leaves": len(rel)}
    log(f"[train] layers2 {fmt(res)}")
    if not res["loss_rel_err"] <= TRAIN_LOSS_TOL:
        raise AssertionError(f"2-layer loss: kernel route {loss_k} vs "
                             f"float32 {loss_32}")
    if not max(rel) <= TRAIN_GRAD_TOL:
        raise AssertionError(f"2-layer grads: relative L2 up to {max(rel)} "
                             f"against the float32 route")


def phase_train(torch):
    from repro_torch.configs.registry import get_config
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-3b")
    launches, _, _ = train_full(torch, cfg)
    train_layers2(torch, cfg)
    return launches


# ---------------------------------------------------------------------------
# 6. ring
# ---------------------------------------------------------------------------

def ring_case(torch, RC, card, comp, lw, seed):
    """The forward and backward ring at llama3.2-3b's attention widths
    through ThreadRanks(4), direct calls, against the single-rank flash
    route over each group's concatenated slices."""
    from repro_torch.parallel.comm import ThreadRanks
    x = RC.ring_inputs(lw, seed, DEVICE)
    want_live = RC.expected_launches(comp, lw.batch["seg"], lw.batch["pos"])
    zero_counts()
    got = ThreadRanks(RING_HDP).run(lambda c: RC.rank_ring(c, comp, x))
    torch.cuda.synchronize()
    launches = read_counts()
    table = [g[3] for g in got]
    if table != want_live:
        raise AssertionError(f"{comp}: the ring's live steps per rank "
                             f"{table}, the Python count {want_live}")
    for name in RING_KERNELS:
        if launches[name] != sum(want_live):
            raise AssertionError(f"{comp}: {name} launched "
                                 f"{launches[name]} times, want "
                                 f"{sum(want_live)} ({want_live} per rank)")
    if any(launches[n] for n in launches if n not in RING_KERNELS):
        raise AssertionError(f"{comp}: the ring launched {launches}")

    def single_rank():
        return {(st, g): RC.group_reference(comp, x, st, g)
                for st, g in {(st, g) for _, st, g in RC.groups(comp)}}

    errs = {}
    refs = single_rank()
    for r, start, g in RC.groups(comp):
        held = RC.hold_rank(f"{comp} rank {r}", got[r], refs[(start, g)],
                            r - start)
        for key, (err, rl2) in held.items():
            e = errs.setdefault(key, [0.0, 0.0])
            e[0], e[1] = max(e[0], err), max(e[1], rl2)
    del refs
    res = {"composition": list(comp), "live_per_rank": want_live,
           "launches": {n: launches[n] for n in RING_KERNELS},
           "ring_ms": time_ms(torch, lambda: ThreadRanks(RING_HDP).run(
               lambda c: RC.rank_ring(c, comp, x)), 3),
           "single_rank_ms": time_ms(torch, single_rank, 3),
           **{f"{k}_max_abs_err": v[0] for k, v in errs.items()},
           **{f"{k}_rel_l2": v[1] for k, v in errs.items()}}
    log(f"[ring] {card}: {fmt(res)}")
    return launches


def ring_model(torch, RC, cfg, waves, denom):
    """Full width and depth, random weights from seed 0: the forward loss
    of the (2, 2) wave at hdp = 4 through ThreadRanks(4) (each rank its
    slice; the shares summed) against the hdp = 1 forward of the same
    tokens, under no_grad; carry launches gated per layer."""
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.comm import ThreadRanks
    from repro_torch.parallel.sharding import Runtime
    comp = (2, 2)
    lw = waves[comp]
    batch = {k: torch.tensor(v, device=DEVICE) for k, v in lw.batch.items()}
    den = torch.tensor(float(denom), device=DEVICE)
    params = init_params(cfg, seed=0, device=DEVICE)
    c = RC.RING_CAP

    def rank_fn(comm):
        rt = Runtime(device=DEVICE, comm=comm, composition=comp)
        return RC.model_loss(params, cfg, rt, batch,
                             slice(comm.rank * c, (comm.rank + 1) * c), den)

    live = RC.expected_launches(comp, lw.batch["seg"], lw.batch["pos"])
    zero_counts()
    t0 = time.perf_counter()
    shares = ThreadRanks(RING_HDP).run(rank_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = cfg.num_layers * sum(live)
    if launches["flash_fwd_carry"] != want \
            or launches["fused_ce_fwd"] != RING_HDP:
        raise AssertionError(f"model ring: launches {launches}, want "
                             f"{want} carry ({cfg.num_layers} layers x "
                             f"{live}) and {RING_HDP} CE forward")
    loss1 = RC.model_loss(params, cfg, Runtime(device=DEVICE), batch,
                          slice(None), den)
    total = sum(shares)
    rel = abs(total - loss1) / abs(loss1)
    res = {"composition": list(comp), "loss_shares": shares,
           "loss_hdp4": total, "loss_hdp1": loss1, "rel_err": rel,
           "carry_launches": launches["flash_fwd_carry"],
           "wall_s_hdp4": wall}
    log(f"[ring] model {cfg.name} {cfg.num_layers} layers: {fmt(res)}")
    if not rel <= RC.LOSS_TOL:
        raise AssertionError(f"hdp=4 loss {total} vs hdp=1 {loss1}: "
                             f"relative error {rel}")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_ring(torch, card):
    """-> launches of the ring path, summed over its runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import ring_check as RC
    cfg = get_config("llama3.2-3b")
    waves, denom, comps = RC.planner_waves(cfg, RING_HDP)
    log(f"[ring] planner step 1 at hdp={RING_HDP}: waves {comps}")
    missing = set(RC.RING_COMPS) - set(waves)
    if missing:
        raise AssertionError(f"planner step 1 has no wave of {missing}")
    totals = {name: 0 for name, *_ in KERNELS}
    runs = [ring_case(torch, RC, card, comp, waves[comp], seed=10 + i)
            for i, comp in enumerate(RC.RING_COMPS)]
    runs.append(ring_model(torch, RC, cfg, waves, denom))
    for counts in runs:
        for name, n in counts.items():
            totals[name] += n
    log(f"[ring] launches {json.dumps(totals)}")
    return totals


# ---------------------------------------------------------------------------
# 7. hdp_train
# ---------------------------------------------------------------------------

HDP_LAYERS = 2                  # phase 7: llama3.2-3b's width, 2 layers
HDP_STEPS = 2
HDP_TOKENS, HDP_CONTEXT = 65536, 16384   # a step, as phase 6's planner
HDP_COMPS = [(4,), (1, 1, 1, 1), (2, 2), (1, 2, 1)]   # step 1 holds them
HDP_TIMEOUT_S = 240             # a rank left waiting in a collective fails


def hdp_rank(rank: int, store: str, ckpt_dir: str):
    """One rank of phases 7 and 10 (b), a process of its own on the one
    card (rank 0 is this script's process, the others are spawned): a
    gloo group through `HostStagedComm`.  Returns rank 0's results."""
    import datetime
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.comm import HostStagedComm
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=RING_HDP,
        rank=rank, timeout=datetime.timedelta(seconds=HDP_TIMEOUT_S))
    try:
        return hdp_train_rank(torch, HostStagedComm(), ckpt_dir)
    finally:
        dist.destroy_process_group()


def set_counts(counts: dict) -> None:
    for name, w in wrappers().items():
        w.launches = counts[name]


def hdp_reference(torch, tr, plan, step):
    """The hdp = 1 route (one rank, composition (1,), the same kernels)
    over every global wave of ``plan`` from the trainer's current
    parameters -> (wave losses, fp32 gradient sum, grad norm).  Its
    launches are not the path's: the counts are put back."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train import train_step as TS
    saved = read_counts()
    rt1 = Runtime(device=DEVICE)
    grad_step, _ = TS.make_accum_steps(tr.cfg, rt1, tr.opt_cfg)
    acc = TS.zeros_accum(tr.params)
    losses = []
    for wave in plan.waves:
        lw = tr.loader.materialize(step, wave)
        batch = {k: torch.tensor(v, device=DEVICE)
                 for k, v in lw.batch.items()}
        batch["denom"] = torch.tensor(float(plan.denom), device=DEVICE)
        acc, m = grad_step(tr.params, acc, batch, rt1)
        losses.append(m["loss"].item())
    gnorm = global_norm(acc).item()
    set_counts(saved)
    return losses, acc, gnorm


def bf16_ulp(torch, x):
    """One bf16 unit in the last place at the magnitude of ``x``."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def hdp_train_rank(torch, comm, ckpt_dir):
    """Phase 7 on one rank: the port's `Trainer` at hdp = 4 under ZeRO-1,
    2 steps; on rank 0 every step also runs the hdp = 1 route over the same
    global waves (`hdp_reference`).  At step 1 the reduced gradients are
    held to the reference's and the ZeRO-1 apply to the unsharded apply on
    those same gradients.  Then, if rank 0's phase 7 gates pass, phase 10
    (b) on the same trainers (`hdp_ckpt_rank`, checkpointing into
    ``ckpt_dir``).  Returns rank 0's numbers of both (None elsewhere)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    from repro_torch.launch import ring_check as RC
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import zero1
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves, tree_map

    rank, hdp = comm.rank, comm.size
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              num_layers=HDP_LAYERS)
    ds = SyntheticDataset("github", cfg.vocab_size,
                          tokens_per_step=HDP_TOKENS, context=HDP_CONTEXT)
    sched = GlobalScheduler(ds, cfg, capacity=RC.RING_CAP, hdp=hdp,
                            strategy="balance", use_offload=False)
    plans = []
    plan_step = sched.plan_step

    def recorded(step):
        plans.append(plan_step(step))
        return plans[-1]
    sched.plan_step = recorded
    opt = AdamWConfig(lr=3e-4, warmup_steps=0)
    tr = Trainer(cfg, Runtime(device=DEVICE, comm=comm), opt, sched,
                 TrainerConfig(capacity=RC.RING_CAP, calibrate=False,
                               ckpt_dir=ckpt_dir),
                 seed=0)
    held = {"ref_wave_losses": [], "ref_grad_norm": [], "grad_rel_l2": [],
            "apply_bf16_over_hold": 0, "apply_bf16_past_one_ulp": 0,
            "apply_bf16_past_one_ulp_max_abs": 0.0,
            "apply_state_max_err": 0.0}

    def gather_full(x, shape):
        """A fresh whole copy of leaf ``x`` (this rank's shard of a leaf of
        ``shape``, or the whole of a replicated one) on every rank."""
        dim = zero1.zero1_dim(shape, hdp)
        if dim is None:
            return x.clone()
        whole = torch.empty(shape, dtype=x.dtype, device=x.device)
        zero1.gather_leaf(whole, x, dim, comm)
        return whole

    def apply_step(params, state, acc):
        step = tr.step
        if rank == 0:
            losses, ref_acc, gnorm = hdp_reference(torch, tr, plans[-1],
                                                   step)
            held["ref_wave_losses"].append(losses)
            held["ref_grad_norm"].append(gnorm)
            torch.cuda.empty_cache()
        grads = TS.reduce_grads(acc, comm)
        if step != 1:
            return TS.apply_reduced(params, state, grads, opt, comm=comm,
                                    guard=True)
        # step 1: the reduced gradients, the state and the params before
        # the apply, gathered whole; rank 0 keeps them for the unsharded
        # apply and holds the gradients to the reference's
        full = {"grads": [], "master": [], "m": [], "v": []}
        for i, p in enumerate(leaves(params)):
            g = gather_full(leaves(grads)[i], p.shape)
            if rank == 0:
                held["grad_rel_l2"].append(rel_l2(g, leaves(ref_acc)[i]))
                full["grads"].append(g)
            for k in ("master", "m", "v"):
                x = gather_full(leaves(state[k])[i], p.shape)
                if rank == 0:
                    full[k].append(x)
        before = tree_map(lambda p: p.clone(), params) if rank == 0 \
            else None
        if rank == 0:
            del ref_acc
        out = TS.apply_reduced(params, state, grads, opt, comm=comm,
                               guard=True)
        if rank == 0:
            def tree(xs):
                it = iter(xs)
                return tree_map(lambda _: next(it), params)
            state1 = {"step": state["step"] - 1,
                      **{k: tree(full[k]) for k in ("master", "m", "v")}}
            TS.apply_reduced(before, state1, tree(full["grads"]), opt,
                             guard=True)
        for i, p in enumerate(leaves(params)):
            if rank == 0:
                want = leaves(before)[i].float()
                diff = (p.float() - want).abs()
                ulp = bf16_ulp(torch, want)
                held["apply_bf16_over_hold"] += int(
                    (diff > torch.clamp(ulp, min=APPLY_TOL)).sum())
                past = diff > ulp
                if bool(past.any()):
                    held["apply_bf16_past_one_ulp"] += int(past.sum())
                    held["apply_bf16_past_one_ulp_max_abs"] = max(
                        held["apply_bf16_past_one_ulp_max_abs"],
                        float(want[past].abs().max()))
            for k in ("master", "m", "v"):
                x = gather_full(leaves(state[k])[i], p.shape)
                if rank == 0:
                    want = leaves(state1[k])[i]
                    if not torch.allclose(x, want, atol=APPLY_TOL,
                                          rtol=APPLY_TOL):
                        held["apply_state_max_err"] = max(
                            held["apply_state_max_err"],
                            float((x - want).abs().max()))
        del before, full
        torch.cuda.empty_cache()
        return out

    plain_apply = tr.apply_step
    tr.apply_step = apply_step

    def same_as_rank0() -> float:
        same = True
        for p in leaves(tr.params):
            b = p.clone()
            comm.broadcast(b)
            same &= torch.equal(b, p)
        return float(same)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    recs, wave_losses, same, applied = [], [], [], []
    try:
        for _ in range(HDP_STEPS):
            recs.append(tr.train_step())
            wave_losses.append(list(tr.last_numerics["wave_losses"]))
            applied.append(tr.last_numerics["applied"])
            same.append(same_as_rank0())
        torch.cuda.synchronize()
        counts = read_counts()
        names = [n for n, *_ in KERNELS]
        mine = [counts[n] for n in names] + [
            torch.cuda.max_memory_allocated() / 1e9] + \
            [r["wall_s"] for r in recs] + same + applied
        got = comm.all_gather(torch.tensor(
            mine, dtype=torch.float64, device=DEVICE)).cpu().numpy()
        res = None
        if rank == 0:
            k, s = len(names), HDP_STEPS
            res = {
                "model": f"{cfg.name}, {cfg.num_layers} layers",
                "compositions": [[list(w.composition) for w in plan.waves]
                                 for plan in plans],
                "wave_losses": wave_losses, "ref_wave_losses":
                held["ref_wave_losses"],
                "grad_norms": [r["grad_norm"] for r in recs],
                "ref_grad_norms": held["ref_grad_norm"],
                "tokens_per_step": [r["tokens"] for r in recs],
                "grad_rel_l2_max_step1": max(held["grad_rel_l2"]),
                "apply_bf16_elements_over_hold": held["apply_bf16_over_hold"],
                "apply_bf16_elements_past_one_ulp":
                held["apply_bf16_past_one_ulp"],
                "apply_bf16_past_one_ulp_max_abs_value":
                held["apply_bf16_past_one_ulp_max_abs"],
                "apply_state_max_err_over_1e-6": held["apply_state_max_err"],
                "launches_per_rank": {n: got[:, i].astype(int).tolist()
                                      for i, n in enumerate(names)},
                "want_launches_per_rank": ring_launches_want(
                    tr, enumerate(plans), hdp),
                "peak_mem_gb_per_rank": got[:, k].tolist(),
                "step_wall_s_per_rank": got[:, k + 1:k + 1 + s].tolist(),
                "params_same_as_rank0":
                got[:, k + 1 + s:k + 1 + 2 * s].tolist(),
                "applied": got[:, k + 1 + 2 * s:].tolist()}
        # phase 10 (b) runs only on a trainer that passed phase 7's gates
        ok = comm.all_gather(torch.tensor(
            [float(rank == 0 and not hdp_gates(res))], dtype=torch.float64,
            device=DEVICE)).cpu().numpy()[0, 0]
        tr.apply_step = plain_apply
        ckpt = hdp_ckpt_rank(torch, comm, tr, plans) if ok else None
    finally:
        sched.stop()
    return (res, ckpt) if rank == 0 else None


def ring_launches_want(tr, step_plans, hdp) -> dict:
    """What each rank must launch over ``step_plans`` ((step, plan)
    pairs): per wave, layers x (1 + its live visiting blocks) carry
    launches in the forward and as many again in the remat recompute,
    layers x that dq and dkv, one CE each way."""
    from repro_torch.launch import ring_check as RC
    want = {n: [0] * hdp for n, *_ in KERNELS}
    for step, plan in step_plans:
        for wave in plan.waves:
            lw = tr.loader.materialize(step, wave)
            live = RC.expected_launches(
                tuple(wave.composition), lw.batch["seg"], lw.batch["pos"],
                c=RC.RING_CAP * wave.c_mult)
            for r in range(hdp):
                n = tr.cfg.num_layers * live[r]
                for name, add in (("flash_fwd_carry", 2 * n),
                                  ("flash_bwd_dq", n), ("flash_bwd_dkv", n),
                                  ("fused_ce_fwd", 1), ("fused_ce_bwd", 1)):
                    want[name][r] += add
    return want


def hdp_gates(res) -> list:
    """Phase 7's gates on rank 0's numbers -> what failed."""
    import numpy as np
    fails = []
    comps = {tuple(c) for c in res["compositions"][1]}
    if not set(HDP_COMPS) <= comps:
        fails.append(f"step 1 waves {res['compositions'][1]} lack "
                     f"{set(HDP_COMPS) - comps}")
    for step in range(HDP_STEPS):
        got, want = res["wave_losses"][step], res["ref_wave_losses"][step]
        rel = np.abs(np.subtract(got, want)) / np.abs(want)
        if not (len(got) == len(want) and np.all(rel <= TRAIN_LOSS_TOL)):
            fails.append(f"step {step} wave losses {got} vs hdp=1 {want}")
        g, w = res["grad_norms"][step], res["ref_grad_norms"][step]
        if not abs(g - w) <= TRAIN_LOSS_TOL * abs(w):
            fails.append(f"step {step} grad norm {g} vs hdp=1 {w}")
    if not res["grad_rel_l2_max_step1"] <= TRAIN_GRAD_TOL:
        fails.append(f"step-1 reduced gradients: relative L2 up to "
                     f"{res['grad_rel_l2_max_step1']} against hdp=1")
    if res["apply_bf16_elements_over_hold"] or \
            res["apply_state_max_err_over_1e-6"]:
        fails.append("the ZeRO-1 apply differs from the unsharded apply")
    if res["launches_per_rank"]["flash_fwd"] != [0] * RING_HDP:
        fails.append("the training path launched the finalising forward")
    for name, want in res["want_launches_per_rank"].items():
        if res["launches_per_rank"][name] != want:
            fails.append(f"{name} launches per rank "
                         f"{res['launches_per_rank'][name]}, want {want}")
    if np.any(np.asarray(res["params_same_as_rank0"]) != 1):
        fails.append("a rank's parameters differ from rank 0's")
    if np.any(np.asarray(res["applied"]) != 1):
        fails.append(f"applied {res['applied']}")
    return fails


def phase_hdp_train(torch, card):
    """Phase 7, and phase 10 (b) after its gates: 4 processes share the
    card, rank 0 this one.  -> (phase 7's launches, phase 10 (b)'s),
    each summed over the ranks."""
    import tempfile
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if mode.splitlines()[0].strip() != "Default":
        raise AssertionError(f"compute mode {mode!r}: the four rank "
                             f"processes cannot share the card")
    mp = torch.multiprocessing.get_context("spawn")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        store = str(Path(tmp) / "store")
        ckpt_dir = str(Path(tmp) / "ckpt")
        check_disk(ckpt_bytes(HDP_LAYERS), tmp)
        procs = [mp.Process(target=hdp_rank, args=(r, store, ckpt_dir),
                            daemon=True)
                 for r in range(1, RING_HDP)]
        for pr in procs:
            pr.start()
        try:
            res, ckpt = hdp_rank(0, store, ckpt_dir)
            for pr in procs:
                pr.join(HDP_TIMEOUT_S)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        codes = [pr.exitcode for pr in procs]
        if codes != [0] * len(procs):
            raise AssertionError(f"phase 7 rank exit codes {codes}")
    wall = time.perf_counter() - t0
    log(f"[hdp_train] {card}: 4 rank processes share this card (gloo "
        f"through host memory): the times below measure no card-to-card "
        f"transfer. {json.dumps({k: res[k] for k in ('peak_mem_gb_per_rank', 'step_wall_s_per_rank')})} "
        f"phase wall {wall:.1f} s")
    log(f"[hdp_train] {json.dumps(res)}")

    fails = hdp_gates(res)
    if fails:
        raise AssertionError("phase 7: " + "; ".join(fails))
    log(f"[ckpt] (b) hdp = 4 -> 1: {json.dumps(ckpt)}")
    fails = ckpt_b_gates(ckpt)
    if fails:
        raise AssertionError("phase 10 (b): " + "; ".join(fails))
    return ({name: int(sum(v)) for name, v in
             res["launches_per_rank"].items()}, ckpt["launches"])


# ---------------------------------------------------------------------------
# 8. offload
# ---------------------------------------------------------------------------

OFF_CONTEXT = 16384             # phase 8: github at context 16384, hdp = 1
OFF_STEPS = 3
OFF_COPY_BYTES = 256 * 2**20    # the pinned-copy bandwidth probe, each way


def offload_setup(cfg):
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    ds = SyntheticDataset("github", cfg.vocab_size, tokens_per_step=16384,
                          context=OFF_CONTEXT)
    return GlobalScheduler(ds, cfg, capacity=4096, hdp=1,
                           strategy="balance", use_offload=True)


def offload_plans(cfg):
    """Gate (a): the planner's first steps with Eq. 3's offload term; each
    wave's (composition, c_mult, r, k) is printed and one must offload."""
    from repro_torch.core.offload import offload_periods
    sched = offload_setup(cfg)
    try:
        plans = [sched.plan_step(s) for s in range(OFF_STEPS)]
    finally:
        sched.stop()
    rows = [[(list(w.composition), w.c_mult, w.offload_ratio,
              offload_periods(cfg, w.offload_ratio)) for w in p.waves]
            for p in plans]
    log(f"[offload] waves (composition, c_mult, r, k) by step: "
        f"{json.dumps(rows)}")
    if not any(r > 0 and k >= 1 for step in rows for _, _, r, k in step):
        raise AssertionError("(a) no wave of the plan offloads")
    return sched, plans


def pinned_bandwidth(torch) -> dict:
    """Bytes/s of a 256 MB copy each way between pinned host memory and
    the card (CUDA events, 5 copies after one)."""
    host = torch.empty(OFF_COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(OFF_COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    out = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        ms = time_ms(torch, lambda: dst.copy_(src, non_blocking=True), 5)
        out[name] = OFF_COPY_BYTES / (ms / 1e3)
    return out


def offload_routes(torch, cfg, sched, plan):
    """Gates (b)-(d) on step 0's first offloading wave, outside the
    Trainer (seed-0 weights): the same batch through ``grad_step`` under
    ``remat="full"`` and ``remat="offload"``, in the order full, offload,
    full, offload.  The fp32 accumulators of the first three runs all
    exist before the first, so the peaks share one baseline.  Then each
    route's forward alone, for the memory it holds until the backward.
    -> the wave's tuple, times, peaks, held bytes, copied bytes and the
    copy stream's busy time."""
    from repro_torch.core.offload import offload_periods
    from repro_torch.data.loader import WaveMaterializer
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import ledger
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.host_offload import HostOffload
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.train_step import (loss_fn, make_accum_steps,
                                              zeros_accum)
    from repro_torch.tree import leaves, tree_map

    wave = next(w for w in plan.waves
                if offload_periods(cfg, w.offload_ratio) >= 1)
    k = offload_periods(cfg, wave.offload_ratio)
    lw = WaveMaterializer(sched.ds, cfg, 4096).materialize(0, wave)
    batch = {key: torch.tensor(v, device=DEVICE)
             for key, v in lw.batch.items()}
    batch["denom"] = torch.tensor(float(plan.denom), device=DEVICE)
    t = batch["tokens"].shape[0]
    resid = t * cfg.d_model * 2          # one period's bf16 input residual
    rt_full = Runtime(device=DEVICE, remat="full")
    store = HostOffload(rt_full.device)
    rts = {"full": rt_full,
           "offload": Runtime(device=DEVICE, remat="offload",
                              offload_periods=k, offload_store=store)}
    params = init_params(cfg, seed=0, device=DEVICE)
    grad_step, _ = make_accum_steps(cfg, rt_full, AdamWConfig())
    accs = [zeros_accum(params) for _ in range(3)]

    def run(name, acc):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        moved = (store.d2h_bytes, store.h2d_bytes)
        t0 = time.perf_counter()
        _, m = grad_step(params, acc, batch, rts[name])
        loss = m["loss"].item()
        torch.cuda.synchronize()
        return {"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                "peak": torch.cuda.max_memory_allocated(),
                "d2h": store.d2h_bytes - moved[0],
                "h2d": store.h2d_bytes - moved[1]}

    full_a = run("full", accs[0])
    off = run("offload", accs[1])
    full_b = run("full", accs[2])
    bit_equal = off["loss"] == full_a["loss"] and all(
        torch.equal(a, b) for a, b in zip(leaves(accs[1]), leaves(accs[0])))
    full_repeats = full_b["loss"] == full_a["loss"] and all(
        torch.equal(a, b) for a, b in zip(leaves(accs[2]), leaves(accs[0])))
    spread = max(float((a - b).abs().max()) for a, b in
                 zip(leaves(accs[2]), leaves(accs[0])))
    err = max(float((a - b).abs().max()) for a, b in
              zip(leaves(accs[1]), leaves(accs[0])))
    del accs[:2]
    off_b = run("offload", accs[0])
    busy = store.busy_ms()
    del accs

    def held(name):
        """Device memory the forward leaves for the backward."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with torch.enable_grad():
            loss, _ = loss_fn(live, cfg, rts[name], batch)
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() - before

    held_bytes = {name: held(name) for name in ("full", "offload")}
    del params
    torch.cuda.empty_cache()
    pred = ledger.offload_dispatch_bytes(cfg, wave.offload_ratio, t)[0]
    return {"wave": [list(wave.composition), wave.c_mult,
                     wave.offload_ratio, k],
            "tokens": t, "resid_bytes": resid,
            "loss_full": full_a["loss"], "loss_offload": off["loss"],
            "bit_equal": bit_equal, "full_repeats_bitwise": full_repeats,
            "grad_max_abs_diff": err, "full_spread_max_abs": spread,
            "d2h_bytes": off["d2h"], "h2d_bytes": off["h2d"],
            "ledger_pred_bytes": pred,
            "peak_full_gb": full_a["peak"] / 1e9,
            "peak_offload_gb": off["peak"] / 1e9,
            "held_after_forward_full": held_bytes["full"],
            "held_after_forward_offload": held_bytes["offload"],
            "ms_full": [full_a["ms"], full_b["ms"]],
            "ms_offload": [off["ms"], off_b["ms"]],
            "copy_busy_ms": busy}


def offload_gates(cfg, res) -> list:
    fails = []
    k, resid = res["wave"][3], res["resid_bytes"]
    # (b) the copies are exact and the recompute is the same; if the
    # kernels are not run-to-run deterministic, the full route's own
    # spread over two runs is the hold
    if not res["bit_equal"] and (res["full_repeats_bitwise"]
                                 or res["grad_max_abs_diff"]
                                 > res["full_spread_max_abs"]):
        fails.append(f"(b) offload route off the full route: loss "
                     f"{res['loss_offload']} vs {res['loss_full']}, grads "
                     f"up to {res['grad_max_abs_diff']} (full route's own "
                     f"spread {res['full_spread_max_abs']})")
    # (c) exactly k period inputs each way; Eq. 3's continuous ratio
    # within half a period of the whole periods moved
    if not res["d2h_bytes"] == res["h2d_bytes"] == k * resid:
        fails.append(f"(c) moved {res['d2h_bytes']} / {res['h2d_bytes']} "
                     f"bytes, want {k} x {resid}")
    if not abs(res["ledger_pred_bytes"] - res["d2h_bytes"]) <= resid / 2:
        fails.append(f"(c) ledger predicts {res['ledger_pred_bytes']}, "
                     f"measured {res['d2h_bytes']}")
    # (d) what the forward leaves for the backward holds exactly k period
    # inputs fewer; the full route's peak falls in the loss's backward,
    # with every input resident beside logits and dlogits, but offloading
    # can move the wave's peak to the end of the backward, where the
    # per-period grads (201 MB a period here) have piled up and the
    # inputs are gone, so the peak must fall by half of the k inputs (on
    # an H100 80GB HBM3 at 700 W it fell by 20.97 of the 24: PERF.md)
    held = res["held_after_forward_full"] - res["held_after_forward_offload"]
    if held != k * resid:
        fails.append(f"(d) the forward holds {held} bytes less, want "
                     f"{k} x {resid}")
    saved = (res["peak_full_gb"] - res["peak_offload_gb"]) * 1e9
    if not saved >= k * resid / 2:
        fails.append(f"(d) peak lowered by {saved / 1e9:.3f} GB, want >= "
                     f"{k * resid / 2e9:.3f} GB (half of {k} periods)")
    return fails


def phase_offload(torch, card):
    """Phase 8 -> launches of the offload path's three trainer steps."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.core import offload as OF
    from repro_torch.core.offload import offload_periods
    from repro_torch.obs import ledger
    from repro_torch.train.trainer import TrainerConfig
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config("llama3.2-3b")
    sched, plans = offload_plans(cfg)
    bw = pinned_bandwidth(torch)
    res = offload_routes(torch, cfg, sched, plans[0])
    res["pinned_gb_s"] = {k: v / 1e9 for k, v in bw.items()}
    # Eq. 3's overlap bound for each offloading wave's longest sequence,
    # at the copy's reference constants and at this card's measured rate
    hw_card = OF.OffloadHW(d2h_bw=bw["d2h"], h2d_bw=bw["h2d"])
    bound_rows = []
    for i, p in enumerate(plans):
        for w in p.waves:
            if w.offload_ratio <= 0:
                continue
            seqs = {}
            for piece in (x for slot in w.slots for x in slot):
                seqs[piece.seq_id] = seqs.get(piece.seq_id, 0) + piece.length
            s = max(seqs.values())
            bound_rows.append({
                "step": i, "c_mult": w.c_mult, "r": w.offload_ratio, "s": s,
                "r_max_reference_hw": OF.max_overlap_ratio(
                    sched.spec.coeffs, s, OF.OffloadHW()),
                "r_max_this_card": OF.max_overlap_ratio(
                    sched.spec.coeffs, s, hw_card)})
    res["eq3_overlap_bound"] = bound_rows
    log(f"[offload] {card}: {json.dumps(res)}")
    fails = offload_gates(cfg, res)

    # (e) three Trainer steps with use_offload, the ledger on
    ledger.set_ledger_enabled(True)
    try:
        launches, run, records = train_full(
            torch, cfg, steps=OFF_STEPS, sched=offload_setup(cfg),
            tcfg=TrainerConfig(capacity=4096, use_offload=True,
                               calibrate=False), tag="offload")
    finally:
        ledger.set_ledger_enabled(False)
    waves = [w for p in plans for w in p.waves]
    if len(records) != len(waves):
        fails.append(f"(e) {len(records)} ledger records for "
                     f"{len(waves)} waves")
    for rec, w in zip(records, waves):
        k = offload_periods(cfg, w.offload_ratio)
        moved = k * 4096 * w.c_mult * cfg.d_model * 2
        if rec["comp"] != list(w.composition) or rec["c_mult"] != w.c_mult \
                or rec["meas"]["offload_d2h"] != moved \
                or rec["meas"]["offload_h2d"] != moved:
            fails.append(f"(e) ledger record {rec} for a wave of "
                         f"{w.composition} x{w.c_mult} r {w.offload_ratio}: "
                         f"want {moved} bytes each way")
    log(f"[offload] ledger records {json.dumps(records)}")
    log(f"[offload] phase wall {time.perf_counter() - t0:.1f} s")
    if fails:
        raise AssertionError("phase 8: " + "; ".join(fails))
    if not np.isfinite(run["losses"]).all():
        raise AssertionError(f"phase 8: losses {run['losses']}")
    return launches


# ---------------------------------------------------------------------------
# 9. hdp_serve
# ---------------------------------------------------------------------------

HDP_SERVE_CAP = 1024            # phase 9: prefill capacity a rank, so the
                                # 3000- and 1800-token prompts need groups
HDP_SERVE_SLOTS = (8, 6)        # "batch" (2 slots a rank), then "seq" (6
                                # slots, two requests in a second round)
HDP_SERVE_CONTEXT = 4096


def rank_counts_comm(comm):
    """``comm`` with this rank's own launch counts.  ThreadRanks runs one
    rank at a time and hands the card on only inside an exchange, so what
    the wrappers' counts gain between two of a rank's exchanges are its
    launches: ``.mine`` (``.finish()`` adds the stretch since its last
    exchange)."""
    from repro_torch.parallel.comm import HdpComm

    class RankCounts(HdpComm):
        def __init__(self):
            self.rank, self.size = comm.rank, comm.size
            self.mine = dict.fromkeys(read_counts(), 0)
            self._mark = read_counts()

        def finish(self):
            now = read_counts()
            for k in now:
                self.mine[k] += now[k] - self._mark[k]
            self._mark = now
            return self.mine

        def _exchange(self, fn):
            self.finish()
            out = fn()
            self._mark = read_counts()
            return out

        def ppermute_async(self, tensors, perm):
            return self._exchange(lambda: comm.ppermute_async(tensors, perm))

        def all_gather(self, x):
            return self._exchange(lambda: comm.all_gather(x))

    return RankCounts()


def hdp_serve_engine(torch, params, cfg, comm, slots, pool, during=None):
    """The pool through one rank's `ServeEngine`, drained -> its results,
    the plans it admitted with and (over several ranks) its launches.
    ``during(eng, rids)``: a context manager kept open over the drain."""
    from repro_torch.launch.profile_serve import tokens_and_logits
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train.serve_step import cache_bytes
    counts = None if comm is None else rank_counts_comm(comm)
    eng = ServeEngine(params, cfg, Runtime(device=DEVICE, comm=counts),
                      ServeConfig(max_slots=slots,
                                  max_context=HDP_SERVE_CONTEXT,
                                  prefill_capacity=HDP_SERVE_CAP,
                                  collect_logits=True))
    plans = []
    plan_pool = eng.service.plan_pool

    def recorded(lengths):
        plan = plan_pool(lengths)
        plans.append((list(lengths), plan))
        return plan
    eng.service.plan_pool = recorded
    rids = [eng.submit(p, NEW_TOKENS) for p in pool]
    with (contextlib.nullcontext() if during is None
          else during(eng, rids)):
        eng.drain(max_steps=200)
    reqs = [eng.pool.get(r) for r in rids]
    return {"out": tokens_and_logits(reqs), "errors": [r.error for r in reqs],
            "ttft_s": [r.t_first - r.t_submit for r in reqs],
            "decode_ms_per_wave": 1e3 * sum(r.decode_s for r in reqs)
            / eng.stats["decode_waves"],
            "prefill_log": eng.prefill_log, "plans": plans,
            "layout": eng.shard.layout, "slab_bytes": cache_bytes(eng.cache),
            "rids": rids,
            "launches": None if counts is None else counts.finish()}


def expected_serve_launches(cfg, plans) -> list:
    """Carry launches per rank: layers x (1 + the live visiting blocks) of
    each prefill wave, from the admitted plans' materialized seg/pos."""
    import numpy as np
    from repro_torch.data.loader import WaveMaterializer
    from repro_torch.launch import ring_check as RC
    from repro_torch.serve.engine import _PromptProvider
    want = [0] * RING_HDP
    for lengths, plan in plans:
        mat = WaveMaterializer(_PromptProvider(
            [np.zeros(n, np.int32) for n in lengths]), cfg, HDP_SERVE_CAP)
        for w in plan.waves:
            lw = mat.materialize(0, w)
            live = RC.expected_launches(tuple(w.composition),
                                        lw.batch["seg"], lw.batch["pos"],
                                        HDP_SERVE_CAP * w.c_mult)
            want = [a + cfg.num_layers * b for a, b in zip(want, live)]
    return want


def hdp_serve_case(torch, cfg, params, slots, pool):
    """One layout: the pool at hdp = 4 through ThreadRanks(4), gated; ->
    (its launches summed over the ranks, the printed results)."""
    import numpy as np
    from repro_torch.launch.profile_serve import (hold_to_single_rank,
                                                  ms_by_composition)
    from repro_torch.parallel.comm import ThreadRanks
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    runs = ThreadRanks(RING_HDP).run(lambda c: hdp_serve_engine(
        torch, params, cfg, c, slots, pool))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    one = hdp_serve_engine(torch, params, cfg, None, slots, pool)

    fails = []
    head = runs[0]
    comps = [tuple(w.composition) for _, p in head["plans"] for w in p.waves]
    if not any(max(c) > 1 for c in comps):
        fails.append(f"no wave with a group > 1: {comps}")
    want = expected_serve_launches(cfg, head["plans"])
    got = [r["launches"]["flash_fwd_carry"] for r in runs]
    if got != want:
        fails.append(f"carry launches per rank {got}, want {want}")
    if sum(got) != launches["flash_fwd_carry"]:
        fails.append(f"per-rank carry launches {got} do not sum to the "
                     f"wrappers' {launches['flash_fwd_carry']}")
    if any(launches[n] for n in launches if n not in SERVE_KERNELS):
        fails.append(f"serving launched a training kernel: {launches}")
    for r, run in enumerate(runs):
        if run["errors"] != [None] * len(pool):
            fails.append(f"rank {r}: request errors {run['errors']}")
        same = all(a[0] == b[0] and np.array_equal(a[1], b[1])
                   for a, b in zip(run["out"], head["out"]))
        if not same:
            fails.append(f"rank {r}: tokens or logits differ from rank 0's")
        if not np.isfinite(np.concatenate(
                [rows.ravel() for _, rows in run["out"]])).all():
            fails.append(f"rank {r}: non-finite logits")
    # each rank's slab: 28 layers x k/v x its slots x positions x 8 x 128
    # x 2 bytes (8 slots: 939,524,096 a rank, 3,758,096,384 / 4)
    b_loc, s_loc = (slots // RING_HDP, HDP_SERVE_CONTEXT) \
        if head["layout"] == "batch" else (slots, HDP_SERVE_CONTEXT // RING_HDP)
    slab = cfg.num_layers * 2 * b_loc * s_loc * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 2
    if [r["slab_bytes"] for r in runs] != [slab] * RING_HDP:
        fails.append(f"slab bytes {[r['slab_bytes'] for r in runs]}, want "
                     f"{slab} a rank")
    held = hold_to_single_rank(head["out"], one["out"])
    if held["faults"] or not held["rms"] <= SERVE_TOL:
        fails.append(f"against hdp = 1: {held}")
    res = {"slots": slots, "layout": head["layout"], "waves": comps,
           "carry_launches_by_rank": got, "want_by_rank": want,
           "prefill_ms_by_composition": ms_by_composition(
               head["prefill_log"]),
           "hdp1_prefill_ms_by_composition": ms_by_composition(
               one["prefill_log"]),
           "decode_ms_per_wave": head["decode_ms_per_wave"],
           "hdp1_decode_ms_per_wave": one["decode_ms_per_wave"],
           "ttft_s": head["ttft_s"], "hdp1_ttft_s": one["ttft_s"],
           "drain_s_hdp4": wall, "kv_slab_bytes_a_rank": slab,
           "card_peak_mem_gb_4_ranks": peak / 1e9,
           "vs_hdp1": held}
    return launches, res, fails


def phase_hdp_serve(torch, card):
    """Phase 9 -> launches of the hdp = 4 serving path, both layouts, summed
    over the ranks."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config("llama3.2-3b")
    params = init_params(cfg, seed=0, device=DEVICE)
    rng = np.random.RandomState(0)
    pool = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    totals = {name: 0 for name, *_ in KERNELS}
    fails = []
    for slots in HDP_SERVE_SLOTS:
        launches, res, bad = hdp_serve_case(torch, cfg, params, slots, pool)
        log(f"[hdp_serve] {card}: {json.dumps(res)}")
        fails += [f"{slots} slots: {f}" for f in bad]
        for name, n in launches.items():
            totals[name] += n
    del params
    torch.cuda.empty_cache()
    log(f"[hdp_serve] launches {json.dumps(totals)}, phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    if fails:
        raise AssertionError("phase 9: " + "; ".join(fails))
    return totals


# ---------------------------------------------------------------------------
# 10. ckpt
# ---------------------------------------------------------------------------

CKPT_LAYERS = 2                 # (a): llama3.2-3b's width, 2 layers
CKPT_HDP_TOL = 1e-3             # (b): hdp = 1 against hdp = 4, relative
                                # (the ring's loss hold,
                                # tests/test_ring_flash.py)


def ckpt_bytes(layers: int) -> int:
    """arrays.npz of llama3.2-3b at full width and ``layers`` layers:
    every parameter as float32, plus master, m and v (16 bytes each)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("llama3.2-3b")
    per_layer = (cfg.d_model * cfg.num_heads * cfg.head_dim * 2
                 + cfg.d_model * 2 * cfg.num_kv_heads * cfg.head_dim
                 + 3 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model)
    n = cfg.vocab_size * cfg.d_model + layers * per_layer + cfg.d_model
    return 16 * n


def check_disk(need: int, where) -> None:
    import shutil
    free = shutil.disk_usage(where).free
    log(f"[ckpt] {need / 1e9:.2f} GB of checkpoints under {where}: "
        f"{free / 1e9:.1f} GB free")
    if free < need * 1.05:
        raise AssertionError(f"phase 10: {need / 1e9:.2f} GB of "
                             f"checkpoints need more than the "
                             f"{free / 1e9:.1f} GB free under {where}")


def file_mismatches(torch, path: str, tr, comm) -> int:
    """Leaves of ``tr``'s params and optimiser state that differ from the
    checkpoint file at ``path`` (for the state: this rank's `zero1_dim`
    slice of the file's leaf), read one leaf at a time."""
    import numpy as np
    from repro_torch.ckpt.checkpoint import named_leaves
    from repro_torch.parallel import zero1
    hdp, rank = (1, 0) if comm is None else (comm.size, comm.rank)
    state = {k: dict(named_leaves(tr.opt_state[k]))
             for k in ("master", "m", "v")}
    bad = 0
    with np.load(path) as f:
        for key, p in named_leaves(tr.params):
            bad += not torch.equal(torch.from_numpy(f["params/" + key]),
                                   p.float().cpu())
            dim = zero1.zero1_dim(p.shape, hdp)
            for k in ("master", "m", "v"):
                x = torch.from_numpy(f[f"opt/{k}/{key}"])
                if dim is not None:
                    x = zero1.shard(x, dim, rank, hdp)
                bad += not torch.equal(x, state[k][key].cpu())
        bad += int(f["opt/step"]) != int(tr.opt_state["step"])
    return bad


def wave_launches_want(layers: int, waves: int) -> dict:
    """Launches of ``waves`` hdp = 1 training waves at ``layers`` layers."""
    return {n: waves * (2 * layers if n == "flash_fwd_carry" else
                        layers if n.startswith("flash_bwd") else
                        0 if n == "flash_fwd" else 1)
            for n, *_ in KERNELS}


def hdp_ckpt_rank(torch, comm, tr, plans):
    """Phase 10 (b) on one rank, after phase 7's 2 steps: the Trainers
    save at the end of ``run`` (every rank gathers, rank 0 writes); every
    rank holds its params and state shards to the file exactly; the four
    run step 3 at hdp = 4; rank 0 alone resumes the file in an hdp = 1
    Trainer, holds its state to the file and runs step 3.  -> rank 0's
    numbers (None elsewhere)."""
    import numpy as np
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    from repro_torch.launch import ring_check as RC
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    rank, hdp = comm.rank, comm.size
    names = [n for n, *_ in KERNELS]
    t0 = time.perf_counter()
    for _ in tr.run(0):             # the save at the end of run
        pass
    save_wall = time.perf_counter() - t0
    path = str(Path(tr.ckpt.dir) / f"step_{tr.step}" / "arrays.npz")
    bad = file_mismatches(torch, path, tr, comm)
    zero_counts()
    rec = tr.train_step()           # step 3 at hdp = 4
    torch.cuda.synchronize()
    counts = read_counts()
    got = comm.all_gather(torch.tensor(
        [bad] + [counts[n] for n in names], dtype=torch.float64,
        device=DEVICE)).cpu().numpy()
    out = None
    if rank == 0:
        sched = GlobalScheduler(tr.sched.ds, tr.cfg, capacity=RC.RING_CAP,
                                hdp=1, strategy="balance", use_offload=False)
        one = Trainer(tr.cfg, Runtime(device=DEVICE), tr.opt_cfg, sched,
                      TrainerConfig(capacity=RC.RING_CAP, calibrate=False,
                                    ckpt_dir=tr.ckpt.dir, ckpt_save=False))
        try:
            resumed = one.resume_if_possible()
            bad1 = file_mismatches(torch, path, one, None)
            zero_counts()
            rec1 = one.train_step()
            torch.cuda.synchronize()
            counts1 = read_counts()
        finally:
            sched.stop()
        want1 = wave_launches_want(tr.cfg.num_layers, rec1["waves"])
        launches = {n: int(got[:, 1 + i].sum()) + counts1[n]
                    for i, n in enumerate(names)}
        stats = tr.ckpt_stats
        out = {
            "step": rec["step"], "resumed": resumed,
            "resumed_at": one.ckpt_stats.get("resumed_at"),
            "gather_s": stats["gather_s"],
            "gathered_gb": stats["gathered_bytes"] / 1e9,
            "snapshot_s": stats["snapshot_s"], "write_s": stats["write_s"],
            "hash_s": stats["hash_s"], "file_gb": stats["bytes"] / 1e9,
            "save_wall_s": save_wall,
            "restore_s_hdp1": one.ckpt_stats["restore_s"],
            "leaves_unlike_the_file_per_rank": got[:, 0].astype(int).tolist(),
            "leaves_unlike_the_file_hdp1": bad1,
            "denom_hdp4": rec["tokens"], "denom_hdp1": rec1["tokens"],
            "loss_hdp4": rec["loss"], "loss_hdp1": rec1["loss"],
            "grad_norm_hdp4": rec["grad_norm"],
            "grad_norm_hdp1": rec1["grad_norm"],
            "compositions_hdp4": [list(w.composition)
                                  for w in plans[-1].waves],
            "waves_hdp1": rec1["waves"],
            "launches_per_rank": {n: got[:, 1 + i].astype(int).tolist()
                                  for i, n in enumerate(names)},
            "want_launches_per_rank": ring_launches_want(
                tr, [(tr.step - 1, plans[-1])], hdp),
            "launches_hdp1": counts1, "want_launches_hdp1": want1,
            "launches": launches}
        del one
        torch.cuda.empty_cache()
    comm.all_gather(torch.zeros(1, device=DEVICE))   # rank 0 is done
    return out


def ckpt_b_gates(res) -> list:
    fails = []
    if not res["resumed"] or res["resumed_at"] != res["step"] - 1:
        fails.append("the hdp = 1 Trainer did not resume the hdp = 4 step")
    if any(res["leaves_unlike_the_file_per_rank"]) or \
            res["leaves_unlike_the_file_hdp1"]:
        fails.append("a restored or live leaf differs from the file")
    if res["denom_hdp1"] != res["denom_hdp4"]:
        fails.append(f"denom {res['denom_hdp1']} at hdp = 1, "
                     f"{res['denom_hdp4']} at hdp = 4")
    for k in ("loss", "grad_norm"):
        a, b = res[f"{k}_hdp1"], res[f"{k}_hdp4"]
        if not abs(a - b) <= CKPT_HDP_TOL * abs(b):
            fails.append(f"{k} {a} at hdp = 1, {b} at hdp = 4")
    if res["launches_per_rank"] != res["want_launches_per_rank"]:
        fails.append(f"hdp = 4 launches {res['launches_per_rank']}, want "
                     f"{res['want_launches_per_rank']}")
    if res["launches_hdp1"] != res["want_launches_hdp1"]:
        fails.append(f"hdp = 1 launches {res['launches_hdp1']}, want "
                     f"{res['want_launches_hdp1']}")
    return fails


def ckpt_trainer(cfg, ckpt_dir, **tcfg):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    return Trainer(cfg, Runtime(device=DEVICE),
                   AdamWConfig(lr=3e-4, warmup_steps=0), train_setup(cfg),
                   TrainerConfig(capacity=4096, ckpt_dir=ckpt_dir,
                                 calibrate=False, **tcfg), seed=0)


def flip_middle_byte(path: str) -> None:
    import os
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def phase_ckpt(torch, card):
    """Phase 10 (a): checkpoint and resume at hdp = 1 through the kernels
    (see the module docstring).  -> its launches."""
    import io
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              num_layers=CKPT_LAYERS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        check_disk(2 * ckpt_bytes(CKPT_LAYERS), tmp)
        a = ckpt_trainer(cfg, tmp, ckpt_every=2)
        zero_counts()
        try:
            hist_a = list(a.run(3))
        finally:
            a.sched.stop()
        torch.cuda.synchronize()
        launches = read_counts()
        saved = dict(a.ckpt_stats)
        flip_middle_byte(str(Path(tmp) / "step_3" / "arrays.npz"))
        b = ckpt_trainer(cfg, tmp, ckpt_save=False)
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            resumed = b.resume_if_possible()
        log(f"[ckpt] resume: {said.getvalue().strip()}")
        path2 = str(Path(tmp) / "step_2" / "arrays.npz")
        res = {"model": f"{cfg.name}, {cfg.num_layers} layers",
               "resumed": resumed, "resumed_at": b.step,
               "skip_printed": "checkpoint step 3 skipped" in said.getvalue(),
               "latest_step": b.ckpt.latest_step(),
               "latest_valid_step": b.ckpt.latest_valid_step(),
               "leaves_unlike_the_file": file_mismatches(torch, path2, b,
                                                         None)}
        try:
            zero_counts()
            rec = b.train_step()
            torch.cuda.synchronize()
            counts_b = read_counts()

            def diff():
                return max(float((x.float() - y.float()).abs().max())
                           for x, y in zip(leaves(b.params),
                                           leaves(a.params)))
            res["max_abs_param_diff"] = diff()
            res["bit_equal"] = (rec["loss"] == hist_a[2]["loss"]
                                and rec["grad_norm"] == hist_a[2]["grad_norm"]
                                and res["max_abs_param_diff"] == 0.0)
            if not res["bit_equal"]:
                # phase 8's rule: within A's own spread over two runs of
                # the same step (a second resume of step 2 and step 3)
                b.resume_if_possible()
                b.train_step()
                res["own_spread_max_abs"] = diff()
        finally:
            b.sched.stop()
        for n, c in counts_b.items():
            launches[n] += c
        waves = sum(r["waves"] for r in hist_a) + rec["waves"]
        res.update({
            "losses_a": [r["loss"] for r in hist_a], "loss_b": rec["loss"],
            "grad_norm_a3": hist_a[2]["grad_norm"],
            "grad_norm_b": rec["grad_norm"],
            "snapshot_s": saved["snapshot_s"], "write_s": saved["write_s"],
            "hash_s": saved["hash_s"], "file_gb": saved["bytes"] / 1e9,
            "write_gb_per_s": saved["bytes"] / saved["write_s"] / 1e9,
            "restore_s": b.ckpt_stats["restore_s"],
            # the restore hashes damaged step 3, then hashes and reads 2
            "restore_read_gb_per_s": 3 * saved["bytes"]
            / b.ckpt_stats["restore_s"] / 1e9,
            "launches": launches,
            "want_launches": wave_launches_want(cfg.num_layers, waves)})
        del a, b
        torch.cuda.empty_cache()
    res["phase_wall_s"] = time.perf_counter() - t0
    log(f"[ckpt] (a) {card}: {json.dumps(res)}")
    fails = []
    if not (res["resumed"] and res["resumed_at"] == 2
            and res["skip_printed"] and res["latest_step"] == 3
            and res["latest_valid_step"] == 2):
        fails.append("the damaged step 3 was not skipped for step 2")
    if res["leaves_unlike_the_file"]:
        fails.append(f"{res['leaves_unlike_the_file']} restored leaves "
                     f"differ from the file")
    if not res["bit_equal"] and not (
            res["max_abs_param_diff"] <= res["own_spread_max_abs"]):
        fails.append(f"the resumed step 3 differs from the original by "
                     f"{res['max_abs_param_diff']}, beyond its own spread")
    if launches != res["want_launches"]:
        fails.append(f"launches {launches}, want {res['want_launches']}")
    if fails:
        raise AssertionError("phase 10 (a): " + "; ".join(fails))
    return launches


# ---------------------------------------------------------------------------
# 11. moe
# ---------------------------------------------------------------------------

MOE_ARCH = "mistral-8x7b"
MOE_ROWS = 4096                 # (a): rows through the MoE block alone
MOE_DROP_CF = 0.25              # (a): a capacity factor that drops pairs
MOE_SERVE_LAYERS = 8            # (b), (d): 11.9 G parameters, 23.7 GB
MOE_TRAIN_LAYERS = 2            # (c): 3.17 G parameters, ~57 GB of state


@contextlib.contextmanager
def moe_drop_counter(torch):
    """While open, counts on the device (no host sync) the (token, k)
    pairs the MoE drops of rows that are no padding: seg > 0 in a packed
    forward (its seg taken from `models/transformer.py::block_forward`,
    per thread, as `ThreadRanks` runs each rank in a thread of its own),
    every row of a decode slab.  Wraps `models/moe.py::moe_experts`;
    yields the count, a device tensor."""
    import threading
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    local = threading.local()
    experts, block = M.moe_experts, T.block_forward
    total = torch.zeros((), dtype=torch.int64, device=DEVICE)

    def block_forward(bp, cfg, rt, x, seg, pos, layer_idx, collect=None):
        local.seg = seg
        try:
            return block(bp, cfg, rt, x, seg, pos, layer_idx,
                         collect=collect)
        finally:
            local.seg = None

    def counted(params, cfg, x, gates, idx, pos, cap):
        dropped = pos >= cap
        seg = getattr(local, "seg", None)
        if seg is not None:
            dropped &= (seg > 0).repeat_interleave(cfg.moe.top_k)
        total.add_(dropped.sum())
        return experts(params, cfg, x, gates, idx, pos, cap)

    M.moe_experts, T.block_forward = counted, block_forward
    try:
        yield total
    finally:
        M.moe_experts, T.block_forward = experts, block


@contextlib.contextmanager
def moe_routes(torch, record=None, replay=None):
    """While open, `models/moe.py::moe_route` appends each call's top-k
    indices to ``record``; with ``replay`` each call takes its indices
    from the front of that list instead and its gates from its own fp32
    softmax at them (renormalised as the route does).  A replayed entry
    ``(idx, keep)`` also fixes the pairs the experts keep, ``keep`` [T, k],
    whatever this call's group and capacity: each kept pair gets a buffer
    row of its own (the capacity is T), the rest are dropped."""
    from repro_torch.models import moe as M
    route, experts = M.moe_route, M.moe_experts
    kept = []

    def routed(params, cfg, x):
        gates, idx = route(params, cfg, x)
        if replay is not None:
            idx = replay.pop(0)
            if isinstance(idx, tuple):
                idx, keep = idx
                kept.append(keep.reshape(-1))
            probs = torch.softmax(x.float() @ params["router"], dim=-1)
            gates = probs.gather(1, idx)
            if cfg.moe.router_norm_topk:
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        if record is not None:
            record.append(idx)
        return gates, idx

    def fixed(params, cfg, x, gates, idx, pos, cap):
        if kept:
            n = x.shape[0]
            pos = torch.where(kept.pop(0),
                              M.moe_positions(idx, cfg.moe.num_experts), n)
            cap = n
        return experts(params, cfg, x, gates, idx, pos, cap)

    M.moe_route, M.moe_experts = routed, fixed
    try:
        yield
    finally:
        M.moe_route, M.moe_experts = route, experts


def plain_keep(torch, idx, cap: int, num_experts: int):
    """The capacity rule by a loop over the experts: each keeps its first
    ``cap`` (token, k) pairs of idx [T, k] in token-major order -> [T, k]
    bool."""
    flat = idx.reshape(-1)
    kept = torch.zeros(flat.numel(), dtype=torch.bool, device=idx.device)
    for e in range(num_experts):
        kept[(flat == e).nonzero().squeeze(1)[:cap]] = True
    return kept.view(idx.shape)


def moe_plain(torch, p, cfg, x, idx, gates):
    """The MoE of x [T, d] in float32 by a loop over the experts, on the
    given top-k indices and gates, the pairs kept by `plain_keep` at the
    group's capacity.  -> (y [T, d] float32, the kept pairs [T, k])."""
    from repro_torch.models.moe import moe_capacity
    F = torch.nn.functional
    t, k = idx.shape
    kept = plain_keep(torch, idx, moe_capacity(cfg.moe, t),
                      cfg.moe.num_experts)
    xf = x.float()
    y = torch.zeros_like(xf)
    flat = idx.reshape(-1)
    w = gates.reshape(-1)
    for e in range(cfg.moe.num_experts):
        pairs = ((flat == e) & kept.reshape(-1)).nonzero().squeeze(1)
        tok = pairs // k
        xe = xf[tok]
        h = F.silu(xe @ p["w_gate"][e].float()) * (xe @ p["w_in"][e].float())
        y.index_add_(0, tok, (h @ p["w_out"][e].float()) * w[pairs, None])
    return y, kept


def moe_block_case(torch):
    """(a) The MoE block alone at full width, bf16, against `moe_plain`
    on the port's own routing -> (rows, failures).  Its bound: the
    weights, x and y moved once; the router's fp32 product at the fp32
    peak and the three expert GEMMs of the kept pairs (6·d·f operations
    each) at the bf16 peak."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as M
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    p = M.moe_init(gen, cfg, torch.bfloat16, DEVICE)
    x = torch.randn(MOE_ROWS, cfg.d_model, generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    rows, fails = [], []
    for cf in (cfg.moe.capacity_factor, MOE_DROP_CF):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        cap = M.moe_capacity(c.moe, MOE_ROWS)
        with torch.no_grad():
            got = M.moe_forward(p, c, x)
            gates, idx = M.moe_route(p, c, x)
            keep = (M.moe_positions(idx, c.moe.num_experts)
                    < cap).view(idx.shape)
            want, kept = moe_plain(torch, p, c, x, idx, gates)
            ms = time_ms(torch, lambda: M.moe_forward(p, c, x), 10)
            plain_ms = time_ms(torch, lambda: moe_plain(
                torch, p, c, x, idx, gates), 3)
        n_kept = int(keep.sum())
        router = 2 * MOE_ROWS * cfg.d_model * c.moe.num_experts  # fp32
        flops = (6 * n_kept * cfg.d_model * c.moe.d_expert
                 + router * PEAK_BF16_FLOPS / PEAK_FP32_FLOPS)
        nbytes = sum(v.numel() * v.element_size() for v in p.values()) \
            + x.numel() * x.element_size() + got.numel() * got.element_size()
        b_ms, b_by = bound(flops, nbytes)
        row = {"capacity_factor": cf, "capacity": cap, "kept_pairs": n_kept,
               "keep_equal": bool(torch.equal(keep, kept)),
               "dropped_frac": float(1 - keep.float().mean()),
               "rel_l2": rel_l2(got, want),
               "max_abs_err": float((got.float() - want).abs().max()),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        rows.append(row)
        if not row["keep_equal"]:
            fails.append(f"cf {cf}: keep masks differ from the plain loop's")
        if not row["rel_l2"] <= TOL:
            fails.append(f"cf {cf}: relative L2 {row['rel_l2']} > {TOL}")
        if cf < 1 and not row["dropped_frac"] > 0:
            fails.append(f"cf {cf}: no pair dropped")
    del p, x
    return rows, fails


@contextlib.contextmanager
def moe_record(torch, routes: dict, calls: list):
    """While open, the MoE layers of the engines drained under the yielded
    ``during(eng, rids)`` (each in a thread of its own) record what they
    computed: ``routes`` {(rid, position): [(top-k indices, kept pairs) of
    each layer, in order]} and ``calls`` [(rank, "prefill" | "decode",
    idx [n, k], keep [n, k]) of each call, on the host].  Rows are known
    by request and position: prefill rows by their wave's seg and pos
    (seg - 1 indexes ``rids``: the pool is admitted in one round), decode
    rows by their slot's request and position; padding rows and free
    slots route and take capacity as they would, and only ``calls`` holds
    them.  It reads rows back to the host, so it wraps no timed run."""
    import threading
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    local = threading.local()
    experts, block = M.moe_experts, T.block_forward

    def block_forward(bp, cfg, rt, x, seg, pos, layer_idx, collect=None):
        local.kind = "prefill"
        local.rows = [(local.rids[s - 1], p) if s > 0 else None
                      for s, p in zip(seg.tolist(), pos.tolist())]
        try:
            return block(bp, cfg, rt, x, seg, pos, layer_idx,
                         collect=collect)
        finally:
            local.rows = None

    def recorded(params, cfg, x, gates, idx, pos, cap):
        keep = (pos < cap).view(idx.shape).cpu()
        calls.append((local.rank, local.kind, idx.cpu(), keep))
        for key, i, kp in zip(local.rows, idx.tolist(), keep.tolist()):
            if key is not None:
                routes.setdefault(key, []).append((i, kp))
        return experts(params, cfg, x, gates, idx, pos, cap)

    @contextlib.contextmanager
    def during(eng, rids):
        decode = eng._decode
        sh = eng.shard
        mine = slice(sh.slot0, sh.slot0 + sh.slots) \
            if sh.layout == "batch" else slice(None)

        def decode_step(params, cache, tokens, pos):
            local.kind = "decode"
            local.rows = [None if r is None else (r.rid, int(p)) for r, p
                          in zip(eng._req[mine], eng._pos[mine])]
            try:
                return decode(params, cache, tokens, pos)
            finally:
                local.rows = None

        local.rids, local.rank = rids, eng._rank
        eng._decode = decode_step
        try:
            yield
        finally:
            eng._decode = decode

    M.moe_experts, T.block_forward = recorded, block_forward
    try:
        yield during
    finally:
        M.moe_experts, T.block_forward = experts, block


def moe_group_faults(torch, spec, calls: list) -> dict:
    """Each recorded call's kept pairs against `plain_keep` over the
    reference's group at its capacity: a prefill call's group is its own
    rows (the rank's rows of the wave); the n-th decode call of every rank
    together, in rank order, is the whole slab (at hdp = 1 the one rank's
    slab).  -> counts of groups and of those whose pairs differ."""
    from repro_torch.models.moe import moe_capacity
    groups = [(idx, keep) for _, kind, idx, keep in calls
              if kind == "prefill"]
    ranks = sorted({r for r, *_ in calls})
    dec = [[(idx, keep) for r_, kind, idx, keep in calls
            if kind == "decode" and r_ == r] for r in ranks]
    for parts in zip(*dec):
        groups.append((torch.cat([i for i, _ in parts]),
                       torch.cat([k for _, k in parts])))
    bad = sum(not torch.equal(keep, plain_keep(
        torch, idx, moe_capacity(spec, idx.shape[0]), spec.num_experts))
        for idx, keep in groups)
    return {"prefill_groups": len(groups) - len(dec[0]),
            "decode_slabs": len(dec[0]),
            "dropped_pairs": sum(int((~k).sum()) for _, k in groups),
            "groups_unlike_the_rule": bad}


def moe_hold_replayed(torch, params, cfg, reqs, routes: dict):
    """Each request's engine tokens and logits against its bf16
    teacher-forced forward replaying, row by row, the experts and the kept
    pairs the engine computed (``routes`` from `moe_record`): a capacity
    drop depends on the group a row routed in, and a routing margin within
    bf16's error flips an expert between two evaluations, so the replay
    holds the engine's own function.  Greedy tokens equal its argmax but
    for near-ties below SERVE_TOL (printed), logits within SERVE_TOL rms.
    -> (results, failures)."""
    import numpy as np
    from repro_torch.parallel.sharding import Runtime
    rt = Runtime(device=DEVICE)
    fails, ties, err, sq, cnt = [], 0, 0.0, 0.0, 0
    other, pairs, dropped = 0, 0, 0
    for r in reqs:
        n = r.plen + len(r.generated) - 1
        rows = [routes[r.rid, p] for p in range(n)]
        replay = [(torch.tensor([row[layer][0] for row in rows],
                                device=DEVICE),
                   torch.tensor([row[layer][1] for row in rows],
                                device=DEVICE))
                  for layer in range(cfg.num_layers)]
        dropped += sum(int((~keep).sum()) for _, keep in replay)
        with moe_routes(torch, replay=list(replay)):
            ref = teacher_forced(torch, params, cfg, rt, r)
        own = []
        with moe_routes(torch, record=own):
            teacher_forced(torch, params, cfg, rt, r)
        other += sum(int((torch.sort(a, -1)[0] != torch.sort(b, -1)[0])
                         .sum()) for (a, _), b in zip(replay, own))
        pairs += sum(a.numel() for a, _ in replay)
        diff = np.stack(r.logits) - ref
        err = max(err, float(np.abs(diff).max()))
        sq, cnt = sq + float((diff ** 2).sum()), cnt + diff.size
        for j, (tok, want) in enumerate(zip(r.generated, ref.argmax(-1))):
            if tok == want:
                continue
            top2 = np.sort(ref[j])[-2:]
            gap = float(top2[1] - top2[0])
            log(f"[moe] request {r.rid} position {j}: engine token {tok}, "
                f"teacher-forced argmax {int(want)}, top-two gap {gap}")
            if gap < SERVE_TOL:
                ties += 1
            else:
                fails.append(f"request {r.rid} position {j}: greedy token "
                             f"{tok} is not the teacher-forced argmax "
                             f"{int(want)} and the top-two gap {gap} is no "
                             f"near-tie")
    rms = (sq / cnt) ** 0.5
    if not rms <= SERVE_TOL:
        fails.append(f"logits against the replayed teacher-forced forward: "
                     f"rms {rms} > {SERVE_TOL}")
    return {"replayed_dropped_pairs": dropped,
            "teacher_forced_rms_err": rms,
            "teacher_forced_max_abs_err": err, "token_near_ties": ties,
            "own_routing_pairs_elsewhere_share": other / pairs}, fails


def same_out(a, b) -> bool:
    """Equal tokens and bit-equal logit rows, request by request."""
    import numpy as np
    return len(a) == len(b) and all(
        x[0] == y[0] and np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def moe_serve_case(torch, cfg, params):
    """(b) The 8-request pool at hdp = 1 at the config's capacity factor:
    phase 4's gates and times, the pairs of tokens dropped counted.  The
    drain again with its MoE calls recorded (bit-equal to the first):
    every call's kept pairs are the capacity rule's over the call's group,
    and every request is held by `moe_hold_replayed`.  -> (launches,
    results, failures)."""
    from repro_torch.launch.profile_serve import tokens_and_logits
    from repro_torch.parallel.sharding import Runtime
    rt = Runtime(device=DEVICE)
    with moe_drop_counter(torch) as drops:
        eng, reqs, launches, wall = serve_pool(torch, cfg, params, rt)
    peak = torch.cuda.max_memory_allocated()
    waves = eng.stats["prefill_waves"]
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    decode_s = sum(r.decode_s for r in reqs)
    res = {"layers": cfg.num_layers, "prefill_waves": waves,
           "carry_launches": launches["flash_fwd_carry"],
           "prefill_ms_per_wave": sum(r.prefill_s for r in reqs) / waves
           * 1e3,
           "decode_ms_per_wave": decode_s / eng.stats["decode_waves"] * 1e3,
           "decode_tokens_per_s": decode_tokens / decode_s,
           "drain_s": wall, "peak_mem_gb": peak / 1e9,
           "dropped_pairs_of_tokens": int(drops)}
    timed = tokens_and_logits(reqs)
    del eng, reqs

    routes, calls = {}, []
    with moe_record(torch, routes, calls) as during:
        eng, reqs, _, _ = serve_pool(torch, cfg, params, rt, during=during)
    fails = []
    if not same_out(tokens_and_logits(reqs), timed):
        fails.append("the recorded drain's tokens or logits differ from the "
                     "timed drain's")
    groups = moe_group_faults(torch, cfg.moe, calls)
    if groups["groups_unlike_the_rule"]:
        fails.append(f"kept pairs unlike the capacity rule: {groups}")
    held, bad = moe_hold_replayed(torch, params, cfg, reqs, routes)
    res.update({"groups": groups, **held})
    return launches, res, fails + bad


def moe_hdp_serve_case(torch, cfg, params):
    """(d) The pool at hdp = 4 through ThreadRanks(4), 8 slots ("batch"):
    phase 9's gates, but held to hdp = 1 only where neither run dropped a
    pair of a token.  The hdp = 4 drain again with its MoE calls recorded
    (bit-equal to the first): each rank's prefill calls keep the capacity
    rule's pairs over its own rows, the ranks' decode calls together over
    the whole slab, and every request is held by `moe_hold_replayed` ->
    (launches summed over the ranks, results, failures)."""
    import numpy as np
    from repro_torch.launch.profile_serve import (hold_to_single_rank,
                                                  ms_by_composition)
    from repro_torch.parallel.comm import ThreadRanks
    rng = np.random.RandomState(0)
    pool = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with moe_drop_counter(torch) as drops4:
        runs = ThreadRanks(RING_HDP).run(lambda c: hdp_serve_engine(
            torch, params, cfg, c, 8, pool))
        torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    with moe_drop_counter(torch) as drops1:
        one = hdp_serve_engine(torch, params, cfg, None, 8, pool)
    fails = []
    head = runs[0]
    if head["layout"] != "batch":
        fails.append(f"layout {head['layout']}, want batch")
    want = expected_serve_launches(cfg, head["plans"])
    got = [r["launches"]["flash_fwd_carry"] for r in runs]
    if got != want or sum(got) != launches["flash_fwd_carry"]:
        fails.append(f"carry launches per rank {got}, want {want} "
                     f"(wrappers: {launches['flash_fwd_carry']})")
    if any(launches[n] for n in launches if n not in SERVE_KERNELS):
        fails.append(f"serving launched a training kernel: {launches}")
    for r, run in enumerate(runs):
        if run["errors"] != [None] * len(pool):
            fails.append(f"rank {r}: request errors {run['errors']}")
        if not same_out(run["out"], head["out"]):
            fails.append(f"rank {r}: tokens or logits differ from rank 0's")
        if not np.isfinite(np.concatenate(
                [rows.ravel() for _, rows in run["out"]])).all():
            fails.append(f"rank {r}: non-finite logits")
    d4, d1 = int(drops4), int(drops1)
    held = None
    if d4 == 0 and d1 == 0:
        held = hold_to_single_rank(head["out"], one["out"])
        if held["faults"] or not held["rms"] <= SERVE_TOL:
            fails.append(f"against hdp = 1: {held}")
    zero_counts()

    routes, calls = {}, []
    with moe_record(torch, routes, calls) as during:
        again = ThreadRanks(RING_HDP).run(lambda c: hdp_serve_engine(
            torch, params, cfg, c, 8, pool, during=during))
    zero_counts()
    if not all(same_out(run["out"], head["out"]) for run in again):
        fails.append("the recorded drain's tokens or logits differ from the "
                     "timed drain's")
    groups = moe_group_faults(torch, cfg.moe, calls)
    if groups["groups_unlike_the_rule"]:
        fails.append(f"kept pairs unlike the capacity rule: {groups}")
    reqs = [types.SimpleNamespace(rid=rid, prompt=p, plen=len(p),
                                  generated=toks, logits=list(rows))
            for rid, p, (toks, rows) in zip(head["rids"], pool,
                                            head["out"])]
    replayed, bad = moe_hold_replayed(torch, params, cfg, reqs, routes)
    fails += bad
    res = {"slots": 8, "layout": head["layout"],
           "waves": [tuple(w.composition) for _, p in head["plans"]
                     for w in p.waves],
           "carry_launches_by_rank": got,
           "prefill_ms_by_composition": ms_by_composition(
               head["prefill_log"]),
           "hdp1_prefill_ms_by_composition": ms_by_composition(
               one["prefill_log"]),
           "decode_ms_per_wave": head["decode_ms_per_wave"],
           "hdp1_decode_ms_per_wave": one["decode_ms_per_wave"],
           "dropped_pairs_of_tokens_hdp4": d4,
           "dropped_pairs_of_tokens_hdp1": d1,
           "card_peak_mem_gb_4_ranks": peak / 1e9,
           "vs_hdp1": held if held is not None
           else "not held: a run dropped pairs of tokens",
           "groups": groups, **replayed}
    return launches, res, fails


def moe_train_wave(torch, cfg):
    """(c) One wave at full width cut to 2 layers: the kernel route
    (bf16) against the float32 plain route.  The routes' experts differ
    where a router margin sits within bf16's error, and a pair routed to
    another expert is another function, so the share of (token, k) pairs
    whose expert differs is printed from a free float32 forward, and the
    float32 route that is held replays the kernel route's expert choices
    (its gates its own): loss within TRAIN_LOSS_TOL, every gradient leaf
    within TRAIN_GRAD_TOL -> (results, failures)."""
    from repro_torch.data.loader import WaveMaterializer
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.train_step import (loss_fn, make_accum_steps,
                                              zeros_accum)
    from repro_torch.tree import leaves, tree_map

    sched = train_setup(cfg)
    plan = sched.plan_step(0)
    sched.stop()
    lw = WaveMaterializer(sched.ds, cfg, 4096).materialize(0, plan.waves[0])
    batch = {k: torch.tensor(v, device=DEVICE) for k, v in lw.batch.items()}
    batch["denom"] = torch.tensor(float(plan.denom), device=DEVICE)
    params = init_params(cfg, seed=0, device=DEVICE)
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def run(route_cfg, p, attn_impl):
        rt = Runtime(device=DEVICE, attn_impl=attn_impl)
        grad_step, _ = make_accum_steps(route_cfg, rt, AdamWConfig())
        acc, m = grad_step(p, zeros_accum(p), batch, rt)
        return m["loss"].item(), acc

    routes = []
    with moe_routes(torch, record=routes):
        loss_k, g_k = run(cfg, params, "flash")
    p32 = tree_map(lambda x: x.float(), params)
    del params
    free = []
    with moe_routes(torch, record=free), torch.no_grad():
        loss_free = loss_fn(p32, cfg32, Runtime(device=DEVICE,
                                                attn_impl="ref"),
                            batch)[0].item()
    k = cfg.moe.top_k
    differ = sum(int((torch.sort(a, -1)[0] != torch.sort(b, -1)[0])
                     .sum()) for a, b in zip(routes, free))
    pairs = sum(a.numel() for a in free)
    with moe_routes(torch, replay=list(routes)):
        loss_32, g_32 = run(cfg32, p32, "ref")
    rel = [rel_l2(a, b) for a, b in zip(leaves(g_k), leaves(g_32))]
    res = {"wave_tokens": int((lw.batch["seg"] > 0).sum()),
           "route_calls": len(routes), "top_k": k,
           "pairs_with_another_expert_share": differ / pairs,
           "loss_kernel": loss_k, "loss_f32_replayed": loss_32,
           "loss_f32_own_routing": loss_free,
           "loss_rel_err": abs(loss_k - loss_32) / abs(loss_32),
           "grad_rel_l2_max": max(rel), "n_leaves": len(rel)}
    fails = []
    if not res["loss_rel_err"] <= TRAIN_LOSS_TOL:
        fails.append(f"loss: kernel route {loss_k} vs float32 {loss_32}")
    if not max(rel) <= TRAIN_GRAD_TOL:
        fails.append(f"grads: relative L2 up to {max(rel)} against the "
                     f"float32 route")
    return res, fails


def phase_moe(torch, card):
    """Phase 11: Mistral-8x7B at full width -> the launches of its serving
    (hdp = 1 and 4) and training paths."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import leaves
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fails = []
    rows, bad = moe_block_case(torch)
    log(f"[moe] (a) {card}: MoE block [{MOE_ROWS}, 4096] bf16 vs the "
        f"float32 expert loop: {json.dumps(rows)}")
    fails += [f"(a) {f}" for f in bad]
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_SERVE_LAYERS)
    params = init_params(cfg, seed=0, device=DEVICE)
    n = sum(x.numel() for x in leaves(params))
    log(f"[moe] {cfg.name} at {cfg.num_layers} layers: {n / 1e9:.3f} G "
        f"params, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    totals = {name: 0 for name, *_ in KERNELS}
    for part, case in (("b", moe_serve_case), ("d", moe_hdp_serve_case)):
        launches, res, bad = case(torch, cfg, params)
        log(f"[moe] ({part}) {card}: {json.dumps(res)}")
        fails += [f"({part}) {f}" for f in bad]
        for name, c in launches.items():
            totals[name] += c
    del params
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(get_config(MOE_ARCH),
                               num_layers=MOE_TRAIN_LAYERS)
    launches, _, _ = train_full(
        torch, cfg2, tag="moe train",
        want=wave_launches_want(cfg2.num_layers, 1))
    for name, c in launches.items():
        totals[name] += c
    res, bad = moe_train_wave(torch, cfg2)
    log(f"[moe] (c) one wave {card}: {fmt(res)}")
    fails += [f"(c) {f}" for f in bad]
    zero_counts()
    torch.cuda.empty_cache()
    log(f"[moe] launches {json.dumps(totals)}, phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    if fails:
        raise AssertionError("phase 11: " + "; ".join(fails))
    return totals


# ---------------------------------------------------------------------------
# 12. report
# ---------------------------------------------------------------------------

def kernels_line(cases, serve_launches, train_launches, ring_launches,
                 hdp_launches, offload_launches, hdp_serve_launches,
                 ckpt_launches, moe_launches):
    """Launches: the serve path for the forward kernels, the train path for
    the rest, plus the ring path's, the hdp = 4 trainer's (summed over
    its ranks), the offloading trainer's, the hdp = 4 engine's (summed
    over its ranks), the checkpoint phase's and the MoE phase's."""
    rows = []
    for name, src, replaces, _, _ in KERNELS:
        mine = [c[name] for c in cases if name in c]
        head = mine[0]                       # the slice's shape
        ms, by = head["bound"]
        launches = serve_launches if name in SERVE_KERNELS \
            else train_launches
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": launches[name] + ring_launches[name]
            + hdp_launches[name] + offload_launches[name]
            + hdp_serve_launches[name] + ckpt_launches[name]
            + moe_launches[name],
            "max_abs_err": max(c["err"] for c in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": ms, "bound_by": by,
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
    card = phase_device(torch)
    ptxas = phase_build()
    cases = phase_kernels(torch, ptxas)
    log(f"[kernels] done at {time.perf_counter() - t0:.1f} s")
    serve_launches = phase_serve(torch)
    log(f"[serve] done at {time.perf_counter() - t0:.1f} s")
    train_launches = phase_train(torch)
    log(f"[train] done at {time.perf_counter() - t0:.1f} s")
    ring_launches = phase_ring(torch, card)
    log(f"[ring] done at {time.perf_counter() - t0:.1f} s")
    hdp_launches, ckpt_b_launches = phase_hdp_train(torch, card)
    log(f"[hdp_train] done at {time.perf_counter() - t0:.1f} s")
    offload_launches = phase_offload(torch, card)
    log(f"[offload] done at {time.perf_counter() - t0:.1f} s")
    hdp_serve_launches = phase_hdp_serve(torch, card)
    log(f"[hdp_serve] done at {time.perf_counter() - t0:.1f} s")
    ckpt_launches = phase_ckpt(torch, card)
    for name, n in ckpt_b_launches.items():
        ckpt_launches[name] += n
    log(f"[ckpt] done at {time.perf_counter() - t0:.1f} s")
    moe_launches = phase_moe(torch, card)
    log(f"[moe] done at {time.perf_counter() - t0:.1f} s")
    log(json.dumps(kernels_line(cases, serve_launches, train_launches,
                                ring_launches, hdp_launches,
                                offload_launches, hdp_serve_launches,
                                ckpt_launches, moe_launches)))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
