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
   kernel (Dk, Dv in 32, 64, 128), the (256, 256) instantiations of the
   carry and finalising forward, dq and dkv, and the (576, 512) ones
   (DeepSeek-V2's latent attention: `flash_fwd_mla_kernel<1>` and `<0>`,
   `flash_bwd_dq_mla_kernel`, `flash_bwd_dkv_mla_kernel`), and none of
   them spills.
3. kernels — holds each kernel against its plain PyTorch version on the
   card.  Flash forward: the slice's shape [8,3,4096,128] bf16 with packed
   segments (3000/900/120), padding rows and a non-zero carry-in; the
   skip-heavy case, 64 segments of 64 tokens at the same shape (only the
   diagonal tiles live); a ragged T=S=4000; a window=16/softcap=30 case;
   Dv=64 != Dk=128; and head dim 256 at the Gemma models' widths (G 8,
   Hg 2): T=S=8192 with segments 6000/2000/150 + padding, window 4096,
   softcap 50 (gemma2-9b's local layers over one prefill wave), and
   T=S=4096 with segments 3000/900/120, window 1024, no softcap
   (gemma3-12b's); and (Dk, Dv) = (576, 512) at deepseek-v2-lite's
   shape in the reference's gather mode (G 16 heads, Hg 1, each head's k
   the one latent and v its first 512 columns, scale 1/sqrt(192)):
   T=S=4096 with segments 3000/900/120 + padding.  Flash backward (dq,
   then dkv from dq's delta): the same eight cases from the forward
   kernel's (out, lse); dq's delta is
   held to rowsum(do * out) within 1e-4, and the Dk=128 Dv=64 case has
   Hg = 4, which the dq kernel's three heads per block do not divide.
   Each attention case prints the fraction of 64x64 tiles the kernels
   visit, from the port's tile predicate (`core/ring.py::tile_liveness`),
   and each forward and backward row its instantiation's ptxas
   registers and spills.  Fused cross-entropy forward and backward:
   [4096,128256] bf16 with padding rows (label 0, g = 0) and V=4096.
   Tolerance 2e-2 element-wise (bf16, the reference's kernel-test
   tolerance) and 2e-2 relative L2 per output;
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
   llama3.2-3b at full width cut to 1 layer (random weights from seed
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
   reference's format) at llama3.2-3b's width cut to 1 layer (seed 0):
   arrays.npz of 494.7 M parameters x 16 bytes (7.91 GB), under the
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
12. pipeline — pipeline parallelism (`parallel/pipeline.py`): the
   port's pipelined `Trainer` at 2 stages x hdp 2, llama3.2-3b at full
   width cut to 2 layers (1 a stage; seed 0), phase 7's data planned by
   PP-Balance (``mode="pp"``, ``num_stages=2``), rounds of at most 2
   waves (which bounds the logits the last stage keeps), 2 steps, the
   bytes ledger on.  Four processes share the card as in phase 7, a gloo
   world split by `parallel/comm.py::stage_grid` into two HDP groups and
   two stage groups of `HostStagedComm`.  Before each apply world rank 0
   gathers stage 1's window and runs the hdp = 1 route over the step's
   global waves from the whole tree: each round's loss within 1e-3
   relative of the sum of its waves' hdp = 1 losses, the grad norm within
   1e-2.  Exact launches per rank: per wave, the stage's layers x (1 +
   the live visiting blocks of its HDP position) carry launches in the
   forward and again in the recompute, as many dq and dkv, one CE each
   way on the last stage and none on stage 0.  Every round's measured
   ``pp`` and ring bytes exactly `obs/ledger.py::port_round_bytes`;
   within a stage the ranks' parameters bit-identical, and the
   replicated leaves (embed, final norm) bit-identical across the stages
   after every apply; applied == 1.  Prints ms per round by stage, the
   measured bubble share (1 - the stages' compute over ranks x the
   slowest rank's round wall, warm rounds) beside the analytic one
   (`pipeline_schedule_stats`), the ``pp`` bytes against the port's
   formula and the reference's prediction, and peaks by stage.  The four
   processes share one card, so the stages' compute overlaps on it and
   the measured bubble is not that of four cards.
13. gemma  — the Gemma-style decoders (local and global layers,
   softcaps, post-block and q/k norms, the embedding scale, head_dim 256
   in all four flash kernels), random weights from seed 0.  For
   gemma2-9b (42 layers, d 3584, 16/8 heads, vocab 256000; ~18.5 GB of
   bf16 weights) and then gemma3-12b (48 layers, d 3840, vocab 262144,
   ``lllllg``, window 1024): (a) served at full width and depth through
   `ServeEngine` at max_context and prefill capacity 8192: phase 4's 8
   prompts plus one of 6000 tokens (over gemma2's 4096 window, so the
   local layers mask and their ring buffers wrap), 16 new tokens each;
   phase 4's gates (the carry kernel layers x prefill waves times, no
   backward or CE kernel, finite logits), the cache positions a layer
   (the window in a local layer, 8192 in a global one), and the longest
   request's logits within an rms of 0.08 of a float32 teacher-forced
   forward (weights upcast a layer at a time); (b) the depth cut to one
   layer period (2 / 6 layers), every request held element-wise as phase
   4's 2-layer case; (c) trained at full width cut to 4 / 6 layers
   through `Trainer.train_step`: github at context and wave capacity
   8192, 16384 tokens a step, 3 steps, per wave exactly 2 x layers carry
   launches, layers dq and dkv, one CE each way; then the first wave at
   capacity 8192 (gemma3-12b: 4096, which its float32 route needs to fit
   the card) through the kernel route against the float32 plain route
   (phase 5's 1e-2 loss and 5e-2 per-leaf gates; the kernel route's
   gradients kept in host memory).  Prints the card, ms a wave, tokens/s
   and peaks.
14. mla    — DeepSeek-V2-Lite's Multi-head Latent Attention (the (576,
   512) flash kernels, the latent decode cache) and qwen3-moe-30b-a3b,
   random weights from seed 0.  (a) deepseek-v2-lite-16b at full width
   and depth (27 layers: a dense head layer, 26 MoE layers of 64 routed
   experts top-6 and 2 shared; 15.7 G parameters, 31.4 GB) served
   through `ServeEngine` at max_context and prefill capacity 8192: phase
   4's 8 prompts plus one of 5000 tokens, 16 new tokens each; phase 4's
   gates (the carry kernel 27 x prefill waves times); the pool drained
   again with its MoE calls recorded (phase 11's `moe_record`, bit-equal
   to the timed drain), every call's kept pairs the capacity rule's over
   its group, and every request held by `moe_hold_replayed` to a float32
   teacher-forced forward (weights upcast a layer at a time) replaying
   the engine's experts and kept pairs: tokens its argmax but at
   near-ties, logits within an rms of 0.08.  (b) trained at full width
   cut to 3 layers (the dense head layer and two MoE layers): 3 `Trainer`
   steps as phase 5's, exactly 5 carry (3 forward, 2 recomputed: the head
   layer runs outside the remat periods), 3 dq, 3 dkv and one CE each way
   a wave; then one wave held to the float32 plain route replaying the
   kernel route's experts (phase 11 (c)).  (c) qwen3-moe-30b-a3b at full
   width (128 experts top-8, q/k norms) served at 8 layers (phase 4's
   pool at 4096) with (a)'s holds and trained at 2 layers with (b)'s.
   Prints the card, prefill and decode ms a wave, decode tokens/s, the
   slab, tokens/s and peaks.
15. rwkv — rwkv6-7b (attention-free: the chunked WKV-6 time mix, token
   shift and channel mix, plain PyTorch; random weights from seed 0).
   (a) At full depth, 8 sequences of 256 tokens (seed 0): the packed
   forward of all 8 as one wave against 256 teacher-forced decode steps
   in 8 slots from an empty state (`make_decode_step`), in bf16: logits
   rms within 0.08, the greedy tokens' near-ties (forward's top-two gap
   under 0.08) and other disagreements counted; decode ms a step,
   tokens/s at 8 slots and at the largest slot count that fits in 60% of
   the free memory, the state a slot (its cache bytes, which must be
   `models/rwkv6.py::state_bytes`) and the peak.  The same in float32 at
   full depth: every logit within atol = rtol = 0.08 and the tokens equal
   but at near-ties.  bf16 at 2 layers: every logit within 0.08 but at
   each sequence's second and third tokens, whose error is printed (the
   group norm of a WKV output of rank one or two while the bonus is at
   its init 0 is ill-conditioned: bf16 rounding moves a few logits there
   past 0.08), and the tokens equal but at near-ties.  (b) 3 `Trainer`
   steps at 8 layers on phase 5's data: phase 5's checks with exactly one
   CE forward and backward a wave and no flash launch; the WKV-6 scan's
   own ms at a 4096-token wave (one layer, forward and forward +
   backward) and the 8 layers' share of a warm wave; one 2-layer wave:
   the loss within 1e-3 relative of the float32 plain route's, every
   gradient leaf within 5e-2 (relative L2) of float32's but the bonus's,
   within 0.1, and four lower-precision controls of the kernel route
   (bf16 projections, the scan's inputs and output in bf16, the group
   norm's input in bf16, every float32 leaf in bf16) each putting the
   bonus's gradient past 0.1.  (c) 2 layers, the planner's
   step-1 waves at hdp = 4 (phase 6's planner) of composition (4,) or (1,
   2, 1): the forward loss through `ThreadRanks(4)` within 1e-2 of hdp =
   1 over the same sequences laid contiguously, the measured "ring" bytes
   0 and one CE forward a rank; prints the state exchange's bytes a
   layer.  (d) Both CE kernels against their plain versions at [4096,
   65536] bf16 (phase 3's tolerances).
16. tp — tensor and expert parallelism (`parallel/tensor.py`,
   `models/moe.py`, the Trainer on an hdp x tp grid).  (a) llama3.2-3b
   at full width cut to 1 layer (seed
   0) on a 2 x 2 grid: four processes share the card as in phase 7, a
   gloo world split by `parallel/comm.py::tp_grid` (world rank h·2 + m)
   into HDP and model groups of `HostStagedComm`; phase 7's data at hdp
   2, its first step (5 waves).  Each rank holds its model rank's slices
   (12 of the 24 q heads and 4 of the 8 KV heads, half the MLP columns
   and of the vocabulary).  Exact launches per rank: per wave layers x (1 + the live
   visiting blocks of its HDP position) carry launches in the forward and
   again in the recompute, as many dq and dkv, one CE each way; every
   flash launch at the local (G, Hg) = (4, 3) and every CE launch over
   the local vocabulary, 64128 columns.  The replicated leaves
   bit-identical across each model group, every leaf across each HDP
   group after the apply, applied == 1.  Then the model-rank-0 processes
   train the same step at 2 x 1 from the same seed (not counted): the
   same plan, the step's and every wave's loss and the grad norm within
   1e-3 relative.  (c) In the same four processes after (a):
   Mistral-8x7B at full width (d 4096, 32/8 heads, 8 experts of 14336,
   vocab 32000) cut to 1 layer (1.713 G parameters), one step at 2 x 2
   with expert parallelism (each model rank 4 experts; the kernels at
   (G, Hg) = (4, 4), the CE over 16000 columns), held as (a) to 2 x 1
   from the same seed (the 2 x 2 Trainers freed first); besides (a)'s
   gates every MoE call's top-k indices (forward and recompute)
   identical across the model group.  (b) The TP-local kernel shapes
   against their plain versions (phase 3's 2e-2; not counted), forward
   and backward through `ring_attention`: model rank 1 of 2 of
   llama3.2-3b (12 heads over its 4 KV heads, (G, Hg) = (4, 3)),
   qwen3-moe-30b-a3b ((2, 8)) and gemma2-9b ((4, 2) at head dim 256,
   T 8192, window 4096, softcap 50), deepseek-v2-lite-16b's (576, 512)
   gather mode (8 heads over the one latent, G 8, Hg 1; the latent's
   gradient, a sum over the 8 heads, held in relative L2 and element-wise
   no worse than twice the bf16 plain route's error against float32),
   and llama's gather mode at tp 16 (KV replicated: model rank 5's 2 of
   the 32 padded heads over the [4096, 8, 128] KV, G 2, Hg 1).  Both CE
   kernels as model rank 1 of 2 runs them, at [4096, 64128] (llama) and
   [4096, 16000] (Mistral's shard, no multiple of 2048): labels shifted
   by the shard's first column, two thirds of them outside the shard
   (tgt exactly -1e30 there, onehot 0 in the backward), the backward
   from a global lse above the local one.  Prints the card, losses
   beside 2 x 1, peaks and step walls per rank.
17. grid — the Trainer on stages x HDP ranks x model ranks
   (`parallel/comm.py::grid`, world rank s·(hdp·tp) + h·tp + m) and
   RWKV-6 under tensor parallelism.  Four processes share the card as in
   phase 7, a gloo world of `HostStagedComm` split into 2 stages x hdp 1
   x tp 2.  (a) llama3.2-3b at full width cut to 2 layers (1 a stage;
   seed 0), phase 8's data (github at context 16384, 16384 tokens a
   step, capacity 4096) planned by PP-Balance with Eq. 3's offload term,
   one step with offload and the bytes ledger on, rounds of at most 2
   waves.  Before the apply world rank 0 gathers every rank's window and
   slices and runs the one-process route (hdp 1, tp 1, one stage, no
   offload) over the step's global waves: each round's loss within 1e-3
   relative of its waves', the grad norm within 1e-2.  Some round
   offloads (stage-local k > 0); every round's measured bytes exactly
   `obs/ledger.py::port_round_bytes` at tp 2 (one model rank's stage
   sends and offloaded periods); exact launches per rank (per wave 2 x
   the stage's layers carry, as many dq and dkv, one CE each way on the
   last stage only); the leaves the stages or the model ranks share
   bit-identical across them after the apply; applied == 1.  (b) In
   stage 0's two processes: rwkv6-7b at full width cut to 1 layer, one
   step on phase 5's data at hdp 1 x tp 2 (each rank 32 of the 64 WKV
   heads), then on model rank 0 the same step at tp 1 from the same seed
   (not counted): loss within 1e-3 relative, grad norm within 1e-2, one
   CE each way a wave on each rank, the replicated leaves (mix and decay
   LoRAs, norms) bit-identical across the model group.  Prints peaks,
   step walls and the phase wall.
18. report — one JSON line of every kernel (launches on the paths that
   run it: serve for the forward kernels, train for the rest, plus the
   ring's, the hdp = 4 trainer's, the offloading trainer's, the hdp = 4
   engine's, the checkpoint phase's, the MoE phase's, the pipelined
   trainer's, the Gemma phase's, the MLA phase's, the RWKV phase's, the
   2 x 2 grid's and the 2 x 1 x 2 grid's; errors, times, bounds), then
   the result line.

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
PP_LOSS_TOL = 1e-3              # phase 12's round losses against hdp = 1
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
# head dim 256 (Gemma-2 and Gemma-3): carry and finalising forward, dq, dkv
D256_KERNELS = {"flash_fwd_kernel<256,256,1>", "flash_fwd_kernel<256,256,0>",
                "flash_bwd_dq_kernel<256,256>",
                "flash_bwd_dkv_kernel<256,256>"}
# (Dk, Dv) = (576, 512), DeepSeek-V2's latent attention: kernels of their own
MLA_KERNELS = {"flash_fwd_mla_kernel<1>", "flash_fwd_mla_kernel<0>",
               "flash_bwd_dq_mla_kernel", "flash_bwd_dkv_mla_kernel"}
GATED_KERNELS = DQ_KERNELS | D256_KERNELS | MLA_KERNELS


def phase_build() -> dict:
    """-> {kernel<template args>: (registers, spill stores, spill loads)};
    raises if an instantiation of the dq kernel or one of the (256, 256)
    or (576, 512) instantiations is missing from the report or spills."""
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
    missing = GATED_KERNELS - set(report)
    if missing:
        raise AssertionError(f"no ptxas report for {sorted(missing)}")
    spills = {k: report[k] for k in GATED_KERNELS
              if report[k][1] or report[k][2]}
    if spills:
        raise AssertionError(f"a gated kernel spills: {spills}")
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


def attn_inputs(torch, g, hg, t, dk, dv, lens, seed, latent=False):
    """``latent``: the reference's MLA gather mode, every group's k the one
    latent [t, dk] and v its first dv columns."""
    import numpy as np
    rng = np.random.RandomState(seed)
    dev = "cuda"
    q = torch.tensor(rng.randn(g, hg, t, dk), dtype=torch.bfloat16,
                     device=dev)
    if latent:
        k = torch.tensor(rng.randn(t, dk), dtype=torch.bfloat16,
                         device=dev).expand(g, t, dk).contiguous()
        v = k[..., :dv].contiguous()
    else:
        k = torch.tensor(rng.randn(g, t, dk), dtype=torch.bfloat16,
                         device=dev)
        v = torch.tensor(rng.randn(g, t, dv), dtype=torch.bfloat16,
                         device=dev)
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
             softcap=0.0, seed=0, ptxas=None, scale=None, latent=False):
    """Both forward kernels (self-attention over one packed buffer); with
    the build report ``ptxas``, each row prints its instantiation's
    registers and spills.  ``scale`` defaults to 1/sqrt(dk)."""
    from repro_torch.core.attention import attention_mask
    rng, args, seg_np, pos_np = attn_inputs(torch, g, hg, t, dk, dv, lens,
                                            seed, latent)
    q, k, v, seg = args[:4]
    scale = dk ** -0.5 if scale is None else scale
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
        regs = "" if ptxas is None else " " + fmt(ptxas_of(
            ptxas, "flash_fwd", dk, dv, int(key == "flash_fwd_carry")))
        log(f"[kernels] {name} {key}: "
            f"{fmt({**row, 'bound': row['bound'][0], **extra})}{regs}")
    return rows


def ptxas_of(ptxas, kernel, dk, dv, *carry) -> dict:
    """Registers and spill bytes of the instantiation of ``kernel``
    (flash_fwd, flash_bwd_dq, flash_bwd_dkv) for (dk, dv[, carry]) in the
    build report; (576, 512) has kernels of its own.  Raises if the report
    lacks it."""
    if (dk, dv) == (576, 512):
        key = f"{kernel}_mla_kernel" + "".join(f"<{c}>" for c in carry)
    else:
        key = f"{kernel}_kernel<{','.join(map(str, (dk, dv, *carry)))}>"
    regs, st, ld = ptxas[key]
    return {"registers": regs, "spill_bytes": st + ld}


def bwd_case(torch, FA, ptxas, name, *, g, hg, t, dk, dv, lens, window=0,
             softcap=0.0, seed=0, scale=None, latent=False):
    """Both backward kernels from the forward kernel's (out, lse)."""
    rng, args, seg_np, pos_np = attn_inputs(torch, g, hg, t, dk, dv, lens,
                                            seed, latent)
    q, k, v = args[:3]
    scale = dk ** -0.5 if scale is None else scale
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
            f"{fmt(ptxas_of(ptxas, key, dk, dv))}")
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


# head dim 256 at the Gemma models' widths (8 kv heads, 2 q heads each):
# gemma2-9b's local layers (window 4096, softcap 50) over one prefill wave
# of phase 13's capacity, and gemma3-12b's (window 1024, no softcap)
D256_CASES = [
    ("gemma2 local [8,2,8192,256]", dict(
        g=8, hg=2, t=8192, dk=256, dv=256, lens=[6000, 2000, 150],
        window=4096, softcap=50.0, seed=5)),
    ("gemma3 local [8,2,4096,256]", dict(
        g=8, hg=2, t=4096, dk=256, dv=256, lens=[3000, 900, 120],
        window=1024, seed=6)),
]


# (576, 512) at deepseek-v2-lite's shape: 16 heads in the reference's
# gather mode (each head's k the one latent, v its first 512 columns),
# scale 1/sqrt(qk_nope 128 + qk_rope 64), the slice's segments
MLA_CASES = [
    ("deepseek-v2-lite MLA [16,1,4096,576/512]", dict(
        g=16, hg=1, t=4096, dk=576, dv=512, lens=SLICE_LENS, seed=7,
        scale=192 ** -0.5, latent=True)),
]


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
    attn += D256_CASES + MLA_CASES
    cases = [fwd_case(torch, FA, name, ptxas=ptxas, **kw)
             for name, kw in attn]
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

def serve_pool(torch, cfg, params, rt, during=None, *, lens=PROMPT_LENS,
               context=4096):
    """The pool of prompts of ``lens`` tokens (default phase 4's 8), one
    slot each, through `ServeEngine` at max_context and prefill capacity
    ``context``, drained; launch counts are zeroed just before the drain
    and read just after.  ``during(eng, rids)``: a context manager kept
    open over the drain."""
    import numpy as np
    from repro_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(params, cfg, rt, ServeConfig(
        max_slots=len(lens), max_context=context, prefill_capacity=context,
        collect_logits=True))
    rng = np.random.RandomState(0)
    rids = [eng.submit(rng.randint(0, cfg.vocab_size, n), NEW_TOKENS)
            for n in lens]
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


def hold_elementwise(torch, params, cfg, rt, reqs, tag):
    """Every request's logit rows element-wise against its bf16
    teacher-forced forward at test_serve's atol = rtol = 0.08, and its
    greedy tokens against that forward's argmax but at near-ties (top-two
    gap under 0.08, printed) -> (max abs error, near-ties)."""
    import numpy as np
    err = 0.0
    near_ties = 0
    for r in reqs:
        ref = teacher_forced(torch, params, cfg, rt, r)
        got = np.stack(r.logits)
        err = max(err, float(np.abs(got - ref).max()))
        if not np.allclose(got, ref, atol=SERVE_TOL, rtol=SERVE_TOL):
            raise AssertionError(f"{tag} request {r.rid}: engine vs "
                                 f"teacher-forced logits differ by {err}")
        # greedy tokens: the teacher-forced argmax (tests/test_serve.py),
        # but for near-ties that the logit hold above already covers
        for j, (tok, want) in enumerate(zip(r.generated, ref.argmax(-1))):
            if tok == want:
                continue
            top2 = np.sort(ref[j])[-2:]
            gap = float(top2[1] - top2[0])
            log(f"{tag} request {r.rid} position {j}: engine token {tok}, "
                f"teacher-forced argmax {int(want)}, top-two gap {gap}")
            if not gap < SERVE_TOL:
                raise AssertionError(
                    f"{tag} request {r.rid} position {j}: greedy token "
                    f"{tok} is not the teacher-forced argmax {int(want)} "
                    f"and the top-two gap {gap} is no near-tie")
            near_ties += 1
    return err, near_ties


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
    err2, near_ties = hold_elementwise(torch, params2, cfg2, rt, reqs2,
                                       "[serve] 2-layer")
    res["layers2_max_abs_err"] = err2
    res["layers2_token_near_ties"] = near_ties
    res["layers2_carry_launches"] = launches2["flash_fwd_carry"]
    log(f"[serve] {fmt(res)}")
    return launches


# ---------------------------------------------------------------------------
# 5. train
# ---------------------------------------------------------------------------

def train_setup(cfg, *, tokens_per_step=16384, capacity=4096, context=4096):
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    ds = SyntheticDataset("github", cfg.vocab_size,
                          tokens_per_step=tokens_per_step, context=context)
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


def train_hold(torch, cfg, *, layers=2, capacity=4096, tag="train",
               lean=False, grad_tols=None, controls=()):
    """One wave (the first of step 0 at wave capacity and context
    ``capacity``) at full width cut to ``layers`` layers: the kernel route
    (bf16, flash + fused CE) and, unless ``lean``, the bf16 plain route
    against the float32 plain route (weights upcast, attn_impl="ref",
    plain CE).  ``lean`` (phase 13's widths, where the float32 route's
    [8192, 262144] logits and their gradients take ~40 GB) keeps the
    kernel route's gradients in host memory and frees the bf16 weights
    before the float32 route.  Every gradient leaf of the kernel route is
    held within TRAIN_GRAD_TOL (relative L2) of float32, but a leaf whose
    name ends with a key of ``grad_tols``, held within that key's limit.
    ``controls`` are (name, leaf, patch) triples: the kernel route rerun
    inside ``patch(params)``, a context manager yielding the parameters
    of a deliberately lower-precision route; its gradient of ``leaf`` must
    stand outside that leaf's limit, or the limit would pass such a
    fault."""
    from repro_torch.ckpt.checkpoint import named_leaves
    from repro_torch.data.loader import WaveMaterializer
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.train_step import make_accum_steps, zeros_accum
    from repro_torch.tree import leaves, tree_map

    cfg2 = dataclasses.replace(cfg, num_layers=layers)
    sched = train_setup(cfg2, capacity=capacity, context=capacity)
    plan = sched.plan_step(0)
    sched.stop()
    lw = WaveMaterializer(sched.ds, cfg2, capacity).materialize(
        0, plan.waves[0])
    batch = {k: torch.tensor(v, device=DEVICE) for k, v in lw.batch.items()}
    batch["denom"] = torch.tensor(float(plan.denom), device=DEVICE)
    params = init_params(cfg2, seed=0, device=DEVICE)

    def run(route_cfg, p, attn_impl):
        rt = Runtime(device=DEVICE, attn_impl=attn_impl)
        grad_step, _ = make_accum_steps(route_cfg, rt, AdamWConfig())
        acc, m = grad_step(p, zeros_accum(p), batch, rt)
        return m["loss"].item(), acc

    loss_k, g_k = run(cfg2, params, "flash")
    res = {"wave_tokens": int((lw.batch["seg"] > 0).sum()),
           "loss_kernel": loss_k}
    if lean:
        g_k = tree_map(lambda x: x.cpu(), g_k)
    else:
        loss_b, g_b = run(cfg2, params, "ref")
    g_c = []
    for name, _, patch in controls:
        with patch(params) as p:
            g_c.append(run(cfg2, p, "flash")[1])
    params32 = tree_map(lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    loss_32, g_32 = run(dataclasses.replace(cfg2, dtype="float32"),
                        params32, "ref")
    name_of = {id(t): key for key, t in named_leaves(g_32)}
    names = [name_of[id(t)] for t in leaves(g_32)]
    tols = {n: next((v for k, v in (grad_tols or {}).items()
                     if n.endswith(k)), TRAIN_GRAD_TOL) for n in names}

    def rel_to_32(g):
        return {n: rel_l2(a, b.to(a.device)) for n, a, b in
                zip(names, leaves(g), leaves(g_32))}

    def worst(rel):
        return dict(sorted(rel.items(), key=lambda kv: kv[1])[-3:])

    rel = rel_to_32(g_k)
    res.update({"loss_f32": loss_32,
                "loss_rel_err": abs(loss_k - loss_32) / abs(loss_32),
                "grad_rel_l2_max": max(rel.values()), "n_leaves": len(rel),
                "grad_rel_l2_worst": worst(rel)})
    if not lean:
        rel_b = rel_to_32(g_b)
        res.update({"loss_bf16_plain": loss_b, "loss_rel_err_bf16_plain":
                    abs(loss_b - loss_32) / abs(loss_32),
                    "grad_rel_l2_max_bf16_plain": max(rel_b.values())})
    log(f"[{tag}] layers{layers} {fmt(res)}")
    fails = [f"{layers}-layer grads: {n} at relative L2 {r} from float32, "
             f"over {tols[n]}" for n, r in rel.items() if not r <= tols[n]]
    for (name, leaf, _), g in zip(controls, g_c):
        rel_c = rel_to_32(g)
        got = next(r for n, r in rel_c.items() if n.endswith(leaf))
        lim = next(tols[n] for n in names if n.endswith(leaf))
        res[f"control_{name}"] = got
        log(f"[{tag}] layers{layers} control {name}: {leaf} {got:.5g} from "
            f"float32 (limit {lim}); worst {json.dumps(worst(rel_c))}")
        if not got > lim:
            fails.append(f"control {name}: {leaf} {got} within its limit "
                         f"{lim}, which so cannot tell it from the reading")
    if not res["loss_rel_err"] <= TRAIN_LOSS_TOL:
        fails.append(f"{layers}-layer loss: kernel route {loss_k} vs "
                     f"float32 {loss_32}")
    if fails:
        raise AssertionError("; ".join(fails))
    return res


def phase_train(torch):
    from repro_torch.configs.registry import get_config
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-3b")
    launches, _, _ = train_full(torch, cfg)
    train_hold(torch, cfg)
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

HDP_LAYERS = 1                  # phase 7: llama3.2-3b's width, 1 layer
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


def hdp_reference(torch, tr, plan, step, params=None):
    """The hdp = 1 route (one rank, composition (1,), the same kernels)
    over every global wave of ``plan`` from ``params`` (default: the
    trainer's current parameters) -> (wave losses, fp32 gradient sum,
    grad norm).  Its launches are not the path's: the counts are put
    back."""
    params = tr.params if params is None else params
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train import train_step as TS
    saved = read_counts()
    rt1 = Runtime(device=DEVICE)
    grad_step, _ = TS.make_accum_steps(tr.cfg, rt1, tr.opt_cfg)
    acc = TS.zeros_accum(params)
    losses = []
    for wave in plan.waves:
        lw = tr.loader.materialize(step, wave)
        batch = {k: torch.tensor(v, device=DEVICE)
                 for k, v in lw.batch.items()}
        batch["denom"] = torch.tensor(float(plan.denom), device=DEVICE)
        acc, m = grad_step(params, acc, batch, rt1)
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

CKPT_LAYERS = 1                 # (a): llama3.2-3b's width, 1 layer
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

    def counted(params, cfg, x, gates, idx, pos, cap, *tp):
        dropped = pos >= cap
        seg = getattr(local, "seg", None)
        if seg is not None:
            dropped &= (seg > 0).repeat_interleave(cfg.moe.top_k)
        total.add_(dropped.sum())
        return experts(params, cfg, x, gates, idx, pos, cap, *tp)

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

    def fixed(params, cfg, x, gates, idx, pos, cap, *tp):
        if kept:
            n = x.shape[0]
            pos = torch.where(kept.pop(0),
                              M.moe_positions(idx, cfg.moe.num_experts), n)
            cap = n
        return experts(params, cfg, x, gates, idx, pos, cap, *tp)

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

    def recorded(params, cfg, x, gates, idx, pos, cap, *tp):
        keep = (pos < cap).view(idx.shape).cpu()
        calls.append((local.rank, local.kind, idx.cpu(), keep))
        for key, i, kp in zip(local.rows, idx.tolist(), keep.tolist()):
            if key is not None:
                routes.setdefault(key, []).append((i, kp))
        return experts(params, cfg, x, gates, idx, pos, cap, *tp)

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


def moe_hold_replayed(torch, params, cfg, reqs, routes: dict, f32=False):
    """Each request's engine tokens and logits against its bf16 (``f32``:
    float32, `teacher_forced_f32`) teacher-forced forward replaying, row
    by row, the experts and the kept pairs the engine computed (``routes``
    from `moe_record`, one entry per MoE layer): a capacity drop depends
    on the group a row routed in, and a routing margin within bf16's error
    flips an expert between two evaluations, so the replay holds the
    engine's own function.  Greedy tokens equal its argmax but for
    near-ties below SERVE_TOL (printed), logits within SERVE_TOL rms.
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
                  for layer in range(len(rows[0]))]
        dropped += sum(int((~keep).sum()) for _, keep in replay)

        def forward():
            if f32:
                return teacher_forced_f32(torch, params, cfg, r)
            return teacher_forced(torch, params, cfg, rt, r)
        with moe_routes(torch, replay=list(replay)):
            ref = forward()
        own = []
        with moe_routes(torch, record=own):
            forward()
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


def moe_serve_case(torch, cfg, params, *, lens=PROMPT_LENS, context=4096,
                   f32=False):
    """(b) The pool of ``lens`` (default phase 4's 8 requests) at hdp = 1
    at the config's capacity factor, max_context and prefill capacity
    ``context``: phase 4's gates and times, the slab, the pairs of tokens
    dropped counted.  The drain again with its MoE calls recorded
    (bit-equal to the first): every call's kept pairs are the capacity
    rule's over the call's group, and every request is held by
    `moe_hold_replayed` (``f32``: to the float32 teacher-forced forward).
    -> (launches, results, failures)."""
    from repro_torch.launch.profile_serve import tokens_and_logits
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.serve_step import cache_bytes
    rt = Runtime(device=DEVICE)
    with moe_drop_counter(torch) as drops:
        eng, reqs, launches, wall = serve_pool(torch, cfg, params, rt,
                                               lens=lens, context=context)
    peak = torch.cuda.max_memory_allocated()
    slab = cache_bytes(eng.cache)
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
           "slab_gb": slab / 1e9,
           "slab_bytes_per_token": slab / (len(lens) * context),
           "dropped_pairs_of_tokens": int(drops)}
    timed = tokens_and_logits(reqs)
    del eng, reqs
    torch.cuda.empty_cache()

    routes, calls = {}, []
    with moe_record(torch, routes, calls) as during:
        eng, reqs, _, _ = serve_pool(torch, cfg, params, rt, during=during,
                                     lens=lens, context=context)
    del eng
    torch.cuda.empty_cache()
    fails = []
    if not same_out(tokens_and_logits(reqs), timed):
        fails.append("the recorded drain's tokens or logits differ from the "
                     "timed drain's")
    groups = moe_group_faults(torch, cfg.moe, calls)
    if groups["groups_unlike_the_rule"]:
        fails.append(f"kept pairs unlike the capacity rule: {groups}")
    held, bad = moe_hold_replayed(torch, params, cfg, reqs, routes, f32=f32)
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
# 12. pipeline
# ---------------------------------------------------------------------------

PP_LAYERS = 2                   # llama3.2-3b's width, 1 period a stage
PP_STAGES, PP_HDP = 2, 2        # 4 processes on the one card
PP_STEPS = 2
PP_ROUND_WAVES = 2              # bounds the last stage's kept logits


def pp_rank(rank: int, store: str):
    """One rank of phase 12, a process of its own on the one card (world
    rank 0 is this script's process): a gloo world of 4 through
    `HostStagedComm`, split into 2 stages x hdp 2 by `stage_grid`.
    Returns world rank 0's results."""
    import datetime
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.comm import HostStagedComm, stage_grid
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{store}",
        world_size=PP_STAGES * PP_HDP, rank=rank,
        timeout=datetime.timedelta(seconds=HDP_TIMEOUT_S))
    try:
        return pp_train_rank(torch, *stage_grid(PP_STAGES, PP_HDP,
                                                HostStagedComm))
    finally:
        dist.destroy_process_group()


def world_gather(torch, comm, stage_comm, x):
    """Every rank's ``x`` -> [world, ...] in world order (s·hdp + h)."""
    for c in (comm, stage_comm):
        x = c.all_gather(x)
    return x.reshape(-1, *x.shape[2:])


def pp_want_launches(tr, step_plans) -> dict:
    """What each world rank must launch over ``step_plans`` ((step, plan,
    rounds) triples): per wave on stage s, its layers x (1 + the live
    visiting blocks of its HDP position) carry launches in the forward and
    as many in the remat recompute, as many dq and dkv; one CE each way
    on the last stage only."""
    from repro_torch.launch import ring_check as RC
    layers = tr.cfg.num_layers // PP_STAGES
    want = {n: [0] * (PP_STAGES * PP_HDP) for n, *_ in KERNELS}
    for step, plan in step_plans:
        for wave in plan.waves:
            lw = tr.loader.materialize(step, wave)
            live = RC.expected_launches(
                tuple(wave.composition), lw.batch["seg"], lw.batch["pos"],
                c=RC.RING_CAP * wave.c_mult)
            for s in range(PP_STAGES):
                last = s == PP_STAGES - 1
                for h in range(PP_HDP):
                    n = layers * live[h]
                    for name, add in (("flash_fwd_carry", 2 * n),
                                      ("flash_bwd_dq", n),
                                      ("flash_bwd_dkv", n),
                                      ("fused_ce_fwd", int(last)),
                                      ("fused_ce_bwd", int(last))):
                        want[name][s * PP_HDP + h] += add
    return want


def pp_train_rank(torch, comm, stage_comm):
    """Phase 12 on one rank: the port's pipelined `Trainer` at 2 stages x
    hdp 2, `PP_STEPS` steps with the bytes ledger on; before each apply
    world rank 0 gathers stage 1's window and runs the hdp = 1 route over
    the step's global waves from the whole tree (`hdp_reference`).
    Returns world rank 0's numbers (None elsewhere)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    from repro_torch.launch import ring_check as RC
    from repro_torch.obs import ledger
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.parallel.zero1 import stage_owned
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves, tree_map

    world = comm.rank + PP_HDP * stage_comm.rank
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              num_layers=PP_LAYERS)
    ds = SyntheticDataset("github", cfg.vocab_size,
                          tokens_per_step=HDP_TOKENS, context=HDP_CONTEXT)
    sched = GlobalScheduler(ds, cfg, capacity=RC.RING_CAP, hdp=PP_HDP,
                            strategy="balance", use_offload=False,
                            mode="pp", num_stages=PP_STAGES)
    plans = []
    plan_step = sched.plan_step

    def recorded(step):
        plans.append(plan_step(step))
        return plans[-1]
    sched.plan_step = recorded
    opt = AdamWConfig(lr=3e-4, warmup_steps=0)
    ledger.set_ledger_enabled(True)
    tr = Trainer(cfg, Runtime(device=DEVICE, comm=comm,
                              stage_comm=stage_comm), opt, sched,
                 TrainerConfig(capacity=RC.RING_CAP, calibrate=False,
                               mode="pp", max_round_waves=PP_ROUND_WAVES),
                 seed=0)
    owned = stage_owned(tr.params)
    ref = {"wave_losses": [], "grad_norm": []}

    def whole_tree():
        """Stage 1's window gathered to stage 0 (HDP position 0 only):
        the global tree at world rank 0."""
        if comm.rank != 0:
            return None
        got = []
        for p, o in zip(leaves(tr.params), owned):
            if not o:
                got.append(p)
                continue
            both = torch.empty((PP_STAGES, *p.shape), dtype=p.dtype,
                               device=p.device)
            stage_comm.all_gather_into(both.view(-1),
                                       p.contiguous().view(-1))
            got.append(both.flatten(0, 1))
        it = iter(got)
        return tree_map(lambda _: next(it), tr.params)

    plain_apply = tr.apply_step

    def apply_step(params, state, acc):
        full = whole_tree()
        if world == 0:
            losses, ref_acc, gnorm = hdp_reference(torch, tr, plans[-1],
                                                   tr.step, params=full)
            ref["wave_losses"].append(losses)
            ref["grad_norm"].append(gnorm)
            del ref_acc
        del full
        torch.cuda.empty_cache()
        return plain_apply(params, state, acc)
    tr.apply_step = apply_step

    def same_as(c) -> float:
        """Are this rank's (for the stage group: replicated) leaves
        bit-equal to those of rank 0 of group ``c``?"""
        same = True
        for p, o in zip(leaves(tr.params), owned):
            if c is stage_comm and o:
                continue
            b = p.clone()
            c.broadcast(b)
            same &= torch.equal(b, p)
        return float(same)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    recs, rounds, round_losses, round_s, busy_s = [], [], [], [], []
    same_stage, same_across, applied = [], [], []
    try:
        for _ in range(PP_STEPS):
            recs.append(tr.train_step())
            nu = tr.last_numerics
            rounds.append(nu["rounds"])
            round_losses.append(nu["round_losses"])
            round_s += nu["round_seconds"]
            busy_s += nu["round_busy_s"]
            applied.append(nu["applied"])
            same_stage.append(same_as(comm))
            same_across.append(same_as(stage_comm))
        torch.cuda.synchronize()
        counts = read_counts()
        recs_led = tr.ledger.recent(1024)
        names = [n for n, *_ in KERNELS]
        mine = [counts[n] for n in names] + [
            torch.cuda.max_memory_allocated() / 1e9] + \
            [r["wall_s"] for r in recs] + round_s + busy_s + same_stage \
            + same_across + applied
        got = world_gather(torch, comm, stage_comm, torch.tensor(
            mine, dtype=torch.float64, device=DEVICE)).cpu().numpy()
    finally:
        ledger.set_ledger_enabled(False)
        sched.stop()
    if world != 0:
        return None
    import numpy as np
    k, n_steps, n_rounds = len(names), PP_STEPS, len(round_s)
    col = k + 1 + n_steps
    # one ledger record a round, in order
    keys = [(tuple(r["comp"]), r["c_mult"], r["n_waves"]) for r in recs_led]
    fresh = [bool(r["fresh"]) for r in recs_led]
    secs = got[:, col:col + n_rounds]
    busy = got[:, col + n_rounds:col + 2 * n_rounds]
    warm = ~np.array(fresh)
    wall = secs[:, warm].max(axis=0)

    def by_stage(a):
        return [a[s * PP_HDP:(s + 1) * PP_HDP] for s in range(PP_STAGES)]
    ref_round_losses = [[float(np.sum([ref["wave_losses"][st][j]
                                       for j in ids])) for ids in rs]
                        for st, rs in enumerate(rounds)]
    c = RC.RING_CAP
    return {
        "model": f"{cfg.name}, {cfg.num_layers} layers, "
                 f"{PP_STAGES} stages x hdp {PP_HDP}",
        "compositions": [[list(w.composition) + [w.c_mult]
                          for w in plan.waves] for plan in plans],
        "rounds": rounds,
        "round_losses": round_losses,
        "ref_round_losses": ref_round_losses,
        "grad_norms": [r["grad_norm"] for r in recs],
        "ref_grad_norms": ref["grad_norm"],
        "bubble_analytic_by_step": [r["bubble_frac_pipeline"]
                                    for r in recs],
        "bubble_measured": 1.0 - float(busy[:, warm].sum())
        / (PP_STAGES * PP_HDP * float(wall.sum())) if warm.any() else None,
        "bubble_measured_by_stage": [
            1.0 - float(b[:, warm].sum()) / (PP_HDP * float(wall.sum()))
            for b in by_stage(busy)] if warm.any() else None,
        "ms_per_round_by_stage": [(a.max(axis=0) * 1e3).tolist()
                                  for a in by_stage(secs)],
        "round_fresh": fresh,
        "step_wall_s_per_rank": got[:, k + 1:col].tolist(),
        "peak_mem_gb_by_stage": [a.tolist() for a in
                                 by_stage(got[:, k])],
        "ledger_pp_pred": [r["pred"]["pp"] for r in recs_led],
        "ledger_pp_meas": [r["meas"]["pp"] for r in recs_led],
        "ledger_ring_meas": [r["meas"]["ring"] for r in recs_led],
        "port_formula": [ledger.port_round_bytes(
            cfg, comp, n, PP_STAGES, c * c_mult, PP_HDP)
            for comp, c_mult, n in keys],
        "launches_per_rank": {n: got[:, i].astype(int).tolist()
                              for i, n in enumerate(names)},
        "want_launches_per_rank": pp_want_launches(tr, enumerate(plans)),
        "params_same_within_stage":
        got[:, col + 2 * n_rounds:col + 2 * n_rounds + n_steps].tolist(),
        "replicated_same_across_stages":
        got[:, col + 2 * n_rounds + n_steps:
            col + 2 * n_rounds + 2 * n_steps].tolist(),
        "applied": got[:, col + 2 * n_rounds + 2 * n_steps:].tolist()}


def pp_gates(res) -> list:
    """Phase 12's gates on world rank 0's numbers -> what failed."""
    import numpy as np
    fails = []
    for step in range(PP_STEPS):
        got, want = res["round_losses"][step], res["ref_round_losses"][step]
        if not (len(got) == len(want) and np.all(np.isfinite(got))
                and np.all(np.abs(np.subtract(got, want))
                           <= PP_LOSS_TOL * np.abs(want))):
            fails.append(f"step {step} round losses {got} vs hdp=1 {want}")
        g, w = res["grad_norms"][step], res["ref_grad_norms"][step]
        if not abs(g - w) <= TRAIN_LOSS_TOL * abs(w):
            fails.append(f"step {step} grad norm {g} vs hdp=1 {w}")
    if not any(len(r) > 1 for rs in res["rounds"] for r in rs):
        fails.append("no round of more than one wave")
    for name, want in res["want_launches_per_rank"].items():
        if res["launches_per_rank"][name] != want:
            fails.append(f"{name} launches per rank "
                         f"{res['launches_per_rank'][name]}, want {want}")
    if any(res["launches_per_rank"][n][h] for n in ("fused_ce_fwd",
                                                     "fused_ce_bwd")
           for h in range(PP_HDP)):
        fails.append("stage 0 launched a cross-entropy kernel")
    for got, want in zip(res["ledger_pp_meas"], res["port_formula"]):
        if got != want["pp"]:
            fails.append(f"measured pp bytes {got}, formula {want['pp']}")
    for got, want in zip(res["ledger_ring_meas"], res["port_formula"]):
        if got != want["ring"]:
            fails.append(f"measured ring bytes {got}, formula "
                         f"{want['ring']}")
    for key in ("params_same_within_stage", "replicated_same_across_stages",
                "applied"):
        if np.any(np.asarray(res[key]) != 1):
            fails.append(f"{key} {res[key]}")
    return fails


def phase_pipeline(torch, card):
    """Phase 12: 4 processes share the card, world rank 0 this one.  ->
    its launches, summed over the ranks."""
    import tempfile
    mp = torch.multiprocessing.get_context("spawn")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        store = str(Path(tmp) / "store")
        procs = [mp.Process(target=pp_rank, args=(r, store), daemon=True)
                 for r in range(1, PP_STAGES * PP_HDP)]
        for pr in procs:
            pr.start()
        try:
            res = pp_rank(0, store)
            for pr in procs:
                pr.join(HDP_TIMEOUT_S)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        codes = [pr.exitcode for pr in procs]
        if codes != [0] * len(procs):
            raise AssertionError(f"phase 12 rank exit codes {codes}")
    wall = time.perf_counter() - t0
    shown = ("ms_per_round_by_stage", "bubble_measured",
             "bubble_measured_by_stage", "bubble_analytic_by_step",
             "peak_mem_gb_by_stage")
    log(f"[pipeline] {card}: 4 rank processes share this card (gloo "
        f"through host memory), so the stages' compute overlaps on one "
        f"device and the bubble shares below are not those of 4 cards. "
        f"{json.dumps({k: res[k] for k in shown})} phase wall {wall:.1f} s")
    log(f"[pipeline] pp bytes a round: measured "
        f"{res['ledger_pp_meas']}, the port's formula "
        f"{[f['pp'] for f in res['port_formula']]}, the reference's "
        f"prediction {res['ledger_pp_pred']}")
    log(f"[pipeline] {json.dumps(res)}")
    fails = pp_gates(res)
    if fails:
        raise AssertionError("phase 12: " + "; ".join(fails))
    return {name: int(sum(v)) for name, v in
            res["launches_per_rank"].items()}


# ---------------------------------------------------------------------------
# 13. gemma
# ---------------------------------------------------------------------------

GEMMA_CONTEXT = 8192            # max_context, prefill and wave capacity
GEMMA_LONG = 6000               # a prompt over gemma2-9b's 4096 window
# (serving cut: one layer period; training depth; the float32 hold's wave
# capacity: at 8192, gemma3-12b's float32 route, its [8192, 262144] logits
# and their gradients (~43 GB) beside 19 GB of float32 weights and
# gradients, ran out of the card's memory)
GEMMA_CUTS = {"gemma2-9b": (2, 4, 8192), "gemma3-12b": (6, 6, 4096)}


def teacher_forced_f32(torch, params, cfg, req):
    """Logit rows of one request from a float32 packed forward over its
    prompt and generated tokens (plain attention), the weights upcast one
    layer at a time (the head blocks first): a float32 copy of gemma3-12b
    whole would take 47 GB beside its bf16 weights."""
    import numpy as np
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.tree import tree_map
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rt = Runtime(device=DEVICE, attn_impl="ref")
    toks = np.concatenate([req.prompt, np.asarray(req.generated[:-1])])
    n = len(toks)
    with torch.inference_mode():
        seg = torch.ones(n, dtype=torch.int32, device=DEVICE)
        pos = torch.arange(n, dtype=torch.int32, device=DEVICE)
        emb = {name: params[name].float() for name in ("embed", "lm_head")
               if name in params}
        x = T.embed_tokens(emb, cfg32, torch.tensor(toks, dtype=torch.int32,
                                                    device=DEVICE))
        for i, bp in enumerate(params["head_blocks"]):
            x = T.block_forward(tree_map(lambda a: a.float(), bp), cfg32, rt,
                                x, seg, pos, i)
        head_n = len(params["head_blocks"])
        period = len(cfg.layer_pattern)
        for i in range((cfg.num_layers - head_n) // period):
            for j in range(period):
                bp = tree_map(lambda a: a.float(),
                              T._index(params["blocks"][j], i))
                x = T.block_forward(bp, cfg32, rt, x, seg, pos, head_n + j)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return T.logits_head(emb, cfg32, x[req.plen - 1:]).cpu().numpy()


def gemma_serve(torch, cfg, tag):
    """Full width and depth: phase 4's pool plus one GEMMA_LONG-token
    prompt at max_context and prefill capacity GEMMA_CONTEXT, held as
    phase 4 holds it (counts, finiteness, the longest request's rms to a
    float32 teacher-forced forward); then the depth cut to one layer
    period, every request held element-wise -> (launches, results)."""
    import numpy as np
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.serve_step import cache_bytes
    from repro_torch.tree import leaves

    lens = PROMPT_LENS + [GEMMA_LONG]
    rt = Runtime(device=DEVICE)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in leaves(params))
    log(f"{tag} {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    eng, reqs, launches, wall = serve_pool(torch, cfg, params, rt, lens=lens,
                                           context=GEMMA_CONTEXT)
    peak = torch.cuda.max_memory_allocated()
    cache_lens = sorted({c["k"].shape[2] for c in eng.cache["blocks"]})
    slab = cache_bytes(eng.cache)
    waves = eng.stats["prefill_waves"]
    decode_s = sum(r.decode_s for r in reqs)
    res = {"prefill_waves": waves,
           "decode_waves": eng.stats["decode_waves"],
           "carry_launches": launches["flash_fwd_carry"],
           "cache_positions": cache_lens, "slab_gb": slab / 1e9,
           "prefill_ms_per_wave":
               sum(r.prefill_s for r in reqs) / waves * 1e3,
           "prefill_tokens_per_s": sum(lens) / sum(r.prefill_s
                                                   for r in reqs),
           "decode_ms_per_wave": decode_s / eng.stats["decode_waves"] * 1e3,
           "decode_tokens_per_s":
               sum(len(r.generated) - 1 for r in reqs) / decode_s,
           "ttft_s_last": max(r.t_first - r.t_submit for r in reqs),
           "drain_s": wall, "peak_mem_gb": peak / 1e9}
    del eng
    torch.cuda.empty_cache()
    req = max(reqs, key=lambda r: r.plen)
    got = np.stack(req.logits)
    ref = teacher_forced_f32(torch, params, cfg, req)
    res["tf32ref_rms_err"] = float(np.sqrt(np.mean((got - ref) ** 2)))
    res["tf32ref_max_abs_err"] = float(np.abs(got - ref).max())
    res["tf32ref_same_tokens"] = [int(x) for x in ref.argmax(-1)] \
        == req.generated
    if not res["tf32ref_rms_err"] <= SERVE_TOL:
        raise AssertionError(f"{cfg.name}: engine vs float32 teacher-forced "
                             f"logits of the {req.plen}-token request: rms "
                             f"{res['tf32ref_rms_err']} > {SERVE_TOL}")
    want = [cfg.window if c == "l" else GEMMA_CONTEXT
            for c in sorted(set(cfg.layer_pattern))]
    if cache_lens != sorted(want):
        raise AssertionError(f"{cfg.name}: cache positions {cache_lens}, "
                             f"want {sorted(want)}")
    del params
    torch.cuda.empty_cache()

    cut = GEMMA_CUTS[cfg.name][0]
    cfg_c = dataclasses.replace(cfg, num_layers=cut)
    params_c = init_params(cfg_c, seed=0, device=DEVICE)
    _, reqs_c, launches_c, _ = serve_pool(torch, cfg_c, params_c, rt,
                                          lens=lens, context=GEMMA_CONTEXT)
    err, ties = hold_elementwise(torch, params_c, cfg_c, rt, reqs_c,
                                 f"{tag} {cut}-layer")
    res.update({f"layers{cut}_max_abs_err": err,
                f"layers{cut}_token_near_ties": ties,
                f"layers{cut}_carry_launches": launches_c["flash_fwd_carry"]})
    log(f"{tag} serve {cfg.name} {fmt(res)}")
    del params_c
    torch.cuda.empty_cache()
    for name, n in launches_c.items():
        launches[name] += n
    return launches


def gemma_train(torch, cfg, tag):
    """Full width cut to the training depth: 3 `Trainer` steps of github
    lengths at context and wave capacity GEMMA_CONTEXT with exact launches
    a wave, then one wave held to the float32 plain route."""
    from repro_torch.train.trainer import TrainerConfig
    _, layers, hold_capacity = GEMMA_CUTS[cfg.name]
    cfg_t = dataclasses.replace(cfg, num_layers=layers)
    want = {"flash_fwd": 0, "flash_fwd_carry": 2 * layers,
            "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
            "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    launches, _, _ = train_full(
        torch, cfg_t, sched=train_setup(cfg_t, capacity=GEMMA_CONTEXT,
                                        context=GEMMA_CONTEXT),
        tcfg=TrainerConfig(capacity=GEMMA_CONTEXT), tag=f"{tag[1:-1]} train",
        want=want)
    train_hold(torch, cfg, layers=layers, capacity=hold_capacity,
               tag=f"{tag[1:-1]} train", lean=True)
    return launches


def phase_gemma(torch, card):
    """gemma2-9b and gemma3-12b served at full depth and trained cut to
    depth -> their launches, summed."""
    from repro_torch.configs.registry import get_config
    tag = "[gemma]"
    log(f"{tag} {card}")
    total = {name: 0 for name, *_ in KERNELS}
    for arch in ("gemma2-9b", "gemma3-12b"):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        for part in (gemma_serve, gemma_train):
            torch.cuda.empty_cache()
            for name, n in part(torch, cfg, tag).items():
                total[name] += n
        log(f"{tag} {arch} done in {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# 14. mla
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-lite-16b"
MLA_CONTEXT = 8192              # (a): max_context and prefill capacity
MLA_LONG = 5000                 # (a): a prompt over 4096 tokens
MLA_TRAIN_LAYERS = 3            # (b): the dense head layer, two MoE layers
QWEN_ARCH = "qwen3-moe-30b-a3b"
QWEN_SERVE_LAYERS, QWEN_TRAIN_LAYERS = 8, 2     # (c)


def mla_serve(torch, cfg, tag, *, lens, context):
    """``cfg`` at full width (its depth) served as phase 11 (b) serves
    (`moe_serve_case`), every request held to a float32 teacher-forced
    forward replaying the engine's experts -> (launches, failures)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in leaves(params))
    log(f"{tag} {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{n / 1e9:.3f} B params, {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB, init {time.perf_counter() - t0:.1f} s")
    launches, res, fails = moe_serve_case(torch, cfg, params, lens=lens,
                                          context=context, f32=True)
    log(f"{tag} serve {cfg.name} {json.dumps(res)}")
    del params
    torch.cuda.empty_cache()
    return launches, fails


def mla_train(torch, cfg, tag):
    """``cfg`` (cut to its training depth): 3 `Trainer` steps as phase 5's
    with exact launches a wave, then one wave held to the float32 plain
    route replaying the kernel route's experts (phase 11 (c)) ->
    (launches, failures)."""
    from repro_torch.models.transformer import head_layer_count
    # the dense head layers run outside the remat periods: no recompute
    want = wave_launches_want(cfg.num_layers, 1)
    want["flash_fwd_carry"] -= head_layer_count(cfg)
    launches, _, _ = train_full(torch, cfg, tag=f"{tag[1:-1]} train",
                                want=want)
    res, fails = moe_train_wave(torch, cfg)
    log(f"{tag} train {cfg.name} at {cfg.num_layers} layers, one wave: "
        f"{fmt(res)}")
    torch.cuda.empty_cache()
    return launches, fails


def phase_mla(torch, card):
    """deepseek-v2-lite-16b served at full depth and trained at 3 layers,
    qwen3-moe-30b-a3b served at 8 layers and trained at 2 -> their
    launches, summed."""
    from repro_torch.configs.registry import get_config
    tag = "[mla]"
    log(f"{tag} {card}")
    t0 = time.perf_counter()
    total = {name: 0 for name, *_ in KERNELS}
    fails = []
    ds = get_config(MLA_ARCH)
    qw = get_config(QWEN_ARCH)
    parts = [
        ("(a)", lambda: mla_serve(torch, ds, tag, lens=PROMPT_LENS
                                  + [MLA_LONG], context=MLA_CONTEXT)),
        ("(b)", lambda: mla_train(torch, dataclasses.replace(
            ds, num_layers=MLA_TRAIN_LAYERS), tag)),
        ("(c) serve", lambda: mla_serve(torch, dataclasses.replace(
            qw, num_layers=QWEN_SERVE_LAYERS), tag, lens=PROMPT_LENS,
            context=4096)),
        ("(c) train", lambda: mla_train(torch, dataclasses.replace(
            qw, num_layers=QWEN_TRAIN_LAYERS), tag)),
    ]
    for part, run in parts:
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        launches, bad = run()
        fails += [f"{part} {f}" for f in bad]
        for name, n in launches.items():
            total[name] += n
        log(f"{tag} {part} done in {time.perf_counter() - t1:.1f} s")
    zero_counts()
    log(f"{tag} launches {json.dumps(total)}, phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    if fails:
        raise AssertionError("phase 14: " + "; ".join(fails))
    return total


# ---------------------------------------------------------------------------
# 15. rwkv
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-7b"
RWKV_SEQS, RWKV_SEQ_LEN = 8, 256        # (a): sequences, tokens each
RWKV_SEED = 0
RWKV_TRAIN_LAYERS = 8                   # (b)
RWKV_HDP_LAYERS = 2                     # (c)
RWKV_COMPS = [(4,), (1, 2, 1)]          # (c): the planner's step-1 waves
RWKV_LOSS_TOL = 1e-3                    # (b): 2 layers, against float32
RWKV_HDP_TOL = 1e-2                     # (c): against hdp = 1
# (b): the bonus's gradient, relative L2 from float32 (every other leaf:
# TRAIN_GRAD_TOL).  At the init's bonus 0 each sequence's first WKV output
# is 0 and the group norm's slope there is 1/sqrt(eps) = 316, so this sum
# is the worst conditioned of the wave's gradients in bf16, the
# reference's too (tests/test_torch_rwkv.py)
RWKV_BONUS_U_GRAD_TOL = 0.1
# (a): the 2-layer bf16 decode is held element-wise but at each
# sequence's second and third tokens, whose WKV output has rank one or two
# while the bonus is 0, a direction the group norm scales up by as much as
# 1/sqrt(eps)
RWKV_LOW_RANK_POSITIONS = (1, 2)


def rwkv_tokens(fwd, dec, tie: float):
    """Greedy tokens of the decode route against the forward's argmax,
    but where the forward's top-two gap is under ``tie`` (a near-tie)
    -> (near-ties, their largest gap, the other disagreements)."""
    ties, worst, fails = 0, 0.0, []
    want, got = fwd.argmax(-1), dec.argmax(-1)
    for s, j in (got != want).nonzero().tolist():
        top2 = fwd[s, j].topk(2).values
        gap = float(top2[0] - top2[1])
        if gap < tie:
            ties, worst = ties + 1, max(worst, gap)
        else:
            fails.append(f"slot {s} position {j}: greedy token "
                         f"{int(got[s, j])}, the forward's {int(want[s, j])}"
                         f" with top-two gap {gap} (near-tie under {tie})")
    return ties, worst, fails


def rwkv_decode_vs_forward(torch, cfg, params):
    """RWKV_SEQS sequences of RWKV_SEQ_LEN tokens (seed RWKV_SEED): the
    packed forward of all of them as one wave, and RWKV_SEQ_LEN
    teacher-forced decode steps in RWKV_SEQS slots from an empty state ->
    (the two routes' logits [slots, steps, V] in float32, decode ms a
    step)."""
    import numpy as np
    from repro_torch.models.transformer import forward_hidden, logits_head
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train import serve_step as S
    b, t = RWKV_SEQS, RWKV_SEQ_LEN
    rt = Runtime(device=DEVICE)
    toks = np.random.RandomState(RWKV_SEED).randint(0, cfg.vocab_size,
                                                    (b, t))
    batch = {"tokens": torch.tensor(toks.reshape(-1), dtype=torch.int32,
                                    device=DEVICE),
             "seg": torch.tensor(np.repeat(np.arange(1, b + 1), t),
                                 dtype=torch.int32, device=DEVICE),
             "pos": torch.tensor(np.tile(np.arange(t), b), dtype=torch.int32,
                                 device=DEVICE)}
    with torch.no_grad():
        fwd = logits_head(params, cfg, forward_hidden(params, cfg, rt, batch))
        fwd = fwd.float().reshape(b, t, -1).cpu()
        cache = S.init_decode_cache(cfg, rt, b, t)
        step = S.make_decode_step(cfg, rt, b, t)
        tok_d = torch.tensor(toks, device=DEVICE)
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(t):
            lg, cache = step(params, cache, tok_d[:, i], i)
            out.append(lg.float().cpu())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / t * 1e3
    return fwd, torch.stack(out, dim=1), ms


def rwkv_decode_rate(torch, cfg, params, slots, steps=8):
    """Decode tokens/s at ``slots`` slots (the last steps - 3 steps)."""
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train import serve_step as S
    rt = Runtime(device=DEVICE)
    with torch.no_grad():
        cache = S.init_decode_cache(cfg, rt, slots, 1024)
        step = S.make_decode_step(cfg, rt, slots, 1024)
        tok = torch.randint(0, cfg.vocab_size, (slots,), device=DEVICE)
        for i in range(steps):
            if i == 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            lg, cache = step(params, cache, tok, i)
            tok = lg.argmax(-1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del cache
    return slots * (steps - 3) / wall, wall / (steps - 3) * 1e3


def rwkv_serve(torch, cfg, tag):
    """(a): decode against the packed forward.  bf16 at full depth: logits
    rms <= 0.08, the greedy tokens' disagreements beyond near-ties
    counted, decode rates, the state a slot, the peak.  float32 at full
    depth: element-wise within 0.08 and the tokens equal but at
    near-ties.  bf16 at 2 layers: element-wise within 0.08 but at
    RWKV_LOW_RANK_POSITIONS (printed), and the tokens equal but at
    near-ties -> failures."""
    from repro_torch.models import rwkv6 as RW
    from repro_torch.models.transformer import init_params
    from repro_torch.train import serve_step as S
    from repro_torch.parallel.sharding import Runtime
    fails = []
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=DEVICE)
    fwd, dec, ms = rwkv_decode_vs_forward(torch, cfg, params)
    rms = float((dec - fwd).square().mean().sqrt())
    ties, worst, beyond = rwkv_tokens(fwd, dec, SERVE_TOL)
    state = S.cache_bytes(S.init_decode_cache(cfg, Runtime(device=DEVICE),
                                              1, 1))
    free = torch.cuda.mem_get_info()[0]
    slots = max(8, int(0.6 * free / state) // 8 * 8)
    rate8, _ = rwkv_decode_rate(torch, cfg, params, RWKV_SEQS)
    rate_max, ms_max = rwkv_decode_rate(torch, cfg, params, slots)
    res = {"layers": cfg.num_layers, "logits_rms": rms,
           "logits_max_abs_err": float((dec - fwd).abs().max()),
           "token_near_ties": ties, "near_tie_gap_max": worst,
           "token_disagreements_beyond_near_ties": len(beyond),
           "decode_ms_per_step_8_slots": ms,
           "tokens_per_s_8_slots": rate8, "max_slots": slots,
           "tokens_per_s_max_slots": rate_max,
           "decode_ms_per_step_max_slots": ms_max,
           "state_bytes_per_slot": state,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{tag} (a) bf16 decode vs forward: {fmt(res)}")
    if state != RW.state_bytes(cfg):
        fails.append(f"(a) a slot's cache is {state} bytes, the state "
                     f"{RW.state_bytes(cfg)}")
    if not rms <= SERVE_TOL:
        fails.append(f"(a) logits rms {rms} over {SERVE_TOL}")
    del params
    torch.cuda.empty_cache()
    for layers, dtype in ((cfg.num_layers, "float32"), (2, cfg.dtype)):
        c = dataclasses.replace(cfg, num_layers=layers, dtype=dtype)
        params = init_params(c, seed=0, device=DEVICE)
        fwd, dec, _ = rwkv_decode_vs_forward(torch, c, params)
        err = (dec - fwd).abs()
        outside = err > SERVE_TOL + SERVE_TOL * fwd.abs()
        over = int(outside.sum())
        where = [tuple(x) for x in outside.any(-1).nonzero().tolist()]
        ties, worst, bad = rwkv_tokens(fwd, dec, SERVE_TOL)
        fails += [f"(a) {layers} layers {dtype}: {b}" for b in bad]
        pos_rms = err.square().mean(-1).sqrt()          # [slots, steps]
        log(f"{tag} (a) {dtype} {layers} layers: decode vs forward rms "
            f"{float(err.square().mean().sqrt()):.5g}, max abs error "
            f"{float(err.max()):.5g}, {over} of {err.numel()} logits "
            f"outside atol = rtol = {SERVE_TOL} at (slot, position) "
            f"{where}; the worst position's rms {float(pos_rms.max()):.5g} at "
            f"{divmod(int(pos_rms.argmax()), pos_rms.shape[1])}; token "
            f"near-ties {ties} (gaps up to {worst})")
        held = outside if dtype == "float32" else torch.cat(
            [outside[:, :min(RWKV_LOW_RANK_POSITIONS)],
             outside[:, max(RWKV_LOW_RANK_POSITIONS) + 1:]], dim=1)
        if held.any():
            fails.append(f"(a) {layers} layers {dtype}: {int(held.sum())} "
                         f"logits outside {SERVE_TOL}")
        del params
        torch.cuda.empty_cache()
    return fails


def rwkv_scan_ms(torch, cfg, t=4096):
    """The WKV-6 scan alone at a training wave's shape (one layer), forward
    and forward + backward, on seeded float32 inputs."""
    from repro_torch.models import rwkv6 as RW
    n = cfg.rwkv.head_size
    h = cfg.d_model // n
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    r, k, v = (torch.randn(t, cfg.d_model, generator=gen, device=DEVICE)
               .requires_grad_(True) for _ in range(3))
    logw = (-torch.exp(torch.randn(t, cfg.d_model, generator=gen,
                                   device=DEVICE) * 0.5 - 2)
            ).requires_grad_(True)
    u = torch.zeros(h, n, device=DEVICE)
    seg = torch.ones(t, dtype=torch.int32, device=DEVICE)
    s0 = torch.zeros(h, n, n, device=DEVICE)

    def fwd():
        return RW.wkv6_chunked(r, k, v, logw, u, seg, head_size=n,
                               chunk=cfg.rwkv.chunk_size, s0=s0,
                               carry_seg=1)[0]

    def fwd_bwd():
        torch.autograd.grad(fwd().sum(), (r, k, v, logw))

    with torch.no_grad():
        f_ms = time_ms(torch, fwd, 5)
    return f_ms, time_ms(torch, fwd_bwd, 5)


@contextlib.contextmanager
def rwkv_patched(params, name, fn):
    """``repro_torch.models.rwkv6.<name>`` replaced by ``fn(original)``
    while the block runs; yields ``params``."""
    from repro_torch.models import rwkv6 as RW
    orig = getattr(RW, name)
    setattr(RW, name, fn(orig))
    try:
        yield params
    finally:
        setattr(RW, name, orig)


def rwkv_bf16_projections(params):
    """Control: the time mix's projections as bf16 GEMMs (the weights'
    dtype), not the float32 ones JAX's promotion makes of the float32
    mixes."""
    return rwkv_patched(params, "_mm",
                        lambda mm: lambda a, w: a.to(w.dtype) @ w)


def rwkv_bf16_scan_io(params):
    """Control: the WKV-6 scan's r, k, v, decays and output rounded to
    bf16 (its float32 internals kept)."""
    import torch

    def wrap(scan):
        def f(r, k, v, logw, *a, **kw):
            y, *rest = scan(*(t.to(torch.bfloat16) for t in (r, k, v, logw)),
                            *a, **kw)
            return (y.to(torch.bfloat16).float(), *rest)
        return f
    return rwkv_patched(params, "wkv6_chunked", wrap)


def rwkv_bf16_group_norm(params):
    """Control: the per-head group norm's input rounded to bf16."""
    import torch
    return rwkv_patched(params, "_group_norm", lambda gn: lambda y, n: gn(
        y.to(torch.bfloat16).float(), n))


@contextlib.contextmanager
def rwkv_bf16_leaves(params):
    """Control: every float32 leaf in bf16 (the bases, the bonus, the
    group norm's, the channel mix's mix: the bridge's fault before it
    kept each leaf's dtype)."""
    import torch
    from repro_torch.tree import tree_map
    yield tree_map(lambda t: t.to(torch.bfloat16)
                   if t.dtype == torch.float32 else t, params)


RWKV_CONTROLS = (("bf16_projections", "time_mix/bonus_u",
                  rwkv_bf16_projections),
                 ("bf16_scan_io", "time_mix/bonus_u", rwkv_bf16_scan_io),
                 ("bf16_group_norm", "time_mix/bonus_u",
                  rwkv_bf16_group_norm),
                 ("bf16_leaves", "time_mix/bonus_u", rwkv_bf16_leaves))


def rwkv_train(torch, cfg, tag):
    """(b): 3 `Trainer` steps at RWKV_TRAIN_LAYERS layers (phase 5's data),
    exact CE launches a wave and no flash launch; one 2-layer wave held
    to the float32 plain route -> (launches, failures)."""
    cfg8 = dataclasses.replace(cfg, num_layers=RWKV_TRAIN_LAYERS)
    launches, res, _ = train_full(torch, cfg8, tag=f"{tag[1:-1]} train",
                                  want=wave_launches_want(0, 1))
    f_ms, fb_ms = rwkv_scan_ms(torch, cfg)
    log(f"{tag} (b) WKV-6 scan, one layer at a 4096-token wave: forward "
        f"{f_ms:.3f} ms, forward + backward {fb_ms:.3f} ms; "
        f"{RWKV_TRAIN_LAYERS} layers' share of a warm wave "
        f"{RWKV_TRAIN_LAYERS * (2 * f_ms + fb_ms) / res['warm_ms_per_wave']:.3f}"
        f" (forward, recompute and backward)")
    fails = []
    try:
        hold = train_hold(torch, cfg, layers=2, tag=f"{tag[1:-1]} train",
                          grad_tols={"time_mix/bonus_u":
                                     RWKV_BONUS_U_GRAD_TOL},
                          controls=RWKV_CONTROLS)
    except AssertionError as e:
        return launches, [f"(b) {e}"]
    if not hold["loss_rel_err"] <= RWKV_LOSS_TOL:
        fails.append(f"(b) 2-layer loss {hold['loss_kernel']} vs float32 "
                     f"{hold['loss_f32']}")
    torch.cuda.empty_cache()
    return launches, fails


def rwkv_hdp(torch, cfg, tag):
    """(c): RWKV_HDP_LAYERS layers at full width, the planner's step-1
    waves at hdp = 4 with a (4,) or (1, 2, 1) composition: the forward
    loss through ThreadRanks(4) (each rank its slice, shares summed)
    against the hdp = 1 forward of the same sequences laid contiguously;
    the measured "ring" bytes (0) -> (launches, failures)."""
    import numpy as np
    from repro_torch.data.loader import (GlobalScheduler, SyntheticDataset,
                                         WaveMaterializer)
    from repro_torch.launch import ring_check as RC
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import ledger
    from repro_torch.parallel.comm import ThreadRanks
    from repro_torch.parallel.sharding import Runtime
    cfg2 = dataclasses.replace(cfg, num_layers=RWKV_HDP_LAYERS)
    c = RC.RING_CAP
    ds = SyntheticDataset("github", cfg2.vocab_size, tokens_per_step=65536,
                          context=16384)
    sched = GlobalScheduler(ds, cfg2, capacity=c, hdp=RING_HDP,
                            strategy="balance", use_offload=False)
    try:
        plan = sched.plan_step(1)
    finally:
        sched.stop()
    mat = WaveMaterializer(ds, cfg2, c)
    waves = [w for w in plan.waves if tuple(w.composition) in RWKV_COMPS
             and w.c_mult == 1]
    fails = []
    if {tuple(w.composition) for w in waves} != set(RWKV_COMPS):
        fails.append(f"(c) planner step 1 has waves "
                     f"{[w.composition for w in plan.waves]}")
    params = init_params(cfg2, seed=0, device=DEVICE)
    den = torch.tensor(float(plan.denom), device=DEVICE)
    n, d = cfg.rwkv.head_size, cfg.d_model
    total = {name: 0 for name, *_ in KERNELS}
    for w in waves:
        comp = tuple(w.composition)
        lw = mat.materialize(1, w)
        batch = {k: torch.tensor(v, device=DEVICE)
                 for k, v in lw.batch.items()}

        def rank_fn(comm):
            rt = Runtime(device=DEVICE, comm=comm, composition=comp)
            with ledger.capture() as tally:
                loss = RC.model_loss(params, cfg2, rt, batch, slice(
                    comm.rank * c, (comm.rank + 1) * c), den)
            return loss, tally.get("ring", 0.0)

        zero_counts()
        t0 = time.perf_counter()
        got = ThreadRanks(RING_HDP).run(rank_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, k in read_counts().items():
            total[name] += k
        valid = np.flatnonzero(lw.batch["seg"] > 0)
        compact = {k: torch.zeros_like(v) for k, v in batch.items()}
        for k, v in batch.items():
            compact[k][:len(valid)] = v[torch.tensor(valid, device=DEVICE)]
        loss1 = RC.model_loss(params, cfg2, Runtime(device=DEVICE), compact,
                              slice(None), den)
        loss4 = sum(g[0] for g in got)
        rel = abs(loss4 - loss1) / abs(loss1)
        edges = sum(g - 1 for g in comp)
        res = {"composition": list(comp),
               "pieces": [[(p.seq_id, p.start, p.end) for p in s]
                          for s in w.slots],
               "loss_hdp4": loss4, "loss_hdp1": loss1, "rel_err": rel,
               "ring_bytes": sum(g[1] for g in got), "wall_s_hdp4": wall,
               # per layer: the time and channel mixes' boundary rows (bf16
               # row + int32 segment id) over each group's edges, and the
               # all-gather of every rank's (A, b) summary, fp32
               # [H, N, N + 1], to the other ranks
               "state_exchange_bytes_per_layer":
                   2 * edges * (2 * d + 4) + RING_HDP * (RING_HDP - 1)
                   * (d // n) * n * (n + 1) * 4}
        log(f"{tag} (c) hdp = {RING_HDP}: {fmt(res)}")
        if not rel <= RWKV_HDP_TOL:
            fails.append(f"(c) {comp}: hdp 4 loss {loss4} vs hdp 1 {loss1}")
        if res["ring_bytes"] != 0:
            fails.append(f"(c) {comp}: ring bytes {res['ring_bytes']}")
    if total["fused_ce_fwd"] != RING_HDP * len(waves) or any(
            total[k] for k in total if k != "fused_ce_fwd"):
        fails.append(f"(c) launches {total}")
    del params
    torch.cuda.empty_cache()
    return total, fails


def phase_rwkv(torch, card):
    """rwkv6-7b decoded at full depth, trained at 8 layers, its forward
    at hdp = 4 at 2 layers, and the CE kernels at its logits' shape ->
    (launches of (b) and (c), the CE kernel cases)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import fused_ce as CE
    tag = "[rwkv]"
    log(f"{tag} {card}")
    t0 = time.perf_counter()
    cfg = get_config(RWKV_ARCH)
    total = {name: 0 for name, *_ in KERNELS}
    fails = []
    t1 = time.perf_counter()
    fails += rwkv_serve(torch, cfg, tag)
    log(f"{tag} (a) done in {time.perf_counter() - t1:.1f} s")
    for part, run in (("(b)", rwkv_train), ("(c)", rwkv_hdp)):
        t1 = time.perf_counter()
        launches, bad = run(torch, cfg, tag)
        fails += bad
        for name, n in launches.items():
            total[name] += n
        log(f"{tag} {part} done in {time.perf_counter() - t1:.1f} s")
    zero_counts()
    cases = ce_case(torch, CE, "rwkv6-7b ce [4096,65536]", t=4096,
                    v=cfg.vocab_size, n_pad=96)
    zero_counts()
    log(f"{tag} launches {json.dumps(total)}, phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    if fails:
        raise AssertionError("phase 15: " + "; ".join(fails))
    return total, cases


# ---------------------------------------------------------------------------
# 16. tp
# ---------------------------------------------------------------------------

TP_HDP, TP_TP = 2, 2            # phase 16 (a): an hdp x tp grid on one card
TP_LAYERS, TP_STEPS = 1, 1
EP_LAYERS = 1                   # (c): Mistral-8x7B at full width
# (b): the local attention shapes (model, tp, model rank, q heads, KV
# heads, (Dk, Dv), T, segment lengths, window, softcap).  llama3.2-3b at
# tp 2 shards its 8 KV heads, at tp 16 replicates them (rank 5: 2 of 32
# padded heads); (576, 512) is deepseek's latent in gather mode (each of
# the rank's 8 heads over the one latent, v its first 512 columns)
TP_ATTN = [
    ("llama3.2-3b", 2, 1, 24, 8, (128, 128), 4096, SLICE_LENS, 0, 0.0),
    ("llama3.2-3b", 16, 5, 24, 8, (128, 128), 4096, SLICE_LENS, 0, 0.0),
    ("qwen3-moe-30b-a3b", 2, 1, 32, 4, (128, 128), 4096, SLICE_LENS, 0,
     0.0),
    ("deepseek-v2-lite-16b", 2, 1, 16, 1, (576, 512), 4096, SLICE_LENS, 0,
     0.0),
    ("gemma2-9b", 2, 1, 16, 8, (256, 256), 8192, [6000, 2000, 150], 4096,
     50.0),
]
# (b): both CE kernels on model rank 1 of 2's vocabulary shard:
# llama3.2-3b's 64128 columns and Mistral-8x7B's 16000 (no multiple of
# 2048)
TP_CE = [("llama3.2-3b", 128256 // 2), ("mistral-8x7b", 32000 // 2)]


def tp_rank(rank: int, store: str):
    """One rank of phase 16 (a) and (c), a process of its own on the one
    card (world rank 0 is this script's process): a gloo world of 4
    through `HostStagedComm`, split into HDP x model groups by `tp_grid`
    (world rank h·2 + m).  Returns world rank 0's results of both."""
    import datetime
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.comm import HostStagedComm, tp_grid
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import faulthandler
    faulthandler.dump_traceback_later(2 * HDP_TIMEOUT_S, exit=True)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=TP_HDP * TP_TP,
        rank=rank, timeout=datetime.timedelta(seconds=HDP_TIMEOUT_S))
    try:
        grid = tp_grid(TP_HDP, TP_TP, HostStagedComm)
        a = tp_train_rank(torch, *grid)
        c = tp_train_rank(torch, *grid, cfg=ep_config())
        return None if a is None else (a, c)
    finally:
        faulthandler.cancel_dump_traceback_later()
        dist.destroy_process_group()


def ep_config():
    """Phase 16 (c)'s model: Mistral-8x7B at full width cut to
    `EP_LAYERS` (1.713 G parameters at one layer)."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("mistral-8x7b"),
                               num_layers=EP_LAYERS)


def tp_trainer(cfg, comm, tp_comm):
    """The port's `Trainer` of ``cfg`` (seed 0) on phase 7's data at
    hdp 2, recording its plans in ``.plans``."""
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    from repro_torch.launch import ring_check as RC
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    ds = SyntheticDataset("github", cfg.vocab_size,
                          tokens_per_step=HDP_TOKENS, context=HDP_CONTEXT)
    sched = GlobalScheduler(ds, cfg, capacity=RC.RING_CAP, hdp=comm.size,
                            strategy="balance", use_offload=False)
    plans = []
    plan_step = sched.plan_step

    def recorded(step):
        plans.append(plan_step(step))
        return plans[-1]
    sched.plan_step = recorded
    tr = Trainer(cfg, Runtime(device=DEVICE, comm=comm, tp_comm=tp_comm),
                 AdamWConfig(lr=3e-4, warmup_steps=0), sched,
                 TrainerConfig(capacity=RC.RING_CAP, calibrate=False),
                 seed=0)
    tr.plans = plans
    return tr


def tp_train_rank(torch, comm, tp_comm, cfg=None):
    """Phase 16 (a) on one rank: `TP_STEPS` steps of the 2 x 2 grid
    (counted), then on model rank 0 of each HDP position the same steps
    at 2 x 1 from the same seed (not counted).  ``cfg`` defaults to
    llama3.2-3b cut to `TP_LAYERS`.  With an MoE ``cfg`` (phase 16 (c))
    every MoE call's top-k indices are recorded and held across the
    model group.  Returns world rank 0's numbers (None elsewhere)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_ce as CE
    from repro_torch.models import moe as M
    from repro_torch.tree import leaves

    if cfg is None:
        cfg = dataclasses.replace(get_config("llama3.2-3b"),
                                  num_layers=TP_LAYERS)
    shapes = set()          # what the kernels were launched on
    fa_launch, ce_launch = FA._launch, CE._launch

    def fa_rec(source, symbol, q, k, v, args, **kw):
        shapes.add(("flash", tuple(q.shape[:2]), int(k.shape[0])))
        return fa_launch(source, symbol, q, k, v, args, **kw)

    def ce_rec(symbol, logits, args):
        shapes.add(("ce", int(logits.shape[1])))
        return ce_launch(symbol, logits, args)

    def grid_gather(x):
        """Every rank's ``x`` -> [world, ...], world rank h·tp + m's at
        that row."""
        x = comm.all_gather(tp_comm.all_gather(x))
        return x.reshape(-1, *x.shape[2:])

    topk = []               # every MoE call's top-k indices, this rank
    route = M.moe_route

    def routed(params, c, x):
        gates, idx = route(params, c, x)
        topk.append(idx.reshape(-1).clone())
        return gates, idx

    FA._launch, CE._launch = fa_rec, ce_rec
    M.moe_route = routed
    lead = comm.rank == 0 and tp_comm.rank == 0
    t0 = time.perf_counter()
    tr = tp_trainer(cfg, comm, tp_comm)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        recs, wave_losses, applied = [], [], []
        for _ in range(TP_STEPS):
            recs.append(tr.train_step())
            if lead:
                log(f"[tp] step {tr.step}: {len(tr.plans[-1].waves)} waves, "
                    f"loss {recs[-1]['loss']:.6f}, at "
                    f"{time.perf_counter() - t0:.1f} s")
            wave_losses.append(list(tr.last_numerics["wave_losses"]))
            applied.append(tr.last_numerics["applied"])
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        FA._launch, CE._launch = fa_launch, ce_launch
        M.moe_route = route
        tr.sched.stop()
    # every MoE call's top-k indices (forward and recompute) alike over
    # the model group
    same_topk = 1.0
    if cfg.moe is not None:
        mine_idx = torch.cat(topk) if topk else torch.zeros(
            0, dtype=torch.int64, device=DEVICE)
        g = tp_comm.all_gather(mine_idx)
        same_topk = float(len(topk) > 0 and all(torch.equal(g[0], x)
                                                for x in g))
    del topk
    # the replicated leaves across the model group, every leaf across the
    # HDP group: bit-identical
    same_model = same_hdp = True
    for p, split in zip(leaves(tr.params), tr._splits):
        if split is None:
            g = tp_comm.all_gather(p)
            same_model &= all(torch.equal(g[0], x) for x in g)
        g = comm.all_gather(p)
        same_hdp &= all(torch.equal(g[0], x) for x in g)
    local_g = cfg.num_kv_heads // TP_TP
    hg = cfg.num_heads // cfg.num_kv_heads
    want_shapes = {("flash", (local_g, hg), local_g),
                   ("ce", cfg.vocab_size // TP_TP)}
    names = [n for n, *_ in KERNELS]
    mine = [counts[n] for n in names] + [
        peak, float(same_model), float(same_hdp),
        float(shapes == want_shapes), same_topk] + \
        [r["wall_s"] for r in recs] + applied
    got = grid_gather(torch.tensor(mine, dtype=torch.float64,
                                   device=DEVICE)).cpu().numpy()
    want = ring_launches_want(tr, enumerate(tr.plans), TP_HDP) \
        if lead else None
    plans22 = [[(list(w.composition), w.c_mult) for w in p.waves]
               for p in tr.plans]
    del tr
    torch.cuda.empty_cache()
    # the control: 2 x 1 on model rank 0's HDP group, the same seed
    ctl = None
    if tp_comm.rank == 0:
        torch.cuda.reset_peak_memory_stats()
        tr1 = tp_trainer(cfg, comm, None)
        try:
            ctl = [(tr1.train_step(), list(tr1.last_numerics["wave_losses"]))
                   for _ in range(TP_STEPS)]
            plans21 = [[(list(w.composition), w.c_mult) for w in p.waves]
                       for p in tr1.plans]
        finally:
            tr1.sched.stop()
        del tr1
        torch.cuda.empty_cache()
        peaks21 = comm.all_gather(torch.tensor(
            [torch.cuda.max_memory_allocated() / 1e9], dtype=torch.float64,
            device=DEVICE)).reshape(-1).tolist()
    if not lead:
        return None
    k, s = len(names), TP_STEPS
    return {
        "model": f"{cfg.name}, {cfg.num_layers} layers, {TP_HDP} x {TP_TP}",
        "compositions": plans22, "compositions_2x1": plans21,
        "losses": [r["loss"] for r in recs],
        "losses_2x1": [r["loss"] for r, _ in ctl],
        "grad_norms": [r["grad_norm"] for r in recs],
        "grad_norms_2x1": [r["grad_norm"] for r, _ in ctl],
        "wave_losses": wave_losses, "wave_losses_2x1": [w for _, w in ctl],
        "tokens_per_step": [r["tokens"] for r in recs],
        "launches_per_rank": {n: got[:, i].astype(int).tolist()
                              for i, n in enumerate(names)},
        "want_launches_per_rank": {n: [w[r // TP_TP] for r in
                                       range(TP_HDP * TP_TP)]
                                   for n, w in want.items()},
        "peak_mem_gb_per_rank": got[:, k].tolist(),
        "peak_mem_gb_2x1_per_rank": peaks21,
        "replicated_same_across_model_group": got[:, k + 1].tolist(),
        "same_across_hdp_group": got[:, k + 2].tolist(),
        "kernel_shapes_local": got[:, k + 3].tolist(),
        "kernel_shapes_rank0": sorted(map(str, shapes)),
        "topk_same_across_model_group": got[:, k + 4].tolist(),
        "step_wall_s_per_rank": got[:, k + 5:k + 5 + s].tolist(),
        "applied": got[:, k + 5 + s:].tolist()}


def tp_gates(res) -> list:
    """Phase 16 (a)'s and (c)'s gates on world rank 0's numbers -> what
    failed."""
    import numpy as np
    fails = []
    if res["compositions"] != res["compositions_2x1"]:
        fails.append("2 x 2 and 2 x 1 planned different steps")
    for key, tol in (("losses", PP_LOSS_TOL),
                     ("grad_norms", PP_LOSS_TOL)):
        got, want = np.asarray(res[key]), np.asarray(res[key + "_2x1"])
        if not (np.all(np.isfinite(got))
                and np.all(np.abs(got - want) <= tol * np.abs(want))):
            fails.append(f"{key} {got.tolist()} vs 2 x 1 {want.tolist()}")
    for step, (got, want) in enumerate(zip(res["wave_losses"],
                                           res["wave_losses_2x1"])):
        if not (len(got) == len(want) and np.all(
                np.abs(np.subtract(got, want))
                <= PP_LOSS_TOL * np.abs(want))):
            fails.append(f"step {step} wave losses {got} vs 2 x 1 {want}")
    if res["launches_per_rank"]["flash_fwd"] != [0] * (TP_HDP * TP_TP):
        fails.append("the training path launched the finalising forward")
    for name, want in res["want_launches_per_rank"].items():
        if res["launches_per_rank"][name] != want:
            fails.append(f"{name} launches per rank "
                         f"{res['launches_per_rank'][name]}, want {want}")
    for key in ("replicated_same_across_model_group",
                "same_across_hdp_group", "kernel_shapes_local",
                "topk_same_across_model_group"):
        if np.any(np.asarray(res[key]) != 1):
            fails.append(f"{key} {res[key]} (rank 0's kernel shapes "
                         f"{res['kernel_shapes_rank0']})")
    if np.any(np.asarray(res["applied"]) != 1):
        fails.append(f"applied {res['applied']}")
    return fails


def tp_attention_case(torch, card, case) -> list:
    """Phase 16 (b): one of `TP_ATTN`'s model ranks' attention, forward and
    backward through `ring_attention` at composition (1,) on bf16 inputs,
    against the plain route: its h_pad/tp heads over its KV groups
    (sharded KV), over its KV groups' rows of the replicated KV, or (Dk !=
    Dv) over the one MLA latent, v its first Dv columns (the gather
    modes) -> what failed."""
    import numpy as np
    from repro_torch.core import ring
    from repro_torch.models.layers import gqa_layout
    arch, tp, m, heads, kvh, (dk, dv), t, lens, window, softcap = case
    latent = dk != dv
    if latent:
        hpl, g, kv_sharded = heads // tp, 1, False
        kgi = torch.zeros(hpl, dtype=torch.int64, device=DEVICE)
        scale = 192 ** -0.5          # 1/sqrt(qk_nope 128 + qk_rope 64)
    else:
        lay = gqa_layout(heads, kvh, tp)
        hpl, kv_sharded = lay.h_pad // tp, lay.kv_sharded
        g = kvh // tp if kv_sharded else kvh
        kgi = None if kv_sharded else \
            lay.group_of_head(DEVICE)[m * hpl:(m + 1) * hpl]
        scale = dk ** -0.5
    rng = np.random.RandomState(16)
    seg_np, pos_np = packed_meta(rng, t, lens)
    seg = torch.tensor(seg_np, device=DEVICE)
    pos = torch.tensor(pos_np, device=DEVICE)

    def bf16(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.bfloat16,
                            device=DEVICE)
    ins = [bf16(t, hpl, dk), bf16(t, g, dk)] + \
        ([] if latent else [bf16(t, g, dv)])
    do = bf16(t, hpl, dv)
    outs = {}
    # the latent's gradient sums the rank's heads' dk and dv, so its
    # elements cancel: it is also held against the float32 plain route
    for impl, dt in (("flash", None), ("ref", None)) + (
            (("ref", torch.float32),) if latent else ()):
        x = [a.detach().to(dt or a.dtype).requires_grad_(True)
             for a in ins]
        out = ring.ring_attention(
            x[0], x[1], None if latent else x[2], seg, seg, pos, pos,
            composition=(1,), kv_sharded=kv_sharded, kv_group_of_head=kgi,
            scale=scale, window=window, softcap=softcap, attn_impl=impl,
            v_in_k=(0, dv) if latent else None)
        outs[impl if dt is None else "f32"] = (
            out.detach(), *torch.autograd.grad(out, x, do.to(out.dtype)))
    torch.cuda.synchronize()
    fails = []
    errs = {}
    names = ("out", "dq", "dlatent") if latent else ("out", "dq", "dk",
                                                      "dv")
    for i, (name, got, want) in enumerate(zip(names, outs["flash"],
                                              outs["ref"])):
        what = f"phase 16 (b) {arch} tp {tp} {name}"
        try:
            if name != "dlatent":
                errs[name] = hold(torch, what, got, want)
                continue
            # relative L2 against the plain route, and element-wise no
            # worse than twice the bf16 plain route's own error against
            # float32
            f32 = outs["f32"][i]
            err = (got.float() - want.float()).abs().max().item()
            kern = (got.float() - f32).abs().max().item()
            plain = (want.float() - f32).abs().max().item()
            errs[name] = (err, rel_l2(got, want), kern, plain)
            if not (rel_l2(got, want) <= TOL and kern <= 2 * plain):
                raise AssertionError(
                    f"{what}: relative L2 {rel_l2(got, want)}, max abs "
                    f"error against float32 {kern} (the bf16 plain "
                    f"route's {plain})")
        except AssertionError as e:
            fails.append(str(e))
    log(f"[tp] (b) {card}: {arch} model rank {m} of {tp}: heads {hpl}, KV "
        f"groups {g}, kv_sharded {kv_sharded}"
        f"{'' if kgi is None else f', gathered groups {kgi.tolist()}'}, "
        f"(Dk, Dv) ({dk}, {dv}), T {t}, window {window}, softcap "
        f"{softcap}; (max abs err, rel L2) against the plain route "
        f"{'(dlatent also: max abs err of the kernels, of the bf16 plain '
           'route, against float32) ' if latent else ''}"
        f"{json.dumps(errs)}")
    return fails


def tp_ce_case(torch, card, arch, v) -> list:
    """Phase 16 (b): both CE kernels on model rank 1 of 2's vocabulary
    shard of ``arch``, [4096, v] bf16, the global labels shifted by the
    shard's first column (two thirds fall outside it, the shard's first
    and last columns among those inside), the backward from a global lse
    above the local one, against their plain versions -> what failed."""
    import numpy as np
    from repro_torch.kernels import fused_ce as CE
    t, m = 4096, 1
    rng = np.random.RandomState(17)
    # drawn on the card: 263M values drawn on the host took seconds
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    logits = (torch.randn(t, v, generator=gen, device=DEVICE)
              * 3).to(torch.bfloat16)
    glob = rng.randint(-v, 2 * v, t)       # beside the shard on both sides
    glob[:4] = (-1, 0, v - 1, v)           # the shard's edges, and past
    labels = torch.tensor(glob.astype(np.int32), device=DEVICE)
    inside = (labels >= 0) & (labels < v)
    g = torch.tensor(rng.randn(t).astype(np.float32), device=DEVICE)
    nll, lse, tgt = CE.fused_ce_fwd(logits, labels)
    nll_p, lse_p, tgt_p = CE.fused_ce_fwd_plain(logits, labels)
    lse_g = lse + torch.tensor(rng.rand(t).astype(np.float32) * 2,
                               device=DEVICE)
    dl = CE.fused_ce_bwd(logits, labels, lse_g, g)
    dl_p = CE.fused_ce_bwd_plain(logits, labels, lse_g, g)
    torch.cuda.synchronize()
    fails, errs = [], {}
    for name, got, want in (("lse", lse, lse_p),
                            ("nll in shard", nll[inside], nll_p[inside]),
                            ("tgt in shard", tgt[inside], tgt_p[inside]),
                            ("dlogits", dl, dl_p)):
        try:
            errs[name] = hold(torch, f"phase 16 (b) CE {name}", got, want)
        except AssertionError as e:
            fails.append(str(e))
    if not bool((tgt[~inside] == CE.NEG_INF).all()):
        fails.append("phase 16 (b) CE: a label outside the shard found a "
                     "target")
    log(f"[tp] (b) {card}: {arch} CE [{t}, {v}] at model rank {m} of 2, "
        f"{int(inside.sum())} of {t} labels in the shard; (max abs err, "
        f"rel L2) against the plain versions {json.dumps(errs)}")
    return fails


def phase_tp(torch, card):
    """Phase 16: (a) 4 processes share the card, world rank 0 this one;
    (b) the TP-local kernel shapes in this process.  -> (a)'s launches,
    summed over the ranks."""
    import tempfile
    mp = torch.multiprocessing.get_context("spawn")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        store = str(Path(tmp) / "store")
        procs = [mp.Process(target=tp_rank, args=(r, store), daemon=True)
                 for r in range(1, TP_HDP * TP_TP)]
        for pr in procs:
            pr.start()
        try:
            res, ep = tp_rank(0, store)
            for pr in procs:
                pr.join(HDP_TIMEOUT_S)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        codes = [pr.exitcode for pr in procs]
        if codes != [0] * len(procs):
            raise AssertionError(f"phase 16 rank exit codes {codes}")
    wall = time.perf_counter() - t0
    shown = ("losses", "losses_2x1", "grad_norms", "grad_norms_2x1",
             "peak_mem_gb_per_rank", "peak_mem_gb_2x1_per_rank",
             "step_wall_s_per_rank")
    log(f"[tp] (a) and (c) {card}: 4 rank processes share this card (gloo "
        f"through host memory), so the times measure no card-to-card "
        f"transfer; (a) and (c) wall {wall:.1f} s")
    fails = []
    for part, r in (("a", res), ("c", ep)):
        log(f"[tp] ({part}) {r['model']}: "
            f"{json.dumps({k: r[k] for k in shown})}")
        log(f"[tp] ({part}) {json.dumps(r)}")
        fails += [f"({part}) {f}" for f in tp_gates(r)]
    saved = read_counts()
    t1 = time.perf_counter()
    for case in TP_ATTN:
        fails += tp_attention_case(torch, card, case)
    for arch, v in TP_CE:
        fails += tp_ce_case(torch, card, arch, v)
    set_counts(saved)                  # (b)'s launches are comparisons
    log(f"[tp] (b) {time.perf_counter() - t1:.1f} s, phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    if fails:
        raise AssertionError("phase 16: " + "; ".join(fails))
    return {name: int(sum(res["launches_per_rank"][name])
                      + sum(ep["launches_per_rank"][name]))
            for name in res["launches_per_rank"]}


# ---------------------------------------------------------------------------
# 17. grid
# ---------------------------------------------------------------------------

GRID_S, GRID_H, GRID_TP = 2, 1, 2   # 4 processes on the one card
GRID_LAYERS = 2                     # llama3.2-3b's width, 1 a stage
GRID_RWKV_LAYERS = 1                # (b): rwkv6-7b's width


def grid_rank(rank: int, store: str):
    """One rank of phase 17, a process of its own on the one card (world
    rank 0 is this script's process): a gloo world of 4 through
    `HostStagedComm`, split by `parallel/comm.py::grid` into 2 stages x
    hdp 1 x tp 2 (world rank s·2 + m).  Returns world rank 0's results
    of (a) and (b)."""
    import datetime
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.comm import HostStagedComm, grid
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{store}",
        world_size=GRID_S * GRID_H * GRID_TP, rank=rank,
        timeout=datetime.timedelta(seconds=HDP_TIMEOUT_S))
    try:
        _, stage_comm, tp_comm = grid(GRID_S, GRID_H, GRID_TP,
                                      HostStagedComm)
        a = grid_train_rank(torch, stage_comm, tp_comm)
        b = grid_rwkv_rank(torch, tp_comm) if stage_comm.rank == 0 \
            else None
        return None if rank else (a, b)
    finally:
        dist.destroy_process_group()


def grid_whole_tree(torch, tr, stage_comm, tp_comm):
    """Every rank's window and slices gathered to world rank 0: the
    global tree there, None elsewhere.  Every rank calls it."""
    from repro_torch.parallel.zero1 import stage_owned
    from repro_torch.tree import leaves, tree_map
    got = []
    for p, owned, split in zip(leaves(tr.params), stage_owned(tr.params),
                               tr._splits):
        x = p
        if split is not None:
            x = torch.cat(list(tp_comm.all_gather(x.contiguous())), split)
        if owned:
            x = torch.cat(list(stage_comm.all_gather(x.contiguous())), 0)
        got.append(x)
    if stage_comm.rank or tp_comm.rank:
        return None
    it = iter(got)
    return tree_map(lambda _: next(it), tr.params)


def grid_train_rank(torch, stage_comm, tp_comm):
    """Phase 17 (a) on one rank: one step of llama3.2-3b cut to
    `GRID_LAYERS` on the 2 x 1 x 2 grid with Eq. 3's offload and the
    bytes ledger on; before the apply world rank 0 runs the one-process
    route over the step's global waves from the gathered global tree
    (`hdp_reference`).  Returns world rank 0's numbers (None
    elsewhere)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.obs import ledger
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.parallel.zero1 import stage_owned
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    world = stage_comm.rank * GRID_TP + tp_comm.rank
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              num_layers=GRID_LAYERS)
    from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
    sched = GlobalScheduler(
        SyntheticDataset("github", cfg.vocab_size, tokens_per_step=16384,
                         context=OFF_CONTEXT),
        cfg, capacity=4096, hdp=GRID_H, strategy="balance", use_offload=True,
        mode="pp", num_stages=GRID_S)
    plans = []
    plan_step = sched.plan_step

    def recorded(step):
        plans.append(plan_step(step))
        return plans[-1]
    sched.plan_step = recorded
    ledger.set_ledger_enabled(True)
    tr = Trainer(cfg, Runtime(device=DEVICE, stage_comm=stage_comm,
                              tp_comm=tp_comm),
                 AdamWConfig(lr=3e-4, warmup_steps=0), sched,
                 TrainerConfig(capacity=4096, calibrate=False, mode="pp",
                               use_offload=True, max_round_waves=2),
                 seed=0)
    ref = {}
    plain_apply = tr.apply_step

    def apply_step(params, state, acc):
        full = grid_whole_tree(torch, tr, stage_comm, tp_comm)
        if world == 0:
            ref["wave_losses"], _, ref["grad_norm"] = hdp_reference(
                torch, tr, plans[-1], tr.step, params=full)
        del full
        torch.cuda.empty_cache()
        return plain_apply(params, state, acc)
    tr.apply_step = apply_step
    keys = []
    tr.telemetry_fn = lambda ws, *_, **__: keys.append(
        (tuple(ws[0].composition), ws[0].c_mult,
         max(w.offload_ratio for w in ws), len(ws)))
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    try:
        rec = tr.train_step()
        torch.cuda.synchronize()
        counts = read_counts()
        recs = tr.ledger.recent(64)
        nu = tr.last_numerics
        same = True             # the replicas of every leaf, bit for bit
        for p, owned, split in zip(leaves(tr.params), stage_owned(tr.params),
                                   tr._splits):
            for c, shared in ((stage_comm, not owned),
                              (tp_comm, split is None)):
                if shared:
                    b = p.clone()
                    c.broadcast(b)
                    same &= torch.equal(b, p)
        names = [n for n, *_ in KERNELS]
        mine = [counts[n] for n in names] + [
            tr.peak.high_water() / 1e9, float(same), rec["wall_s"],
            nu["applied"], tr.offload_store.d2h_bytes,
            tr.offload_store.h2d_bytes]
        got = stage_comm.all_gather(tp_comm.all_gather(torch.tensor(
            mine, dtype=torch.float64, device=DEVICE))).reshape(
                GRID_S * GRID_TP, -1).cpu().numpy()
    finally:
        ledger.set_ledger_enabled(False)
        sched.stop()
    offloaded = [tr._exec_cache[(c, cm, round(r, 2))].offload_periods
                 for c, cm, r, _ in keys]
    del tr
    torch.cuda.empty_cache()
    if world != 0:
        return None
    from repro_torch.obs.ledger import port_round_bytes
    k = len(names)
    lay = GRID_LAYERS // GRID_S
    want = {n: [0] * (GRID_S * GRID_TP) for n in names}
    for wave in plans[0].waves:
        for s in range(GRID_S):
            last = int(s == GRID_S - 1)
            for m in range(GRID_TP):
                for n, add in (("flash_fwd_carry", 2 * lay),
                               ("flash_bwd_dq", lay), ("flash_bwd_dkv", lay),
                               ("fused_ce_fwd", last),
                               ("fused_ce_bwd", last)):
                    want[n][s * GRID_TP + m] += add
    kinds = ("ring", "pp", "offload_d2h", "offload_h2d")
    return {
        "model": f"{cfg.name}, {cfg.num_layers} layers, {GRID_S} stages x "
                 f"hdp {GRID_H} x tp {GRID_TP}, offload on",
        "rounds": [list(ids) for ids in nu["rounds"]],
        "round_keys": [[list(c), cm, r, n] for c, cm, r, n in keys],
        "k_by_round": offloaded,
        "round_losses": nu["round_losses"],
        "ref_round_losses": [float(sum(ref["wave_losses"][j] for j in ids))
                             for ids in nu["rounds"]],
        "loss": rec["loss"], "grad_norm": rec["grad_norm"],
        "ref_grad_norm": ref["grad_norm"],
        "ledger_meas": [[r["meas"][x] for x in kinds] for r in recs],
        "ledger_pred": [[r["pred"][x] for x in kinds] for r in recs],
        "port_formula": [[port_round_bytes(
            cfg, c, n, GRID_S, 4096 * cm, GRID_H, k_off, tp=GRID_TP,
            kv_sharded=True)[x] for x in kinds]
            for (c, cm, _, n), k_off in zip(keys, offloaded)],
        "launches_per_rank": {n: got[:, i].astype(int).tolist()
                              for i, n in enumerate(names)},
        "want_launches_per_rank": want,
        "peak_mem_gb_per_rank": got[:, k].tolist(),
        "replicas_same": got[:, k + 1].tolist(),
        "step_wall_s_per_rank": got[:, k + 2].tolist(),
        "applied": got[:, k + 3].tolist(),
        "offload_d2h_h2d_bytes_per_rank": got[:, k + 4:k + 6].tolist(),
        "wall_s": time.perf_counter() - t0}


def grid_gates(res) -> list:
    """Phase 17 (a)'s gates on world rank 0's numbers -> what failed."""
    import numpy as np
    fails = []
    got, want = res["round_losses"], res["ref_round_losses"]
    if not (len(got) == len(want) and np.all(np.isfinite(got)) and np.all(
            np.abs(np.subtract(got, want)) <= PP_LOSS_TOL * np.abs(want))):
        fails.append(f"round losses {got} vs the one-process route {want}")
    g, w = res["grad_norm"], res["ref_grad_norm"]
    if not abs(g - w) <= TRAIN_LOSS_TOL * abs(w):
        fails.append(f"grad norm {g} vs the one-process route {w}")
    if not any(k > 0 for k in res["k_by_round"]):
        fails.append(f"no round offloads (k by round {res['k_by_round']})")
    if res["ledger_meas"] != res["port_formula"]:
        fails.append(f"measured bytes {res['ledger_meas']}, the port's "
                     f"formula {res['port_formula']}")
    for name, w in res["want_launches_per_rank"].items():
        if res["launches_per_rank"][name] != w:
            fails.append(f"{name} launches per rank "
                         f"{res['launches_per_rank'][name]}, want {w}")
    for key in ("replicas_same", "applied"):
        if np.any(np.asarray(res[key]) != 1):
            fails.append(f"{key} {res[key]}")
    return fails


def grid_rwkv_rank(torch, tp_comm):
    """Phase 17 (b) on a rank of stage 0: rwkv6-7b at full width cut to
    `GRID_RWKV_LAYERS`, one step on phase 5's data at hdp 1 x tp 2
    (counted), then on model rank 0 the same step at tp 1 from the same
    seed (not counted).  Returns model rank 0's numbers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("rwkv6-7b"),
                              num_layers=GRID_RWKV_LAYERS)

    def step(rt):
        sched = train_setup(cfg)
        tr = Trainer(cfg, rt, AdamWConfig(lr=3e-4, warmup_steps=0), sched,
                     TrainerConfig(capacity=4096, calibrate=False), seed=0)
        try:
            torch.cuda.reset_peak_memory_stats()
            return tr, tr.train_step()
        finally:
            sched.stop()

    torch.cuda.synchronize()
    zero_counts()
    tr, rec = step(Runtime(device=DEVICE, tp_comm=tp_comm))
    torch.cuda.synchronize()
    counts = read_counts()
    same = True
    for p, split in zip(leaves(tr.params), tr._splits):
        if split is None:
            b = p.clone()
            tp_comm.broadcast(b)
            same &= torch.equal(b, p)
    mine = torch.tensor([counts["fused_ce_fwd"], counts["fused_ce_bwd"],
                         float(same), tr.peak.high_water() / 1e9,
                         len(tr.last_numerics["wave_losses"])],
                        dtype=torch.float64, device=DEVICE)
    got = tp_comm.all_gather(mine).cpu().numpy()
    del tr
    torch.cuda.empty_cache()
    if tp_comm.rank:
        return None
    tr1, rec1 = step(Runtime(device=DEVICE))
    del tr1
    torch.cuda.empty_cache()
    return {"model": f"{cfg.name}, {cfg.num_layers} layer, hdp 1 x tp 2",
            "loss": rec["loss"], "loss_tp1": rec1["loss"],
            "grad_norm": rec["grad_norm"], "grad_norm_tp1": rec1["grad_norm"],
            "ce_launches_per_rank": got[:, :2].astype(int).tolist(),
            "waves": int(got[0, 4]),
            "replicated_same_across_model_group": got[:, 2].tolist(),
            "peak_mem_gb_per_rank": got[:, 3].tolist(),
            "step_wall_s": rec["wall_s"]}


def grid_rwkv_gates(res) -> list:
    fails = []
    for key, tol in (("loss", PP_LOSS_TOL), ("grad_norm", TRAIN_LOSS_TOL)):
        got, want = res[key], res[key + "_tp1"]
        if not abs(got - want) <= tol * abs(want):
            fails.append(f"{key} {got} vs tp 1 {want}")
    if res["ce_launches_per_rank"] != [[res["waves"]] * 2] * GRID_TP:
        fails.append(f"CE launches per rank {res['ce_launches_per_rank']}, "
                     f"want one each way a wave ({res['waves']})")
    if any(x != 1 for x in res["replicated_same_across_model_group"]):
        fails.append("a replicated leaf differs across the model group")
    return fails


def phase_grid(torch, card):
    """Phase 17: 4 processes share the card, world rank 0 this one.  ->
    the launches of (a) and (b), summed over the ranks."""
    import tempfile
    mp = torch.multiprocessing.get_context("spawn")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        store = str(Path(tmp) / "store")
        procs = [mp.Process(target=grid_rank, args=(r, store), daemon=True)
                 for r in range(1, GRID_S * GRID_H * GRID_TP)]
        for pr in procs:
            pr.start()
        try:
            a, b = grid_rank(0, store)
            for pr in procs:
                pr.join(HDP_TIMEOUT_S)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        codes = [pr.exitcode for pr in procs]
        if codes != [0] * len(procs):
            raise AssertionError(f"phase 17 rank exit codes {codes}")
    log(f"[grid] {card}: 4 rank processes share this card (gloo through "
        f"host memory), so the times measure no card-to-card transfer; "
        f"phase wall {time.perf_counter() - t0:.1f} s")
    log(f"[grid] (a) {json.dumps(a)}")
    log(f"[grid] (b) {json.dumps(b)}")
    fails = [f"(a) {f}" for f in grid_gates(a)] + \
        [f"(b) {f}" for f in grid_rwkv_gates(b)]
    if fails:
        raise AssertionError("phase 17: " + "; ".join(fails))
    out = {name: int(sum(v)) for name, v in a["launches_per_rank"].items()}
    out["fused_ce_fwd"] += sum(r[0] for r in b["ce_launches_per_rank"])
    out["fused_ce_bwd"] += sum(r[1] for r in b["ce_launches_per_rank"])
    return out


# ---------------------------------------------------------------------------
# 18. report
# ---------------------------------------------------------------------------

def kernels_line(cases, serve_launches, train_launches, ring_launches,
                 hdp_launches, offload_launches, hdp_serve_launches,
                 ckpt_launches, moe_launches, pp_launches, gemma_launches,
                 mla_launches, rwkv_launches, tp_launches, grid_launches):
    """Launches: the serve path for the forward kernels, the train path for
    the rest, plus the ring path's, the hdp = 4 trainer's (summed over
    its ranks), the offloading trainer's, the hdp = 4 engine's (summed
    over its ranks), the checkpoint phase's, the MoE phase's, the
    pipelined trainer's (summed over its ranks), the Gemma phase's, the
    MLA phase's, the RWKV phase's, the 2 x 2 grid's and the 2 x 1 x 2
    grid's (each summed over its ranks)."""
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
            + moe_launches[name] + pp_launches[name]
            + gemma_launches[name] + mla_launches[name]
            + rwkv_launches[name] + tp_launches[name]
            + grid_launches[name],
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
    pp_launches = phase_pipeline(torch, card)
    log(f"[pipeline] done at {time.perf_counter() - t0:.1f} s")
    gemma_launches = phase_gemma(torch, card)
    log(f"[gemma] done at {time.perf_counter() - t0:.1f} s")
    mla_launches = phase_mla(torch, card)
    log(f"[mla] done at {time.perf_counter() - t0:.1f} s")
    rwkv_launches, rwkv_cases = phase_rwkv(torch, card)
    cases.append(rwkv_cases)
    log(f"[rwkv] done at {time.perf_counter() - t0:.1f} s")
    tp_launches = phase_tp(torch, card)
    log(f"[tp] done at {time.perf_counter() - t0:.1f} s")
    grid_launches = phase_grid(torch, card)
    log(f"[grid] done at {time.perf_counter() - t0:.1f} s")
    log(json.dumps(kernels_line(cases, serve_launches, train_launches,
                                ring_launches, hdp_launches,
                                offload_launches, hdp_serve_launches,
                                ckpt_launches, moe_launches, pp_launches,
                                gemma_launches, mla_launches,
                                rwkv_launches, tp_launches,
                                grid_launches)))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
