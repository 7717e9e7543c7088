// Packed-segment flash attention forward for Hopper (sm_90a), bf16 in,
// fp32 online softmax.  One templated kernel, two epilogues:
//
//   CARRY = true   replaces repro/kernels/flash_attention.py::_fwd_carry_kernel
//                  (via flash_attention_fwd_carry): reads the carried
//                  unnormalised state (acc, m, l), folds every live KV tile
//                  into it and writes it back IN PLACE.  Every prefill layer
//                  of the serving path and every training forward (and its
//                  recomputation) runs this as ring step 0 from zero stats.
//   CARRY = false  replaces repro/kernels/flash_attention.py::_fwd_kernel
//                  (via flash_attention_fwd): starts from empty stats and
//                  writes out = acc / l (zero rows where l == 0) and
//                  lse = m + log l (NEG_INF where l == 0).
//
// Semantics follow the Pallas kernels exactly: mask = same segment, both
// segments > 0, k_pos <= q_pos (causal), q_pos - k_pos < window (when set);
// scores in fp32 (bf16 x bf16 products are exact in fp32), softcap
// softcap * tanh(s / softcap) before masking; masked scores take the finite
// sentinel -1e30 (never -inf) and p is zeroed AFTER the exponential, so a
// fully masked row keeps m = -1e30, l = 0, alpha = exp(0) = 1 and no NaN.
// p is rounded to bf16 (v's type) before the PV product, as the Pallas
// kernel casts it.  The exponentials use the hardware ex2 (__expf, ~1e-6
// relative error, far below p's bf16 rounding), as FlashAttention kernels
// do: the accurate expf cost ~15% of the kernel on an H100 (PERF.md).
//
// Design.  The TPU kernel walks the KV axis as the innermost "arbitrary"
// grid dimension and carries (acc, m, l) in VMEM scratch between grid
// steps.  On Hopper blocks run in no order, so one block owns one (g, h,
// 192 q rows): three warpgroups of 128 threads, each with its own 64-row q
// tile, keep the state in registers and loop over the KV tiles together,
// sharing each K/V tile they load (a third of the K/V traffic of one q tile
// per block; on an H100 three warpgroups beat two, PERF.md):
//  * Tile skipping.  A prologue reduces each warpgroup's q tile and every KV
//    tile to their seg/pos ranges and keeps a bitmask of the KV tiles that
//    `tile_relevant` (flash_tiles.cuh, the reference's _block_relevant per
//    tile) cannot rule out; the loop visits those only.  A dead tile would
//    add p = 0 with alpha = 1, so skipping it changes no bit.  Inside a live
//    tile the per-element mask stays, except on tiles `tile_full` proves
//    visible whole (most tiles below a segment's diagonal).
//  * Asynchronous loads.  K, V and the KV tile's seg/pos go through a
//    three-stage cp.async ring, two tiles ahead of the one in use, with one
//    barrier per tile.  The block loads the tiles live for either q tile; a
//    warpgroup skips the products of a tile live only for the other.
//  * wgmma.  S = Q K^T is m64n64k16 with Q and K in shared memory; O += P V
//    is m64n{Dv}k16 with P (bf16) taken from the score accumulator in
//    registers and V read MN-major from shared memory, so P never touches
//    shared memory.  Every Dk, Dv in {32, 64, 128}, and Dk = Dv = 256
//    (Gemma-2 and Gemma-3), uses wgmma.
//  * Head dim 256 (`FwdCfg`).  The O accumulator is 128 fp32 a thread, and
//    three warpgroups at one block an SM would have 170 registers each;
//    three q tiles and three stages of 64.5 KB K/V would take 289.5 KB of
//    shared memory.  So the (256, 256) instantiation runs two warpgroups
//    (up to 255 registers a thread) over a two-stage ring (193 KB); the
//    smaller head dims keep three and three.
//  * (Dk, Dv) = (576, 512) (DeepSeek-V2's latent attention) has a kernel of
//    its own, `flash_fwd_mla_kernel` below: two warpgroups split O by
//    columns over one q tile, one K and one V buffer.
// Ragged tails (T % 64, S % 64) load as zeros with segment 0 (masked) and
// are never stored.
//
// Bound on this card.  At the slice's shape (G=8, Hg=3, T=S=4096, D=128,
// segments 3000/900/120 + 76 padding rows) the visible pairs cost
// 2*G*Hg*pairs*(Dk+Dv) = 60 GFLOP, 0.061 ms at 989 TFLOP/s bf16; the bytes
// (q, k, v read once, the fp32 carry read and written, ~125 MB) take
// ~0.037 ms at 3.35 TB/s.  So the tensor cores bound it.  The gaps left to
// the bound: the live tiles hold 3.4x the visible pairs (1327 of 4096 64x64
// tiles at that shape); each block re-reads every live K/V tile through
// cp.async, and with neither products nor softmax that loop alone took most
// of the kernel's time on an H100 (PERF.md); the softmax does not
// overlap the products of the next tile (no ping-pong between warpgroups).
// TMA loads are the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); plain C entry
// point, loaded with ctypes, launched on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

constexpr float NEG_INF = -1.0e30f;

// consumer warpgroups per block (each: 4 warps x 16 q rows) and the K/V
// ring's depth, per instantiation: three and three (two tiles ahead) up to
// head dim 128, two and two at 256
template <int DK, int DV>
struct FwdCfg {
  static constexpr bool WIDE = DK > 128 || DV > 128;
  static constexpr int NWG = WIDE ? 2 : 3;
  static constexpr int NTHREADS = 128 * NWG;
  static constexpr int NSTAGE = WIDE ? 2 : 3;
};

// shared memory: NWG q tiles, NSTAGE x (K tile, V tile, k_seg, k_pos), then
// per warpgroup the live-tile and full-tile bitmasks and their union
template <int DK, int DV>
struct FwdSmem {
  static constexpr int NWG = FwdCfg<DK, DV>::NWG;
  static constexpr int NSTAGE = FwdCfg<DK, DV>::NSTAGE;
  static constexpr int Q = TILE * DK * 2;
  static constexpr int K = TILE * DK * 2;
  static constexpr int V = TILE * DV * 2;
  static constexpr int STAGE = K + V + 2 * TILE * 4;
  static constexpr int MASK = NWG * Q + NSTAGE * STAGE;
  static size_t bytes(int n_tiles) {
    return MASK + (size_t)((n_tiles + 31) / 32) * 4 * (2 * NWG + 1);
  }
};

// scale and softcap the scores of one tile in place and, unless every pair
// of the tile is visible (FULL), mask them (-1e30); returns bit i set where
// s[i] is unmasked
template <bool FULL>
__device__ __forceinline__ uint32_t mask_scores(
    float (&s)[32], const int* sKseg, const int* sKpos, int tig, int qseg_lo,
    int qseg_hi, int qpos_lo, int qpos_hi, float scale, int causal,
    int window, float softcap) {
  uint32_t ok_bits = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    bool ok = true;
    if (!FULL) {
      const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
      const bool hi = (i & 2) != 0;
      const int qs = hi ? qseg_hi : qseg_lo;
      const int qp = hi ? qpos_hi : qpos_lo;
      const int ks = sKseg[col], kp = sKpos[col];
      ok = (qs == ks) && (qs > 0) && (ks > 0);
      if (causal) ok = ok && (kp <= qp);
      if (window) ok = ok && (qp - kp < window);
    }
    float x = s[i] * scale;
    if (softcap != 0.f) x = softcap * tanhf(x / softcap);
    s[i] = ok ? x : NEG_INF;
    if (ok) ok_bits |= 1u << i;
  }
  return ok_bits;
}

template <int DK, int DV, bool CARRY>
__global__ void __launch_bounds__(FwdCfg<DK, DV>::NTHREADS, 1)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_seg, const int* __restrict__ k_seg,
                 const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                 float* acc, float* m_io, float* l_io,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int Hg, int T, int S, float scale, int causal, int window,
                 float softcap) {
  using L = FwdSmem<DK, DV>;
  constexpr int NWG = FwdCfg<DK, DV>::NWG;
  constexpr int NTHREADS = FwdCfg<DK, DV>::NTHREADS;
  constexpr int NSTAGE = FwdCfg<DK, DV>::NSTAGE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n_kv = (S + TILE - 1) / TILE;
  const int words = (n_kv + 31) / 32;
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem_raw + L::MASK);
  __shared__ TileMeta mines[NWG];

  const int g = blockIdx.z, h = blockIdx.y;
  const int wg = threadIdx.x >> 7;        // this warpgroup's q tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;   // row group / thread in group
  const int q0 = (blockIdx.x * NWG + wg) * TILE;
  const uint32_t sQ = smem_u32(smem_raw) + wg * L::Q;
  const uint32_t sStage = smem_u32(smem_raw) + NWG * L::Q;

  const size_t head = (size_t)g * Hg + h;
  const __nv_bfloat16* qh = q + head * T * DK;
  const __nv_bfloat16* kg = k + (size_t)g * S * DK;
  const __nv_bfloat16* vg = v + (size_t)g * S * DV;

  // the KV tiles any query of each q tile can see, those all its queries
  // see whole, and the union the block loads
  if ((threadIdx.x & 127) < 32) {
    const TileMeta m = warp_tile_meta(q_seg, q_pos, T, q0 / TILE, lane);
    if (lane == 0) mines[wg] = m;
  }
  __syncthreads();
  build_live_masks<NTHREADS, NWG>(masks, words, n_kv, k_seg, k_pos, S, mines,
                                  true, causal, window);
  const uint32_t* live = masks + 2 * wg * words;
  const uint32_t* full = live + words;
  const uint32_t* any = masks + 2 * NWG * words;

  // this thread's two q rows within the tile, and their metadata
  const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;
  const int t_lo = q0 + r_lo, t_hi = q0 + r_hi;
  const bool in_lo = t_lo < T, in_hi = t_hi < T;
  const int qseg_lo = in_lo ? q_seg[t_lo] : 0;
  const int qseg_hi = in_hi ? q_seg[t_hi] : 0;
  const int qpos_lo = in_lo ? q_pos[t_lo] : 0;
  const int qpos_hi = in_hi ? q_pos[t_hi] : 0;

  // online-softmax state: o[4 nt + {0,1}] holds acc[row lo][8 nt + 2 tig +
  // {0,1}], o[4 nt + {2,3}] the same columns of row hi (the wgmma
  // accumulator layout)
  float o[DV / 2];
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  float* acc_h = acc + head * T * DV;
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt) {
    o[4 * nt] = o[4 * nt + 1] = o[4 * nt + 2] = o[4 * nt + 3] = 0.f;
    if (CARRY) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo) {
        const float2 a = *reinterpret_cast<const float2*>(acc_h + (size_t)t_lo * DV + c);
        o[4 * nt] = a.x; o[4 * nt + 1] = a.y;
      }
      if (in_hi) {
        const float2 a = *reinterpret_cast<const float2*>(acc_h + (size_t)t_hi * DV + c);
        o[4 * nt + 2] = a.x; o[4 * nt + 3] = a.y;
      }
    }
  }
  if (CARRY) {
    if (in_lo) { m_lo = m_io[head * T + t_lo]; l_lo = l_io[head * T + t_lo]; }
    if (in_hi) { m_hi = m_io[head * T + t_hi]; l_hi = l_io[head * T + t_hi]; }
  }

  auto issue = [&](int kt, int stage) {
    const uint32_t st = sStage + stage * L::STAGE;
    load_tile_async<DK, NTHREADS>(st, kg, kt * TILE, S);
    load_tile_async<DV, NTHREADS>(st + L::K, vg, kt * TILE, S);
    load_vec_async(st + L::K + L::V, k_seg, kt * TILE, S);
    load_vec_async(st + L::K + L::V + TILE * 4, k_pos, kt * TILE, S);
  };

  // the ring: kts[0] is this step's tile, kts[1 ..] the tiles in flight
  int kts[NSTAGE - 1];
  kts[0] = next_live(any, 0, n_kv);
  if (kts[0] < n_kv) {                    // the q tiles and the first tile
#pragma unroll
    for (int w = 0; w < NWG; ++w)
      load_tile_async<DK, NTHREADS>(smem_u32(smem_raw) + w * L::Q, qh,
                                    (blockIdx.x * NWG + w) * TILE, T);
    issue(kts[0], 0);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 1; j < NSTAGE - 1; ++j) {
    kts[j] = next_live(any, kts[j - 1] + 1, n_kv);
    if (kts[j] < n_kv) issue(kts[j], j);
    cp_async_commit();
  }
  int stage = 0;
  while (kts[0] < n_kv) {
    const int kt = kts[0];
    cp_async_wait<NSTAGE - 2>();          // tile kt (and the q tiles) landed
    fence_async_smem();
    __syncthreads();                      // ... for every thread; and every
                                          // thread is done with tile kt - 1
    const int nxt = next_live(any, kts[NSTAGE - 2] + 1, n_kv);
    if (nxt < n_kv) issue(nxt, (stage + NSTAGE - 1) % NSTAGE);
    cp_async_commit();

    if (bit(live, kt)) {                  // warpgroup-uniform
      const uint32_t sK = sStage + stage * L::STAGE;
      const uint32_t sV = sK + L::K;
      const int* sKseg = reinterpret_cast<const int*>(
          smem_raw + NWG * L::Q + stage * L::STAGE + L::K + L::V);
      const int* sKpos = sKseg + TILE;

      // scores S = Q K^T: this warp's 16 rows x 64 columns
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss_n64(s, desc_k<DK>(sQ, kk), desc_k<DK>(sK, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);

      // scale, softcap, mask; row maxima
      const uint32_t ok_bits =
          bit(full, kt)
              ? mask_scores<true>(s, sKseg, sKpos, tig, qseg_lo, qseg_hi,
                                  qpos_lo, qpos_hi, scale, causal, window,
                                  softcap)
              : mask_scores<false>(s, sKseg, sKpos, tig, qseg_lo, qseg_hi,
                                   qpos_lo, qpos_hi, scale, causal, window,
                                   softcap);
      float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) mx_hi = fmaxf(mx_hi, s[i]); else mx_lo = fmaxf(mx_lo, s[i]);
      }
      // the four threads of a group share a row
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);

      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i & 2) != 0;
        const float p = ((ok_bits >> i) & 1u)
                            ? __expf(s[i] - (hi ? mn_hi : mn_lo)) : 0.f;
        s[i] = p;
        if (hi) rs_hi += p; else rs_lo += p;
      }
      rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 1);
      rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 2);
      rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 1);
      rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 2);

      const float al_lo = __expf(m_lo - mn_lo), al_hi = __expf(m_hi - mn_hi);
      l_lo = l_lo * al_lo + rs_lo;
      l_hi = l_hi * al_hi + rs_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= (i & 2) ? al_hi : al_lo;

      // O += P V: P (bf16) straight from the score registers as A fragments
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], s, kk);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DV>(o, pa[kk], desc_mn<DV>(sV, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
    }
#pragma unroll
    for (int j = 0; j < NSTAGE - 2; ++j) kts[j] = kts[j + 1];
    kts[NSTAGE - 2] = nxt;
    stage = (stage + 1) % NSTAGE;
  }

  // epilogue
  if (CARRY) {
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo)
        *reinterpret_cast<float2*>(acc_h + (size_t)t_lo * DV + c) =
            make_float2(o[4 * nt], o[4 * nt + 1]);
      if (in_hi)
        *reinterpret_cast<float2*>(acc_h + (size_t)t_hi * DV + c) =
            make_float2(o[4 * nt + 2], o[4 * nt + 3]);
    }
    if (tig == 0) {
      if (in_lo) { m_io[head * T + t_lo] = m_lo; l_io[head * T + t_lo] = l_lo; }
      if (in_hi) { m_io[head * T + t_hi] = m_hi; l_io[head * T + t_hi] = l_hi; }
    }
  } else {
    __nv_bfloat16* out_h = out + head * T * DV;
    const bool live_lo = l_lo > 0.f, live_hi = l_hi > 0.f;
    const float d_lo = live_lo ? l_lo : 1.f, d_hi = live_hi ? l_hi : 1.f;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo)
        *reinterpret_cast<uint32_t*>(out_h + (size_t)t_lo * DV + c) =
            live_lo ? pack_f2(o[4 * nt] / d_lo, o[4 * nt + 1] / d_lo) : 0u;
      if (in_hi)
        *reinterpret_cast<uint32_t*>(out_h + (size_t)t_hi * DV + c) =
            live_hi ? pack_f2(o[4 * nt + 2] / d_hi, o[4 * nt + 3] / d_hi) : 0u;
    }
    if (tig == 0) {
      if (in_lo) lse[head * T + t_lo] = live_lo ? m_lo + logf(l_lo) : NEG_INF;
      if (in_hi) lse[head * T + t_hi] = live_hi ? m_hi + logf(l_hi) : NEG_INF;
    }
  }
}

// ---------------------------------------------------------------------------
// (Dk, Dv) = (576, 512): DeepSeek-V2's Multi-head Latent Attention in the
// absorbed form (every head attends to one latent of kv_lora_rank 512 +
// qk_rope 64 columns, its values the first 512)
// ---------------------------------------------------------------------------
//
// The template above does not hold this shape.  Its O accumulator would be
// 256 fp32 a thread in one warpgroup, more than the 255 registers a thread
// has, and one stage of K (72 KB) and V (64 KB) beside one Q tile (72 KB)
// already takes 208 KB of the 227 KB a block may use.  So one block owns
// one (g, h, 64-row q tile) with two warpgroups that share the Q tile and
// split O by columns: warpgroup w holds columns [256 w, 256 w + 256) (128
// fp32 a thread, as at head dim 256).  Each warpgroup computes the whole
// score tile S = Q K^T itself (36 m64n64k16) and the same softmax, so both
// hold the same P, m and l without exchanging them; the cost is S computed
// twice, 1.5x the tensor-core work of the bound, where sharing P through
// shared memory would add a barrier between the warpgroups per tile.  One
// K buffer and one V buffer, no ring: the next K tile loads while this
// tile's P V runs, the next V tile while the next S runs.  The carried m and
// l are read by both warpgroups before the loop and written back by
// warpgroup 0 alone after a barrier, so no warpgroup reads a value another
// has already replaced.
constexpr int MLA_DK = 576, MLA_DV = 512;
constexpr int MLA_NWG = 2;                 // warpgroups, DV / 2 columns each
constexpr int MLA_NT = 128 * MLA_NWG;

// shared memory: the Q tile, one K tile, one V tile, the K tile's k_seg and
// k_pos, then the live-tile and full-tile bitmasks
struct MlaFwdSmem {
  static constexpr int Q = TILE * MLA_DK * 2;
  static constexpr int K = TILE * MLA_DK * 2;
  static constexpr int V = TILE * MLA_DV * 2;
  static constexpr int KOFF = Q;
  static constexpr int VOFF = Q + K;
  static constexpr int META = Q + K + V;
  static constexpr int MASK = META + 2 * TILE * 4;
  static size_t bytes(int n_tiles) {
    return MASK + (size_t)((n_tiles + 31) / 32) * 8;
  }
};

template <bool CARRY>
__global__ void __launch_bounds__(MLA_NT, 1)
flash_fwd_mla_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ k_seg,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, float* acc, float* m_io,
                     float* l_io, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int Hg, int T, int S,
                     float scale, int causal, int window, float softcap) {
  using L = MlaFwdSmem;
  constexpr int DK = MLA_DK, DV = MLA_DV, DW = MLA_DV / MLA_NWG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n_kv = (S + TILE - 1) / TILE;
  const int words = (n_kv + 31) / 32;
  uint32_t* live = reinterpret_cast<uint32_t*>(smem_raw + L::MASK);
  const uint32_t* full = live + words;
  const int* sKseg = reinterpret_cast<const int*>(smem_raw + L::META);
  const int* sKpos = sKseg + TILE;

  const int g = blockIdx.z, h = blockIdx.y;
  const int wg = threadIdx.x >> 7;        // this warpgroup's O columns
  const int c0 = wg * DW;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * TILE;
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQ = base, sK = base + L::KOFF, sV = base + L::VOFF;

  const size_t head = (size_t)g * Hg + h;
  const __nv_bfloat16* qh = q + head * T * DK;
  const __nv_bfloat16* kg = k + (size_t)g * S * DK;
  const __nv_bfloat16* vg = v + (size_t)g * S * DV;

  // the KV tiles any query of the q tile can see, and those all its
  // queries see whole
  const TileMeta mine = warp_tile_meta(q_seg, q_pos, T, blockIdx.x, lane);
  build_live_masks<MLA_NT, 1>(live, words, n_kv, k_seg, k_pos, S, &mine,
                              true, causal, window);

  const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;
  const int t_lo = q0 + r_lo, t_hi = q0 + r_hi;
  const bool in_lo = t_lo < T, in_hi = t_hi < T;
  const int qseg_lo = in_lo ? q_seg[t_lo] : 0;
  const int qseg_hi = in_hi ? q_seg[t_hi] : 0;
  const int qpos_lo = in_lo ? q_pos[t_lo] : 0;
  const int qpos_hi = in_hi ? q_pos[t_hi] : 0;

  // this warpgroup's columns of the online-softmax state (the wgmma
  // accumulator layout, as in flash_fwd_kernel)
  float o[DW / 2];
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  float* acc_h = acc + head * T * DV + c0;
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt) {
    o[4 * nt] = o[4 * nt + 1] = o[4 * nt + 2] = o[4 * nt + 3] = 0.f;
    if (CARRY) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo) {
        const float2 a = *reinterpret_cast<const float2*>(acc_h + (size_t)t_lo * DV + c);
        o[4 * nt] = a.x; o[4 * nt + 1] = a.y;
      }
      if (in_hi) {
        const float2 a = *reinterpret_cast<const float2*>(acc_h + (size_t)t_hi * DV + c);
        o[4 * nt + 2] = a.x; o[4 * nt + 3] = a.y;
      }
    }
  }
  if (CARRY) {
    if (in_lo) { m_lo = m_io[head * T + t_lo]; l_lo = l_io[head * T + t_lo]; }
    if (in_hi) { m_hi = m_io[head * T + t_hi]; l_hi = l_io[head * T + t_hi]; }
  }

  auto issue_k = [&](int kt) {
    load_tile_async<DK, MLA_NT>(sK, kg, kt * TILE, S);
    load_vec_async(base + L::META, k_seg, kt * TILE, S);
    load_vec_async(base + L::META + TILE * 4, k_pos, kt * TILE, S);
  };

  // cp.async groups in commit order: (Q, K_0), V_0, then per tile K_next
  // and V_next
  int kt = next_live(live, 0, n_kv);
  if (kt < n_kv) {
    load_tile_async<DK, MLA_NT>(sQ, qh, q0, T);
    issue_k(kt);
  }
  cp_async_commit();
  if (kt < n_kv) load_tile_async<DV, MLA_NT>(sV, vg, kt * TILE, S);
  cp_async_commit();
  while (kt < n_kv) {
    cp_async_wait<1>();                   // K_kt (and Q) landed
    fence_async_smem();
    __syncthreads();

    // scores S = Q K^T: this warp's 16 rows x 64 columns
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(s, desc_k<DK>(sQ, kk), desc_k<DK>(sK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    const uint32_t ok_bits =
        bit(full, kt)
            ? mask_scores<true>(s, sKseg, sKpos, tig, qseg_lo, qseg_hi,
                                qpos_lo, qpos_hi, scale, causal, window,
                                softcap)
            : mask_scores<false>(s, sKseg, sKpos, tig, qseg_lo, qseg_hi,
                                 qpos_lo, qpos_hi, scale, causal, window,
                                 softcap);
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx_hi = fmaxf(mx_hi, s[i]); else mx_lo = fmaxf(mx_lo, s[i]);
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i & 2) != 0;
      const float p = ((ok_bits >> i) & 1u)
                          ? __expf(s[i] - (hi ? mn_hi : mn_lo)) : 0.f;
      s[i] = p;
      if (hi) rs_hi += p; else rs_lo += p;
    }
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 1);
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 2);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 1);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 2);
    const float al_lo = __expf(m_lo - mn_lo), al_hi = __expf(m_hi - mn_hi);
    l_lo = l_lo * al_lo + rs_lo;
    l_hi = l_hi * al_hi + rs_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) o[i] *= (i & 2) ? al_hi : al_lo;
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], s, kk);

    cp_async_wait<0>();                   // V_kt landed
    fence_async_smem();
    __syncthreads();                      // ... for every thread; and every
                                          // warpgroup is done with K_kt and
                                          // its k_seg / k_pos
    const int nxt = next_live(live, kt + 1, n_kv);
    if (nxt < n_kv) issue_k(nxt);
    cp_async_commit();

    // O[:, c0 : c0 + 256] += P V[:, c0 : c0 + 256]
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DW>(o, pa[kk], desc_mn<DV>(sV + c0 * 16, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    __syncthreads();                      // every warpgroup is done with V_kt
    if (nxt < n_kv) load_tile_async<DV, MLA_NT>(sV, vg, nxt * TILE, S);
    cp_async_commit();
    kt = nxt;
  }
  __syncthreads();                        // both warpgroups read the carry-in

  if (CARRY) {
#pragma unroll
    for (int nt = 0; nt < DW / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo)
        *reinterpret_cast<float2*>(acc_h + (size_t)t_lo * DV + c) =
            make_float2(o[4 * nt], o[4 * nt + 1]);
      if (in_hi)
        *reinterpret_cast<float2*>(acc_h + (size_t)t_hi * DV + c) =
            make_float2(o[4 * nt + 2], o[4 * nt + 3]);
    }
    if (wg == 0 && tig == 0) {
      if (in_lo) { m_io[head * T + t_lo] = m_lo; l_io[head * T + t_lo] = l_lo; }
      if (in_hi) { m_io[head * T + t_hi] = m_hi; l_io[head * T + t_hi] = l_hi; }
    }
  } else {
    __nv_bfloat16* out_h = out + head * T * DV + c0;
    const bool live_lo = l_lo > 0.f, live_hi = l_hi > 0.f;
    const float d_lo = live_lo ? l_lo : 1.f, d_hi = live_hi ? l_hi : 1.f;
#pragma unroll
    for (int nt = 0; nt < DW / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo)
        *reinterpret_cast<uint32_t*>(out_h + (size_t)t_lo * DV + c) =
            live_lo ? pack_f2(o[4 * nt] / d_lo, o[4 * nt + 1] / d_lo) : 0u;
      if (in_hi)
        *reinterpret_cast<uint32_t*>(out_h + (size_t)t_hi * DV + c) =
            live_hi ? pack_f2(o[4 * nt + 2] / d_hi, o[4 * nt + 3] / d_hi) : 0u;
    }
    if (wg == 0 && tig == 0) {
      if (in_lo) lse[head * T + t_lo] = live_lo ? m_lo + logf(l_lo) : NEG_INF;
      if (in_hi) lse[head * T + t_hi] = live_hi ? m_hi + logf(l_hi) : NEG_INF;
    }
  }
}

template <bool CARRY>
cudaError_t launch_mla(const void* q, const void* k, const void* v,
                       const void* q_seg, const void* k_seg,
                       const void* q_pos, const void* k_pos, void* acc,
                       void* m, void* l, void* out, void* lse, int G, int Hg,
                       int T, int S, float scale, int causal, int window,
                       float softcap, cudaStream_t stream) {
  const size_t smem = MlaFwdSmem::bytes((S + TILE - 1) / TILE);
  auto kern = flash_fwd_mla_kernel<CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TILE - 1) / TILE, Hg, G);
  kern<<<grid, MLA_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(k_seg), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Hg, T, S,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

template <int DK, int DV, bool CARRY>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_seg, const void* k_seg, const void* q_pos,
                   const void* k_pos, void* acc, void* m, void* l, void* out,
                   void* lse, int G, int Hg, int T, int S, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = FwdSmem<DK, DV>::bytes((S + TILE - 1) / TILE);
  auto kern = flash_fwd_kernel<DK, DV, CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int NWG = FwdCfg<DK, DV>::NWG;
  const dim3 grid((T + NWG * TILE - 1) / (NWG * TILE), Hg, G);
  kern<<<grid, FwdCfg<DK, DV>::NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(k_seg), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Hg, T, S,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_mode(int carry, const void* q, const void* k,
                        const void* v, const void* q_seg, const void* k_seg,
                        const void* q_pos, const void* k_pos, void* acc,
                        void* m, void* l, void* out, void* lse, int G, int Hg,
                        int T, int S, float scale, int causal, int window,
                        float softcap, cudaStream_t stream) {
  if (carry)
    return launch<DK, DV, true>(q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m,
                                l, out, lse, G, Hg, T, S, scale, causal,
                                window, softcap, stream);
  return launch<DK, DV, false>(q, k, v, q_seg, k_seg, q_pos, k_pos, acc, m, l,
                               out, lse, G, Hg, T, S, scale, causal, window,
                               softcap, stream);
}

template <int DK>
cudaError_t launch_dv(int dv, int carry, const void* q, const void* k,
                      const void* v, const void* q_seg, const void* k_seg,
                      const void* q_pos, const void* k_pos, void* acc,
                      void* m, void* l, void* out, void* lse, int G, int Hg,
                      int T, int S, float scale, int causal, int window,
                      float softcap, cudaStream_t stream) {
#define FLASH_DV(DV)                                                        \
  case DV:                                                                  \
    return launch_mode<DK, DV>(carry, q, k, v, q_seg, k_seg, q_pos, k_pos,  \
                               acc, m, l, out, lse, G, Hg, T, S, scale,     \
                               causal, window, softcap, stream);
  if constexpr (DK == 256) {              // head dim 256: (256, 256) only
    switch (dv) {
      FLASH_DV(256)
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    switch (dv) {
      FLASH_DV(32)
      FLASH_DV(64)
      FLASH_DV(128)
      default:
        return cudaErrorInvalidValue;
    }
  }
#undef FLASH_DV
}

}  // namespace

// Plain C entry point (ctypes).  q [G,Hg,T,Dk], k [G,S,Dk], v [G,S,Dv] bf16;
// seg/pos int32 [T] and [S]; carry != 0: acc [G,Hg,T,Dv], m, l [G,Hg,T]
// fp32 updated in place (out, lse unused); carry == 0: out [G,Hg,T,Dv]
// bf16 and lse [G,Hg,T] fp32 written (acc, m, l unused).  All contiguous.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* q_seg, const void* k_seg,
                              const void* q_pos, const void* k_pos, void* acc,
                              void* m, void* l, void* out, void* lse,
                              int carry, int G, int Hg, int T, int S, int dk,
                              int dv, float scale, int causal, int window,
                              float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 32:
      return launch_dv<32>(dv, carry, q, k, v, q_seg, k_seg, q_pos, k_pos,
                           acc, m, l, out, lse, G, Hg, T, S, scale, causal,
                           window, softcap, st);
    case 64:
      return launch_dv<64>(dv, carry, q, k, v, q_seg, k_seg, q_pos, k_pos,
                           acc, m, l, out, lse, G, Hg, T, S, scale, causal,
                           window, softcap, st);
    case 128:
      return launch_dv<128>(dv, carry, q, k, v, q_seg, k_seg, q_pos, k_pos,
                            acc, m, l, out, lse, G, Hg, T, S, scale, causal,
                            window, softcap, st);
    case 256:
      return launch_dv<256>(dv, carry, q, k, v, q_seg, k_seg, q_pos, k_pos,
                            acc, m, l, out, lse, G, Hg, T, S, scale, causal,
                            window, softcap, st);
    case MLA_DK:                          // (576, 512) only
      if (dv != MLA_DV) return cudaErrorInvalidValue;
      return carry ? launch_mla<true>(q, k, v, q_seg, k_seg, q_pos, k_pos,
                                      acc, m, l, out, lse, G, Hg, T, S,
                                      scale, causal, window, softcap, st)
                   : launch_mla<false>(q, k, v, q_seg, k_seg, q_pos, k_pos,
                                       acc, m, l, out, lse, G, Hg, T, S,
                                       scale, causal, window, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}
