// Packed-segment flash attention backward for Hopper (sm_90a), bf16 in,
// fp32 math.  Two deterministic kernels, no atomics, launched in this order
// on one stream:
//
//   flash_bwd_dq_kernel   replaces repro/kernels/flash_attention.py::
//                         _bwd_dq_kernel (inside flash_attention_bwd): one
//                         block per (g, 64-row q tile, 3 heads of the
//                         group) loops over the live KV tiles and keeps dq
//                         in registers; dq = scale * sum_k ds * k.  It also
//                         writes delta = rowsum(do * out) [G, Hg, T] fp32,
//                         once per q row, for the dkv kernel.
//   flash_bwd_dkv_kernel  replaces repro/kernels/flash_attention.py::
//                         _bwd_dkv_kernel: one block per (g, 64-row KV tile)
//                         loops over the Hg heads and the live q tiles;
//                         dv = sum p^T do, dk = scale * sum ds^T q.
//
// Both recompute, per (q, k) pair: s = scale * q.k (softcap: s = c*tanh(s/c),
// dcap = 1 - tanh^2), p = exp(s - lse) zeroed AFTER the exponential where the
// mask is off (padding rows carry lse = -1e30, so exp(s - lse) is never used
// unmasked), dp = do.v, ds = p * (dp - delta) * dcap.  Mask = same segment,
// both segments > 0, k_pos <= q_pos (causal), q_pos - k_pos < window (when
// set).  The Pallas kernels keep p and ds in fp32; here each enters its
// product (p for dv, ds for dk and dq) as two bf16 fragments,
// hi = bf16(x) and lo = bf16(x - hi), so x is carried to ~16 bits.  Rounded
// once to bf16, as FlashAttention-2 does, p lost up to 0.036 absolute on dv
// of a segment's first keys, where terms near 1 of both signs cancel.
//
// Design.  On the TPU the grid walks the reduction axis sequentially and
// carries the accumulator in VMEM scratch; here one block owns an output
// tile and loops over the reduction itself.  Both kernels visit only the
// tiles that `tile_relevant` (flash_tiles.cuh, the reference's
// _block_relevant per tile) cannot rule out, which drops exact zeros only,
// and skip the element-wise mask on tiles `tile_full` proves visible whole.
// Tiles sit in shared memory in the core-matrix layout, and every product
// is a wgmma.
//  * dq: three warpgroups (DQ_NW) share one 64-row q tile, each for one
//    head of the group, so the block's one bitmask of live KV tiles serves
//    every head and each K/V tile it loads serves three heads.  K, V, k_seg
//    and k_pos come in through a two-stage cp.async ring (the next live
//    tile loads while this one is in use); Q and dO of each head load
//    once, with the first stage, while the block computes delta.  Per live
//    tile and head: S = Q K^T and dP = dO V^T (m64n64k16, both operands in
//    shared memory); ds in registers; dQ += dS K (m64n{Dk}k16, dS as hi +
//    lo register A fragments, K read MN-major from the tile S used).  dq
//    stays in registers (64 floats a thread at Dk = 128; 128 at Dk = 256,
//    where the block holds one head: `DqCfg`).  A warpgroup
//    whose head is past Hg skips the products and stores but reaches every
//    barrier.  The blocks of the last q tiles, which see the most KV tiles
//    under a causal mask, start first.  On an H100 three heads a block beat
//    two and one, two stages beat three, and the heavy tiles first beat the
//    grid's natural order (PERF.md).  The per-row metadata sits in shared
//    memory and the copies are split evenly over 256 threads that compute
//    their addresses at each copy, which keeps three warpgroups within 168
//    registers a thread without a spill.
//  * dkv: one warpgroup (128 threads) owns 64 KV rows and keeps a bitmask
//    of the live q tiles; the (head, q tile) steps of dead tiles are
//    skipped.  K and V load once, as wgmma A operands in shared memory.
//    Q, dO, q_seg, q_pos, lse and delta of the next live step come in
//    through a two-stage cp.async ring while the tensor cores work on this
//    one.  Per step: S^T = K Q^T and dP^T = V dO^T (m64n64k16, both
//    operands in shared memory); p^T and ds^T in registers; dV += P^T dO
//    and dK += dS^T Q (m64n{Dv,Dk}k16, P^T and dS^T as hi + lo register A
//    fragments, dO and Q read MN-major from the same tiles).  dk and dv
//    stay in registers (128 floats a thread at Dk = Dv = 128) for the whole
//    block; two blocks share an SM.  Two warpgroups sharing each Q/dO tile
//    (128 KV rows a block, a three-stage ring, one block per SM) gave the
//    same bits but ran slower on an H100 (PERF.md): the Q/dO loads do not
//    bound this kernel.
//  * dkv at Dk = Dv = 256 (`DkvCfg::SPLIT`): dk and dv would be 128 + 128
//    fp32 a thread, more than the 255 registers a thread can hold.  Two
//    warpgroups share each 64-row KV tile and its Q/dO ring (256 threads,
//    one block an SM, 194 KB of shared memory): warpgroup 0 holds dV and
//    warpgroup 1 dK.  Each computes S^T = K Q^T itself (the dV warpgroup
//    needs P^T, the dK one dS^T, which also takes dP^T = V dO^T), so one
//    product of the four a step is done twice, where sharing P^T through
//    shared memory would add a barrier between the warpgroups on every
//    step; two passes over the q tiles would load Q and dO twice.
//  * (Dk, Dv) = (576, 512) (DeepSeek-V2's latent attention) has kernels of
//    their own, `flash_bwd_dq_mla_kernel` and `flash_bwd_dkv_mla_kernel`
//    below: one warpgroup a block, each block one column range of dq, dk
//    or dv.
// Ragged tails (T % 64, S % 64) load as zeros with segment 0.  dq writes
// every row < T of its tile (zeros where no key is visible), dkv every
// row < S of its tile.
//
// Bound on this card.  Per visible (q, k) pair and head the dq kernel does
// 2*(2*Dk + Dv) flops and the dkv kernel 2*(2*Dk + 2*Dv) (the lo fragments
// of p and ds add tensor-core work the bound does not count); at the training
// slice's shape (G=8, Hg=3, T=S=4096, D=128, segments 3000/900/120) that is
// ~0.09 and ~0.12 ms of bf16 tensor-core time, above the ~0.04 ms their bytes
// take at 3.35 TB/s, so operations bound both.  The gaps left to the bound:
// the live tiles hold 3.4x the visible pairs at that shape; the lo
// fragments double the products that take p or ds; and the element-wise
// pass of a tile does not overlap the products of the next.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); plain C entry
// points, loaded with ctypes, launched on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;


__device__ __forceinline__ bool visible(int qs, int qp, int ks, int kp,
                                        int causal, int window) {
  bool ok = (qs == ks) && (qs > 0) && (ks > 0);
  if (causal) ok = ok && (kp <= qp);
  if (window) ok = ok && (qp - kp < window);
  return ok;
}

// ds for one (q, k) pair from its raw score q.k and dp = do.v
__device__ __forceinline__ void pair_grad(float raw, float dp, bool ok,
                                          float lse, float delta, float scale,
                                          float softcap, float& p, float& ds) {
  float x = raw * scale, dcap = 1.f;
  if (softcap != 0.f) {
    const float th = tanhf(x / softcap);
    x = softcap * th;
    dcap = 1.f - th * th;
  }
  p = ok ? expf(x - lse) : 0.f;
  ds = p * (dp - delta) * dcap;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

constexpr int DQ_NSTAGE = 2;              // K/V ring depth

// heads (warpgroups) per block: three up to head dim 128; one at 256,
// whose dq accumulator is 128 fp32 a thread (255 registers at 128 threads
// a block) and whose Q and dO tiles take 64 KB a head
template <int DK, int DV>
struct DqCfg {
  static constexpr int NW = (DK > 128 || DV > 128) ? 1 : 3;
  static constexpr int NT = 128 * NW;     // threads per block
};

// shared memory of the dq kernel: per warpgroup its Q and dO tiles, then
// DQ_NSTAGE x (K tile, V tile, k_seg, k_pos), per warpgroup the delta and
// lse of its 64 rows, the q tile's q_seg and q_pos, then the live-tile and
// full-tile bitmasks
template <int DK, int DV>
struct DqSmem {
  static constexpr int DQ_NW = DqCfg<DK, DV>::NW;
  static constexpr int Q = TILE * DK * 2;
  static constexpr int DO = TILE * DV * 2;
  static constexpr int HEAD = Q + DO;
  static constexpr int K = TILE * DK * 2;
  static constexpr int V = TILE * DV * 2;
  static constexpr int STAGE = K + V + 2 * TILE * 4;
  static constexpr int ROWS = DQ_NW * HEAD + DQ_NSTAGE * STAGE;
  static constexpr int MASK = ROWS + (2 * DQ_NW + 2) * TILE * 4;
  static size_t bytes(int n_tiles) {
    return MASK + (size_t)((n_tiles + 31) / 32) * 8;
  }
};

template <int DK, int DV>
__global__ void __launch_bounds__(DqCfg<DK, DV>::NT, 1)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ k_seg,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos,
                    const __nv_bfloat16* __restrict__ out,
                    const float* __restrict__ lse,
                    const __nv_bfloat16* __restrict__ dout,
                    __nv_bfloat16* __restrict__ dq,
                    float* __restrict__ delta, int Hg, int T, int S,
                    float scale, int causal, int window, float softcap) {
  using L = DqSmem<DK, DV>;
  constexpr int DQ_NW = DqCfg<DK, DV>::NW;
  constexpr int DQ_NT = DqCfg<DK, DV>::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n_kv = (S + TILE - 1) / TILE;
  const int words = (n_kv + 31) / 32;
  uint32_t* live = reinterpret_cast<uint32_t*>(smem_raw + L::MASK);
  const uint32_t* full = live + words;
  float* sDelta = reinterpret_cast<float*>(smem_raw + L::ROWS);
  float* sLse = sDelta + DQ_NW * TILE;
  int* sQseg = reinterpret_cast<int*>(sLse + DQ_NW * TILE);
  int* sQpos = sQseg + TILE;
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sStage = base + DQ_NW * L::HEAD;

  // (q tile, head block, g) of this block: blocks start in the order of
  // their linear index, so with the grid (G, head blocks, q tiles) the last
  // q tiles go first
  const int g = blockIdx.x, hb = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * TILE;
  const int wg = threadIdx.x >> 7;        // this warpgroup's head
  const int h = hb * DQ_NW + wg;
  const bool active = h < Hg;             // warpgroup-uniform
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t sQ = base + wg * L::HEAD;
  const uint32_t sdO = sQ + L::Q;
  const size_t head = (size_t)g * Hg + (active ? h : 0);
  const __nv_bfloat16* kg = k + (size_t)g * S * DK;
  const __nv_bfloat16* vg = v + (size_t)g * S * DV;

  // the KV tiles any query of this q tile can see (the same for every
  // head), and those all its queries see whole
  const TileMeta mine = warp_tile_meta(q_seg, q_pos, T, qt, lane);
  build_live_masks<DQ_NT, 1>(live, words, n_kv, k_seg, k_pos, S, &mine,
                             true, causal, window);

  // K and V are copied by the first NLOAD threads, which split every tile
  // evenly, from a thread index read at each copy: the copy's addresses
  // hold no registers across the products
  constexpr int NLOAD = DQ_NT < 256 ? DQ_NT : 256;
  auto issue = [&](int kt, int stage) {
    const uint32_t st = sStage + stage * L::STAGE;
    const int tid = tid_here();
    if (tid < NLOAD) {
      load_tile_async<DK, NLOAD>(st, kg, kt * TILE, S, tid);
      load_tile_async<DV, NLOAD>(st + L::K, vg, kt * TILE, S, tid);
    }
    load_vec_async(st + L::K + L::V, k_seg, kt * TILE, S);
    load_vec_async(st + L::K + L::V + TILE * 4, k_pos, kt * TILE, S);
  };

  // the ring: kts[0] is this step's tile, kts[1 ..] the tiles in flight
  int kts[DQ_NSTAGE - 1];
  kts[0] = next_live(live, 0, n_kv);
  if (kts[0] < n_kv) {                    // Q, dO and the first tile
#pragma unroll
    for (int w = 0; w < DQ_NW; ++w) {
      const int hw = hb * DQ_NW + w;
      if (hw < Hg) {
        const size_t hd = (size_t)g * Hg + hw;
        load_tile_async<DK, DQ_NT>(base + w * L::HEAD, q + hd * T * DK, q0,
                                   T);
        load_tile_async<DV, DQ_NT>(base + w * L::HEAD + L::Q,
                                dout + hd * T * DV, q0, T);
      }
    }
    issue(kts[0], 0);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 1; j < DQ_NSTAGE - 1; ++j) {
    kts[j] = next_live(live, kts[j - 1] + 1, n_kv);
    if (kts[j] < n_kv) issue(kts[j], j);
    cp_async_commit();
  }

  // per q row, into shared memory while the loads are in flight: delta =
  // rowsum(do * out) in fp32 (two threads per row), lse, q_seg and q_pos
  const int r = (threadIdx.x & 127) >> 1, half = threadIdx.x & 1;
  const bool row_in = q0 + r < T;
  if (active) {
    float d = 0.f;
    if (row_in) {
      const size_t row = (head * T + q0 + r) * DV;
#pragma unroll
      for (int c = half * (DV / 2); c < (half + 1) * (DV / 2); c += 8) {
        const uint4 ro = *reinterpret_cast<const uint4*>(out + row + c);
        const uint4 rd = *reinterpret_cast<const uint4*>(dout + row + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ro);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&rd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          d += of.x * df.x;
          d += of.y * df.y;
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sDelta[wg * TILE + r] = d;
      sLse[wg * TILE + r] = row_in ? lse[head * T + q0 + r] : 0.f;
      if (row_in) delta[head * T + q0 + r] = d;
    }
  }
  if (wg == 0 && half == 0) {
    sQseg[r] = row_in ? q_seg[q0 + r] : 0;
    sQpos[r] = row_in ? q_pos[q0 + r] : 0;
  }
  __syncthreads();

  // this thread's two q rows within the tile (their metadata is read from
  // shared memory per tile, which keeps it out of the registers the
  // products hold)
  const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;
  const int t_lo = q0 + r_lo, t_hi = q0 + r_hi;
  const bool in_lo = active && t_lo < T, in_hi = active && t_hi < T;
  const float* sLseW = sLse + wg * TILE;
  const float* sDeltaW = sDelta + wg * TILE;

  // dq / scale for this warp's 16 q rows (wgmma accumulator layout)
  float acc[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;

  int stage = 0;
  while (kts[0] < n_kv) {
    const int kt = kts[0];
    cp_async_wait<DQ_NSTAGE - 2>();       // tile kt (and Q, dO) landed
    fence_async_smem();
    __syncthreads();                      // ... for every thread; and every
                                          // thread is done with tile kt - 1
    const int nxt = next_live(live, kts[DQ_NSTAGE - 2] + 1, n_kv);
    if (nxt < n_kv) issue(nxt, (stage + DQ_NSTAGE - 1) % DQ_NSTAGE);
    cp_async_commit();

    if (active) {                         // warpgroup-uniform
      const uint32_t sK = sStage + stage * L::STAGE;
      const uint32_t sV = sK + L::K;
      const int* sKseg = reinterpret_cast<const int*>(
          smem_raw + DQ_NW * L::HEAD + stage * L::STAGE + L::K + L::V);
      const int* sKpos = sKseg + TILE;

      // s = Q K^T and dp = dO V^T: this warp's 16 q rows x 64 kv columns
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss_n64(s, desc_k<DK>(sQ, kk), desc_k<DK>(sK, kk), 1);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<DV>(sdO, kk), desc_k<DV>(sV, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // ds into s (no element-wise mask on a full tile)
      const bool whole = bit(full, kt);
      const int qseg_lo = sQseg[r_lo], qseg_hi = sQseg[r_hi];
      const int qpos_lo = sQpos[r_lo], qpos_hi = sQpos[r_hi];
      const float lse_lo = sLseW[r_lo], lse_hi = sLseW[r_hi];
      const float dl_lo = sDeltaW[r_lo], dl_hi = sDeltaW[r_hi];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
        const bool hi = (i & 2) != 0;
        const bool ok = whole || visible(hi ? qseg_hi : qseg_lo,
                                         hi ? qpos_hi : qpos_lo, sKseg[col],
                                         sKpos[col], causal, window);
        float p, ds;
        pair_grad(s[i], dp[i], ok, hi ? lse_hi : lse_lo, hi ? dl_hi : dl_lo,
                  scale, softcap, p, ds);
        s[i] = ds;
      }
      uint32_t sh[4][4], sl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a_split(sh[kk], sl[kk], s, kk);

      // dq += dS K: hi and lo fragments, K MN-major
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DK>(acc, sh[kk], desc_mn<DK>(sK, kk), 1);
        wgmma_rs<DK>(acc, sl[kk], desc_mn<DK>(sK, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
    }
#pragma unroll
    for (int j = 0; j < DQ_NSTAGE - 2; ++j) kts[j] = kts[j + 1];
    kts[DQ_NSTAGE - 2] = nxt;
    stage = (stage + 1) % DQ_NSTAGE;
  }

  // epilogue: every row < T, scaled; a tile no key is visible to writes
  // zeros (the wrapper's dq is uninitialised)
  __nv_bfloat16* dq_h = dq + head * T * DK;
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt) {
    const int c = nt * 8 + 2 * tig;
    if (in_lo)
      *reinterpret_cast<uint32_t*>(dq_h + (size_t)t_lo * DK + c) =
          pack_f2(acc[4 * nt] * scale, acc[4 * nt + 1] * scale);
    if (in_hi)
      *reinterpret_cast<uint32_t*>(dq_h + (size_t)t_hi * DK + c) =
          pack_f2(acc[4 * nt + 2] * scale, acc[4 * nt + 3] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

constexpr int DKV_NSTAGE = 2;             // q-tile ring depth

// one warpgroup a block (two blocks an SM) holding dk and dv, or at Dk = Dv
// = 256 two (one block an SM), warpgroup 0 holding dv and warpgroup 1 dk
template <int DK, int DV>
struct DkvCfg {
  static constexpr bool SPLIT = DK + DV > 256;
  static constexpr int NT = SPLIT ? 256 : 128;
  static constexpr int MIN_BLOCKS = SPLIT ? 1 : 2;
  static_assert(!SPLIT || DK == DV, "the split holds dk and dv alike");
};

// shared memory of the dkv kernel: the K and V tiles, DKV_NSTAGE x (Q tile,
// dO tile, q_seg, q_pos, lse, delta), then the live-tile and full-tile
// bitmasks
template <int DK, int DV>
struct DkvSmem {
  static constexpr int K = flash::TILE * DK * 2;
  static constexpr int V = flash::TILE * DV * 2;
  static constexpr int Q = flash::TILE * DK * 2;
  static constexpr int DO = flash::TILE * DV * 2;
  static constexpr int STAGE = Q + DO + 4 * flash::TILE * 4;
  static constexpr int MASK = K + V + DKV_NSTAGE * STAGE;
  static size_t bytes(int n_tiles) {
    return MASK + (size_t)((n_tiles + 31) / 32) * 8;
  }
};

template <int DK, int DV>
__global__ void __launch_bounds__(DkvCfg<DK, DV>::NT,
                                  DkvCfg<DK, DV>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ k_seg,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos,
                     const float* __restrict__ delta,
                     const float* __restrict__ lse,
                     const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Hg, int T, int S,
                     float scale, int causal, int window, float softcap) {
  using namespace flash;
  using L = DkvSmem<DK, DV>;
  using C = DkvCfg<DK, DV>;
  constexpr int NTHREADS = C::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n_q = (T + TILE - 1) / TILE;
  const int words = (n_q + 31) / 32;
  uint32_t* live = reinterpret_cast<uint32_t*>(smem_raw + L::MASK);
  uint32_t* full = live + words;
  const uint32_t sK = smem_u32(smem_raw);
  const uint32_t sV = sK + L::K;
  const uint32_t sStage = sV + L::V;

  const int g = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // which accumulators this warpgroup holds (both, unless SPLIT)
  const bool do_v = !C::SPLIT || threadIdx.x < 128;
  const bool do_k = !C::SPLIT || threadIdx.x >= 128;

  // the q tiles whose queries can see any key of this KV tile (the same for
  // every head of the group), and those that see it whole
  const TileMeta mine = warp_tile_meta(k_seg, k_pos, S, blockIdx.x, lane);
  build_live_masks<NTHREADS, 1>(live, words, n_q, q_seg, q_pos, T, &mine,
                                false, causal, window);

  // this thread's two kv rows within the tile, and their metadata
  const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;
  const int j_lo = k0 + r_lo, j_hi = k0 + r_hi;
  const int kseg_lo = j_lo < S ? k_seg[j_lo] : 0;
  const int kseg_hi = j_hi < S ? k_seg[j_hi] : 0;
  const int kpos_lo = j_lo < S ? k_pos[j_lo] : 0;
  const int kpos_hi = j_hi < S ? k_pos[j_hi] : 0;

  // dk / scale and dv for this warp's 16 kv rows (wgmma accumulator
  // layout); SPLIT keeps one of them in acc_v, dv in warpgroup 0 and dk /
  // scale in warpgroup 1
  float acc_k[C::SPLIT ? 1 : DK / 2], acc_v[DV / 2];
#pragma unroll
  for (int i = 0; i < (C::SPLIT ? 1 : DK / 2); ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc_v[i] = 0.f;

  // steps: (h, qt) over the heads and, within each, the live q tiles
  auto issue = [&](int h, int qt, int stage) {
    const size_t head = (size_t)g * Hg + h;
    const int q0 = qt * TILE;
    const uint32_t st = sStage + stage * L::STAGE;
    load_tile_async<DK, NTHREADS>(st, q + head * T * DK, q0, T);
    load_tile_async<DV, NTHREADS>(st + L::Q, dout + head * T * DV, q0, T);
    const uint32_t sv = st + L::Q + L::DO;
    load_vec_async(sv, q_seg, q0, T);
    load_vec_async(sv + TILE * 4, q_pos, q0, T);
    load_vec_async(sv + 2 * TILE * 4, lse + head * T, q0, T);
    load_vec_async(sv + 3 * TILE * 4, delta + head * T, q0, T);
  };

  const int first = next_live(live, 0, n_q);
  int h = 0, qt = first;
  if (first < n_q) {                      // K, V and the first step
    load_tile_async<DK, NTHREADS>(sK, k + (size_t)g * S * DK, k0, S);
    load_tile_async<DV, NTHREADS>(sV, v + (size_t)g * S * DV, k0, S);
    issue(h, qt, 0);
  } else {
    h = Hg;                               // no q row sees this tile
  }
  cp_async_commit();
  int stage = 0;
  while (h < Hg) {
    int nh = h, nqt = next_live(live, qt + 1, n_q);
    if (nqt == n_q) { ++nh; nqt = first; }
    if (nh < Hg) issue(nh, nqt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                   // this step (and K, V) landed
    fence_async_smem();
    __syncthreads();

    const uint32_t sQ = sStage + stage * L::STAGE;
    const uint32_t sdO = sQ + L::Q;
    const unsigned char* sv =
        smem_raw + L::K + L::V + stage * L::STAGE + L::Q + L::DO;
    const int* sQseg = reinterpret_cast<const int*>(sv);
    const int* sQpos = sQseg + TILE;
    const float* sLse = reinterpret_cast<const float*>(sQpos + TILE);
    const float* sDelta = sLse + TILE;

    // s^T = K Q^T and dp^T = V dO^T: this warp's 16 kv rows x 64 q columns
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(st, desc_k<DK>(sK, kk), desc_k<DK>(sQ, kk), 1);
    if (do_k) {                           // warpgroup-uniform
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss_n64(dpt, desc_k<DV>(sV, kk), desc_k<DV>(sdO, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(dpt);

    // p^T into st, ds^T into dpt (no element-wise mask on a full tile)
    const bool whole = bit(full, qt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
      const bool hi = (i & 2) != 0;
      const bool ok = whole || visible(sQseg[col], sQpos[col],
                                       hi ? kseg_hi : kseg_lo,
                                       hi ? kpos_hi : kpos_lo, causal, window);
      float p, ds;
      pair_grad(st[i], dpt[i], ok, sLse[col], sDelta[col], scale, softcap, p,
                ds);
      st[i] = p;
      dpt[i] = ds;
    }
    if constexpr (C::SPLIT) {
      // dv += P^T dO (warpgroup 0) or dk += dS^T Q (warpgroup 1) into
      // acc_v: hi and lo fragments, dO or Q MN-major
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = do_v ? st[i] : dpt[i];
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a_split(ah[kk], al[kk], st, kk);
      const uint32_t sB = do_v ? sdO : sQ;
      reg_fence(acc_v);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DV>(acc_v, ah[kk], desc_mn<DV>(sB, kk), 1);
        wgmma_rs<DV>(acc_v, al[kk], desc_mn<DV>(sB, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc_v);
    } else {
      uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a_split(ph[kk], pl[kk], st, kk);
        acc_to_a_split(sh[kk], sl[kk], dpt, kk);
      }

      // dv += P^T dO, dk += dS^T Q: hi and lo fragments, dO and Q MN-major
      reg_fence(acc_v);
      reg_fence(acc_k);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DV>(acc_v, ph[kk], desc_mn<DV>(sdO, kk), 1);
        wgmma_rs<DV>(acc_v, pl[kk], desc_mn<DV>(sdO, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DK>(acc_k, sh[kk], desc_mn<DK>(sQ, kk), 1);
        wgmma_rs<DK>(acc_k, sl[kk], desc_mn<DK>(sQ, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc_v);
      reg_fence(acc_k);
    }
    __syncthreads();                      // this stage may be refilled
    h = nh;
    qt = nqt;
    stage ^= 1;
  }

  // epilogue: rows < S, dk scaled; a tile no q row sees writes zeros
  __nv_bfloat16* dk_g = dk + (size_t)g * S * DK;
  __nv_bfloat16* dv_g = dv + (size_t)g * S * DV;
  const bool in_lo = j_lo < S, in_hi = j_hi < S;
  if constexpr (C::SPLIT) {
    __nv_bfloat16* dst = do_v ? dv_g : dk_g;
    const float f = do_v ? 1.f : scale;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo)
        *reinterpret_cast<uint32_t*>(dst + (size_t)j_lo * DV + c) =
            pack_f2(acc_v[4 * nt] * f, acc_v[4 * nt + 1] * f);
      if (in_hi)
        *reinterpret_cast<uint32_t*>(dst + (size_t)j_hi * DV + c) =
            pack_f2(acc_v[4 * nt + 2] * f, acc_v[4 * nt + 3] * f);
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo)
        *reinterpret_cast<uint32_t*>(dk_g + (size_t)j_lo * DK + c) =
            pack_f2(acc_k[4 * nt] * scale, acc_k[4 * nt + 1] * scale);
      if (in_hi)
        *reinterpret_cast<uint32_t*>(dk_g + (size_t)j_hi * DK + c) =
            pack_f2(acc_k[4 * nt + 2] * scale, acc_k[4 * nt + 3] * scale);
    }
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo)
        *reinterpret_cast<uint32_t*>(dv_g + (size_t)j_lo * DV + c) =
            pack_f2(acc_v[4 * nt], acc_v[4 * nt + 1]);
      if (in_hi)
        *reinterpret_cast<uint32_t*>(dv_g + (size_t)j_hi * DV + c) =
            pack_f2(acc_v[4 * nt + 2], acc_v[4 * nt + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// (Dk, Dv) = (576, 512): DeepSeek-V2's absorbed MLA
// ---------------------------------------------------------------------------
//
// The templates above do not hold this shape.  A 64-row tile of dq is 64 x
// 576 fp32 (288 registers a thread in one warpgroup), dk and dv of a KV
// tile 64 x 1088 (544), and the four tiles one step reads (Q 72 KB, K
// 72 KB, dO 64 KB, V 64 KB) take 272 KB, more than a block's 227 KB.  So:
//  * Every block is one warpgroup holding one column range of one output
//    tile (at most 192 columns, 96 fp32 a thread): dq in three blocks of
//    192 columns per (g, h, q tile); dv in blocks of 192, 192 and 128
//    columns and dk in three of 192 per (g, KV tile).  Each block computes
//    the score tiles its columns need (S and dP for dq and dk, S alone for
//    dv) itself, so every block of one tile repeats them: the tensor-core
//    work is ~3.3x the bound's, the price of holding no output in shared
//    memory and exchanging nothing between blocks.
//  * One operand buffer of 72 KB takes the two tiles of a step in turn,
//    beside the two tiles that stay for the whole block (Q and dO for dq;
//    K and V for dk and dv): dq loads V_t (dP = dO V^T), then K_t (S = Q
//    K^T, then dq += dS K[:, cols]); a dk block loads dO (dP^T = V dO^T),
//    then Q (S^T = K Q^T, then dk += dS^T Q[:, cols]); a dv block loads Q
//    (S^T), then dO (dv += P^T dO[:, cols]).  The loads do not overlap the
//    products (214 KB of shared memory, one block an SM).
//  * The arithmetic per pair is the templates': p and ds in fp32, each
//    entering its product as bf16 hi + lo fragments; a column range [c0,
//    c0 + N) of a tile is the MN-major B operand with its start address
//    moved by 16 c0 bytes.
constexpr int MLA_DK = 576, MLA_DV = 512;
constexpr int MLA_COLS = 192;             // output columns a block
constexpr int MLA_DQ_CB = MLA_DK / MLA_COLS;   // dq column blocks: 3
constexpr int MLA_DKV_CB = 6;             // dv: 192, 192, 128; dk: 3 x 192
constexpr int MLA_BUF = TILE * MLA_DK * 2;     // the operand buffer

// shared memory of the dq kernel: Q, dO, the operand buffer, the KV tile's
// k_seg and k_pos, per q row delta, lse, q_seg and q_pos, then the
// live-tile and full-tile bitmasks
struct MlaDqSmem {
  static constexpr int Q = TILE * MLA_DK * 2;
  static constexpr int DO = TILE * MLA_DV * 2;
  static constexpr int BUF = Q + DO;
  static constexpr int KMETA = BUF + MLA_BUF;
  static constexpr int ROWS = KMETA + 2 * TILE * 4;
  static constexpr int MASK = ROWS + 4 * TILE * 4;
  static size_t bytes(int n_tiles) {
    return MASK + (size_t)((n_tiles + 31) / 32) * 8;
  }
};

__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_mla_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ k_seg,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos,
                        const __nv_bfloat16* __restrict__ out,
                        const float* __restrict__ lse,
                        const __nv_bfloat16* __restrict__ dout,
                        __nv_bfloat16* __restrict__ dq,
                        float* __restrict__ delta, int Hg, int T, int S,
                        float scale, int causal, int window, float softcap) {
  using L = MlaDqSmem;
  constexpr int DK = MLA_DK, DV = MLA_DV, NC = MLA_COLS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n_kv = (S + TILE - 1) / TILE;
  const int words = (n_kv + 31) / 32;
  uint32_t* live = reinterpret_cast<uint32_t*>(smem_raw + L::MASK);
  const uint32_t* full = live + words;
  const int* sKseg = reinterpret_cast<const int*>(smem_raw + L::KMETA);
  const int* sKpos = sKseg + TILE;
  float* sDelta = reinterpret_cast<float*>(smem_raw + L::ROWS);
  float* sLse = sDelta + TILE;
  int* sQseg = reinterpret_cast<int*>(sLse + TILE);
  int* sQpos = sQseg + TILE;
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQ = base, sdO = base + L::Q, sB = base + L::BUF;

  // (g, head and column block, q tile): the last q tiles start first
  const int g = blockIdx.x;
  const int h = blockIdx.y / MLA_DQ_CB, c0 = (blockIdx.y % MLA_DQ_CB) * NC;
  const int qt = gridDim.z - 1 - blockIdx.z, q0 = qt * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t head = (size_t)g * Hg + h;
  const __nv_bfloat16* kg = k + (size_t)g * S * DK;
  const __nv_bfloat16* vg = v + (size_t)g * S * DV;

  const TileMeta mine = warp_tile_meta(q_seg, q_pos, T, qt, lane);
  build_live_masks<128, 1>(live, words, n_kv, k_seg, k_pos, S, &mine, true,
                           causal, window);

  int kt = next_live(live, 0, n_kv);
  if (kt < n_kv) {
    load_tile_async<DK, 128>(sQ, q + head * T * DK, q0, T);
    load_tile_async<DV, 128>(sdO, dout + head * T * DV, q0, T);
  }
  cp_async_commit();

  // per q row, while Q and dO load: delta = rowsum(do * out) in fp32 (two
  // threads a row; the first column block writes it out), lse, q_seg, q_pos
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const bool row_in = q0 + r < T;
  float d = 0.f;
  if (row_in) {
    const size_t row = (head * T + q0 + r) * DV;
#pragma unroll 4
    for (int c = half * (DV / 2); c < (half + 1) * (DV / 2); c += 8) {
      const uint4 ro = *reinterpret_cast<const uint4*>(out + row + c);
      const uint4 rd = *reinterpret_cast<const uint4*>(dout + row + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ro);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&rd);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 df = __bfloat1622float2(d2[e]);
        d += of.x * df.x;
        d += of.y * df.y;
      }
    }
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  if (half == 0) {
    sDelta[r] = d;
    sLse[r] = row_in ? lse[head * T + q0 + r] : 0.f;
    sQseg[r] = row_in ? q_seg[q0 + r] : 0;
    sQpos[r] = row_in ? q_pos[q0 + r] : 0;
    if (row_in && c0 == 0) delta[head * T + q0 + r] = d;
  }
  __syncthreads();

  const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;
  const int t_lo = q0 + r_lo, t_hi = q0 + r_hi;

  // dq / scale, columns [c0, c0 + 192), for this warp's 16 q rows
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;

  while (kt < n_kv) {
    // V_kt and the tile's k_seg / k_pos: dp = dO V^T
    load_tile_async<DV, 128>(sB, vg, kt * TILE, S);
    load_vec_async(base + L::KMETA, k_seg, kt * TILE, S);
    load_vec_async(base + L::KMETA + TILE * 4, k_pos, kt * TILE, S);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<DV>(sdO, kk), desc_k<DV>(sB, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dp);
    __syncthreads();                      // every warp is done with V_kt

    // K_kt: s = Q K^T
    load_tile_async<DK, 128>(sB, kg, kt * TILE, S);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(s, desc_k<DK>(sQ, kk), desc_k<DK>(sB, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // ds into s (no element-wise mask on a full tile)
    const bool whole = bit(full, kt);
    const int qseg_lo = sQseg[r_lo], qseg_hi = sQseg[r_hi];
    const int qpos_lo = sQpos[r_lo], qpos_hi = sQpos[r_hi];
    const float lse_lo = sLse[r_lo], lse_hi = sLse[r_hi];
    const float dl_lo = sDelta[r_lo], dl_hi = sDelta[r_hi];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
      const bool hi = (i & 2) != 0;
      const bool ok = whole || visible(hi ? qseg_hi : qseg_lo,
                                       hi ? qpos_hi : qpos_lo, sKseg[col],
                                       sKpos[col], causal, window);
      float p, ds;
      pair_grad(s[i], dp[i], ok, hi ? lse_hi : lse_lo, hi ? dl_hi : dl_lo,
                scale, softcap, p, ds);
      s[i] = ds;
    }
    uint32_t sh[4][4], sl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a_split(sh[kk], sl[kk], s, kk);

    // dq[:, c0 : c0 + 192] += dS K[:, c0 : c0 + 192]: hi and lo fragments
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<NC>(acc, sh[kk], desc_mn<DK>(sB + c0 * 16, kk), 1);
      wgmma_rs<NC>(acc, sl[kk], desc_mn<DK>(sB + c0 * 16, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    __syncthreads();                      // every warp is done with K_kt
    kt = next_live(live, kt + 1, n_kv);
  }

  // epilogue: every row < T, scaled; a tile no key is visible to writes
  // zeros (the wrapper's dq is uninitialised)
  __nv_bfloat16* dq_h = dq + head * T * DK + c0;
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) {
    const int c = nt * 8 + 2 * tig;
    if (t_lo < T)
      *reinterpret_cast<uint32_t*>(dq_h + (size_t)t_lo * DK + c) =
          pack_f2(acc[4 * nt] * scale, acc[4 * nt + 1] * scale);
    if (t_hi < T)
      *reinterpret_cast<uint32_t*>(dq_h + (size_t)t_hi * DK + c) =
          pack_f2(acc[4 * nt + 2] * scale, acc[4 * nt + 3] * scale);
  }
}

// shared memory of the dkv kernel: K, V, the operand buffer, the q tile's
// q_seg, q_pos, lse and delta, then the live-tile and full-tile bitmasks
struct MlaDkvSmem {
  static constexpr int K = TILE * MLA_DK * 2;
  static constexpr int V = TILE * MLA_DV * 2;
  static constexpr int BUF = K + V;
  static constexpr int VEC = BUF + MLA_BUF;
  static constexpr int MASK = VEC + 4 * TILE * 4;
  static size_t bytes(int n_tiles) {
    return MASK + (size_t)((n_tiles + 31) / 32) * 8;
  }
};

__global__ void __launch_bounds__(128, 1)
flash_bwd_dkv_mla_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ q_seg,
                         const int* __restrict__ k_seg,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ k_pos,
                         const float* __restrict__ delta,
                         const float* __restrict__ lse,
                         const __nv_bfloat16* __restrict__ dout,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Hg, int T, int S,
                         float scale, int causal, int window, float softcap) {
  using L = MlaDkvSmem;
  constexpr int DK = MLA_DK, DV = MLA_DV, NC = MLA_COLS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n_q = (T + TILE - 1) / TILE;
  const int words = (n_q + 31) / 32;
  uint32_t* live = reinterpret_cast<uint32_t*>(smem_raw + L::MASK);
  const uint32_t* full = live + words;
  const int* sQseg = reinterpret_cast<const int*>(smem_raw + L::VEC);
  const int* sQpos = sQseg + TILE;
  const float* sLse = reinterpret_cast<const float*>(sQpos + TILE);
  const float* sDelta = sLse + TILE;
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = base, sV = base + L::K, sB = base + L::BUF;

  // (KV tile, g, column block): blocks 0-2 hold dv columns [0, 192),
  // [192, 384), [384, 512); blocks 3-5 dk columns [0, 192), [192, 384),
  // [384, 576)
  const int g = blockIdx.y, k0 = blockIdx.x * TILE;
  const bool is_v = blockIdx.z < 3;       // block-uniform
  const int c0 = (blockIdx.z % 3) * NC;
  const bool narrow = is_v && c0 + NC > DV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // the q tiles whose queries can see any key of this KV tile, and those
  // that see it whole
  const TileMeta mine = warp_tile_meta(k_seg, k_pos, S, blockIdx.x, lane);
  build_live_masks<128, 1>(live, words, n_q, q_seg, q_pos, T, &mine, false,
                           causal, window);

  const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;
  const int j_lo = k0 + r_lo, j_hi = k0 + r_hi;
  const int kseg_lo = j_lo < S ? k_seg[j_lo] : 0;
  const int kseg_hi = j_hi < S ? k_seg[j_hi] : 0;
  const int kpos_lo = j_lo < S ? k_pos[j_lo] : 0;
  const int kpos_hi = j_hi < S ? k_pos[j_hi] : 0;

  // dv, or dk / scale, columns [c0, c0 + 192) (128 on the narrow block)
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;

  const int first = next_live(live, 0, n_q);
  if (first < n_q) {
    load_tile_async<DK, 128>(sK, k + (size_t)g * S * DK, k0, S);
    if (!is_v) load_tile_async<DV, 128>(sV, v + (size_t)g * S * DV, k0, S);
  }
  cp_async_commit();                      // waited with the first step's
  for (int h = 0; first < n_q && h < Hg; ++h) {
    const size_t head = (size_t)g * Hg + h;
    const __nv_bfloat16* qh = q + head * T * DK;
    const __nv_bfloat16* doh = dout + head * T * DV;
    for (int qt = first; qt < n_q; qt = next_live(live, qt + 1, n_q)) {
      const int q0 = qt * TILE;
      // the first tile of the step (Q for dv, dO for dk) and the rows' data
      if (is_v) load_tile_async<DK, 128>(sB, qh, q0, T);
      else load_tile_async<DV, 128>(sB, doh, q0, T);
      load_vec_async(base + L::VEC, q_seg, q0, T);
      load_vec_async(base + L::VEC + TILE * 4, q_pos, q0, T);
      load_vec_async(base + L::VEC + 2 * TILE * 4, lse + head * T, q0, T);
      load_vec_async(base + L::VEC + 3 * TILE * 4, delta + head * T, q0, T);
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();
      // s^T = K Q^T (dv) or dp^T = V dO^T (dk): 16 kv rows x 64 q columns
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
      if (is_v) {
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          wgmma_ss_n64(st, desc_k<DK>(sK, kk), desc_k<DK>(sB, kk), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          wgmma_ss_n64(dpt, desc_k<DV>(sV, kk), desc_k<DV>(sB, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);
      __syncthreads();                    // every warp is done with it

      // the second tile (dO for dv, Q for dk)
      if (is_v) load_tile_async<DV, 128>(sB, doh, q0, T);
      else load_tile_async<DK, 128>(sB, qh, q0, T);
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();
      if (!is_v) {                        // s^T = K Q^T
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          wgmma_ss_n64(st, desc_k<DK>(sK, kk), desc_k<DK>(sB, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(st);
      }

      // p^T (dv) or ds^T (dk) into st (no element-wise mask on a full tile)
      const bool whole = bit(full, qt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
        const bool hi = (i & 2) != 0;
        const bool ok = whole || visible(sQseg[col], sQpos[col],
                                         hi ? kseg_hi : kseg_lo,
                                         hi ? kpos_hi : kpos_lo, causal,
                                         window);
        float p, ds;
        pair_grad(st[i], dpt[i], ok, sLse[col], sDelta[col], scale, softcap,
                  p, ds);
        st[i] = is_v ? p : ds;
      }
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a_split(ah[kk], al[kk], st, kk);

      // acc += P^T dO[:, cols] or dS^T Q[:, cols]: hi and lo fragments
      reg_fence(acc);
      wgmma_fence();
      if (narrow) {
        float(&acc128)[64] = *reinterpret_cast<float(*)[64]>(&acc[0]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<128>(acc128, ah[kk], desc_mn<DV>(sB + c0 * 16, kk), 1);
          wgmma_rs<128>(acc128, al[kk], desc_mn<DV>(sB + c0 * 16, kk), 1);
        }
      } else if (is_v) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<NC>(acc, ah[kk], desc_mn<DV>(sB + c0 * 16, kk), 1);
          wgmma_rs<NC>(acc, al[kk], desc_mn<DV>(sB + c0 * 16, kk), 1);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<NC>(acc, ah[kk], desc_mn<DK>(sB + c0 * 16, kk), 1);
          wgmma_rs<NC>(acc, al[kk], desc_mn<DK>(sB + c0 * 16, kk), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      __syncthreads();                    // the buffer may be refilled
    }
  }

  // epilogue: rows < S, dk scaled; a tile no q row sees writes zeros
  const int width = is_v ? DV : DK;
  __nv_bfloat16* dst = (is_v ? dv : dk) + (size_t)g * S * width + c0;
  const float f = is_v ? 1.f : scale;
  const int ncols = narrow ? DV - c0 : NC;
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) {
    const int c = nt * 8 + 2 * tig;
    if (nt * 8 >= ncols) break;
    if (j_lo < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)j_lo * width + c) =
          pack_f2(acc[4 * nt] * f, acc[4 * nt + 1] * f);
    if (j_hi < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)j_hi * width + c) =
          pack_f2(acc[4 * nt + 2] * f, acc[4 * nt + 3] * f);
  }
}

struct Args {
  const void *q, *k, *v, *q_seg, *k_seg, *q_pos, *k_pos, *out, *lse, *dout;
  void* delta;                            // written by dq, read by dkv
  void *d0, *d1;                          // dq | (dk, dv)
  int G, Hg, T, S;
  float scale;
  int causal, window;
  float softcap;
  cudaStream_t stream;
};

#define FLASH_BWD_INPUTS(a)                                                  \
  static_cast<const __nv_bfloat16*>(a.q),                                    \
      static_cast<const __nv_bfloat16*>(a.k),                                \
      static_cast<const __nv_bfloat16*>(a.v),                                \
      static_cast<const int*>(a.q_seg), static_cast<const int*>(a.k_seg),    \
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.k_pos)

template <int DK, int DV>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = DqSmem<DK, DV>::bytes((a.S + TILE - 1) / TILE);
  auto kern = flash_bwd_dq_kernel<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the q tiles go on z, which starts the last ones first: at most 65535
  // (T up to 4M rows), a larger T fails the launch and the wrapper raises
  constexpr int DQ_NW = DqCfg<DK, DV>::NW;
  const int n_q = (a.T + TILE - 1) / TILE;
  const int n_hb = (a.Hg + DQ_NW - 1) / DQ_NW;
  const dim3 grid(a.G, n_hb, n_q);
  kern<<<grid, DqCfg<DK, DV>::NT, smem, a.stream>>>(
      FLASH_BWD_INPUTS(a), static_cast<const __nv_bfloat16*>(a.out),
      static_cast<const float*>(a.lse),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<__nv_bfloat16*>(a.d0), static_cast<float*>(a.delta), a.Hg,
      a.T, a.S, a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem =
      DkvSmem<DK, DV>::bytes((a.T + flash::TILE - 1) / flash::TILE);
  auto kern = flash_bwd_dkv_kernel<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + flash::TILE - 1) / flash::TILE, a.G);
  kern<<<grid, DkvCfg<DK, DV>::NT, smem, a.stream>>>(
      FLASH_BWD_INPUTS(a), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.lse),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<__nv_bfloat16*>(a.d0), static_cast<__nv_bfloat16*>(a.d1),
      a.Hg, a.T, a.S, a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

cudaError_t launch_mla(int which, const Args& a) {
  const bool dq_k = which == 0;
  const size_t smem = dq_k ? MlaDqSmem::bytes((a.S + TILE - 1) / TILE)
                           : MlaDkvSmem::bytes((a.T + TILE - 1) / TILE);
  const void* kern = dq_k ? reinterpret_cast<const void*>(flash_bwd_dq_mla_kernel)
                          : reinterpret_cast<const void*>(flash_bwd_dkv_mla_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (dq_k) {
    const dim3 grid(a.G, a.Hg * MLA_DQ_CB, (a.T + TILE - 1) / TILE);
    flash_bwd_dq_mla_kernel<<<grid, 128, smem, a.stream>>>(
        FLASH_BWD_INPUTS(a), static_cast<const __nv_bfloat16*>(a.out),
        static_cast<const float*>(a.lse),
        static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<__nv_bfloat16*>(a.d0), static_cast<float*>(a.delta),
        a.Hg, a.T, a.S, a.scale, a.causal, a.window, a.softcap);
  } else {
    const dim3 grid((a.S + TILE - 1) / TILE, a.G, MLA_DKV_CB);
    flash_bwd_dkv_mla_kernel<<<grid, 128, smem, a.stream>>>(
        FLASH_BWD_INPUTS(a), static_cast<const float*>(a.delta),
        static_cast<const float*>(a.lse),
        static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<__nv_bfloat16*>(a.d0), static_cast<__nv_bfloat16*>(a.d1),
        a.Hg, a.T, a.S, a.scale, a.causal, a.window, a.softcap);
  }
  return cudaGetLastError();
}

template <int DK>
cudaError_t dispatch_dv(int dv, int which, const Args& a) {
#define FLASH_BWD_DV(DV)                                                     \
  case DV:                                                                   \
    return which == 0 ? launch_dq<DK, DV>(a) : launch_dkv<DK, DV>(a);
  if constexpr (DK == 256) {              // head dim 256: (256, 256) only
    switch (dv) {
      FLASH_BWD_DV(256)
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    switch (dv) {
      FLASH_BWD_DV(32)
      FLASH_BWD_DV(64)
      FLASH_BWD_DV(128)
      default:
        return cudaErrorInvalidValue;
    }
  }
#undef FLASH_BWD_DV
}

cudaError_t dispatch(int dk, int dv, int which, const Args& a) {
  if (a.T == 0 || a.S == 0 || a.G == 0 || a.Hg == 0) return cudaSuccess;
  switch (dk) {
    case 32:
      return dispatch_dv<32>(dv, which, a);
    case 64:
      return dispatch_dv<64>(dv, which, a);
    case 128:
      return dispatch_dv<128>(dv, which, a);
    case 256:
      return dispatch_dv<256>(dv, which, a);
    case MLA_DK:                          // (576, 512) only
      return dv == MLA_DV ? launch_mla(which, a) : cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (ctypes).  q [G,Hg,T,Dk], k [G,S,Dk], v [G,S,Dv],
// out and dout [G,Hg,T,Dv] bf16; lse and delta [G,Hg,T] fp32; seg/pos int32
// [T] and [S]; all contiguous.  Each returns the launch's cudaError_t (0 on
// success).

// dq [G,Hg,T,Dk] bf16, and delta = rowsum(do * out) written for dkv
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* q_seg, const void* k_seg,
                                 const void* q_pos, const void* k_pos,
                                 const void* out, const void* lse,
                                 const void* dout, void* dq, void* delta,
                                 int G, int Hg, int T, int S, int dk, int dv,
                                 float scale, int causal, int window,
                                 float softcap, void* stream) {
  const Args a{q, k, v, q_seg, k_seg, q_pos, k_pos, out, lse, dout, delta,
               dq, nullptr, G, Hg, T, S, scale, causal, window, softcap,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dk, dv, 0, a);
}

// dk [G,S,Dk] and dv [G,S,Dv] bf16 from dq's delta
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* q_seg, const void* k_seg,
                                  const void* q_pos, const void* k_pos,
                                  const void* delta, const void* lse,
                                  const void* dout, void* dk_out,
                                  void* dv_out, int G, int Hg, int T, int S,
                                  int dk, int dv, float scale, int causal,
                                  int window, float softcap, void* stream) {
  const Args a{q, k, v, q_seg, k_seg, q_pos, k_pos, nullptr, lse, dout,
               const_cast<void*>(delta), dk_out, dv_out, G, Hg, T, S, scale,
               causal, window, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch(dk, dv, 1, a);
}
