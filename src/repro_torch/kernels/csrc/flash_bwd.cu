// Packed-segment flash attention backward for Hopper (sm_90a), bf16 in,
// fp32 math.  Two deterministic kernels, no atomics, launched in this order
// on one stream:
//
//   flash_bwd_dq_kernel   replaces repro/kernels/flash_attention.py::
//                         _bwd_dq_kernel (inside flash_attention_bwd): one
//                         block per (g, h, 64-row q tile) loops over every KV
//                         tile and keeps dq in registers;
//                         dq = scale * sum_k ds * k.  It also writes
//                         delta = rowsum(do * out) [G, Hg, T] fp32, once per
//                         q row, for the dkv kernel.
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
// tile and loops over the reduction itself.
//  * dq: 4 warps x 16 q rows on mma.sync m16n8k16, dq [16 x Dk] per warp in
//    registers (64 floats a thread at Dk = 128); every KV tile is visited.
//  * dkv: one warpgroup (128 threads) owns 64 KV rows.  A prologue reduces
//    its KV tile and every q tile to their seg/pos ranges and keeps a bitmask
//    of the q tiles that `tile_relevant` (flash_tiles.cuh, the reference's
//    _block_relevant per tile) cannot rule out; the (head, q tile) steps of
//    dead tiles are skipped, which adds exact zeros, and tiles `tile_full`
//    proves visible whole skip the element-wise mask.  K and V load once, as
//    wgmma A operands in shared memory.  Q, dO, q_seg, q_pos, lse and delta
//    of the next live step come in through a two-stage cp.async ring while
//    the tensor cores work on this one.  Per step: S^T = K Q^T and
//    dP^T = V dO^T (m64n64k16, both operands in shared memory); p^T and ds^T
//    in registers; dV += P^T dO and dK += dS^T Q (m64n{Dv,Dk}k16, P^T and
//    dS^T as hi + lo register A fragments, dO and Q read MN-major from the
//    same tiles).  dk and dv stay in registers (128 floats a thread at
//    Dk = Dv = 128) for the whole block; two blocks share an SM.  Two
//    warpgroups sharing each Q/dO tile (128 KV rows a block, a three-stage
//    ring, one block per SM) gave the same bits but ran slower on an H100
//    (PERF.md): the Q/dO loads do not bound this kernel.
// Ragged tails (T % 64, S % 64) load as zeros with segment 0 and are never
// stored.
//
// Bound on this card.  Per unmasked (q, k) pair and head the dq kernel does
// 2*(2*Dk + Dv) flops and the dkv kernel 2*(2*Dk + 2*Dv) (the lo fragments
// of p and ds add tensor-core work the bound does not count); at the training
// slice's shape (G=8, Hg=3, T=S=4096, D=128, segments 3000/900/120) that is
// ~0.09 and ~0.12 ms of bf16 tensor-core time, above the ~0.04 ms their bytes
// take at 3.35 TB/s, so operations bound both.  dq still computes every
// tile, loads synchronously and uses mma.sync; dkv's live tiles hold 3.4x
// the visible pairs at that shape, and its element-wise pass does not yet
// overlap the products of the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); plain C entry
// points, loaded with ctypes, launched on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using flash::pack_f2;

constexpr int BQ = 64;            // q rows per tile (16 per warp in dq)
constexpr int BK = 64;            // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
static_assert(NTHREADS == 2 * BQ, "delta uses two threads per q row");

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 from shared memory -> one register (lo in the low half)
__device__ __forceinline__ uint32_t pack_h2(__nv_bfloat16 lo,
                                            __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + rows) of a [n, D] bf16 matrix into shared memory with
// row stride D + 8; rows >= n are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n, int rows) {
  constexpr int VEC = D / 8;              // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VEC; i += NTHREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// A fragment (16 x 16, rows r_lo / r_lo + 8) of a bf16 tile in shared
// memory with row stride `ld`, k columns [k0, k0 + 16)
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int r_lo, int k0, int tig) {
  const int c = k0 + 2 * tig;
  a[0] = ld32(base + r_lo * ld + c);
  a[1] = ld32(base + (r_lo + 8) * ld + c);
  a[2] = ld32(base + r_lo * ld + c + 8);
  a[3] = ld32(base + (r_lo + 8) * ld + c + 8);
}

// two floats -> bf16 pair hi and the bf16 pair of what hi leaves out
__device__ __forceinline__ void split_f2(float x, float y, uint32_t& hi,
                                         uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_f2(x - hf.x, y - hf.y);
}

// the mma C fragment of 16 x 64 scores, reused as A fragments (k = 16-wide
// slice kk of the 64 columns; the FlashAttention-2 layout identity), split
// into bf16 hi and lo fragments: c ~= hi + lo to ~16 bits
__device__ __forceinline__ void frag_to_a(uint32_t (&hi)[4],
                                          uint32_t (&lo)[4],
                                          const float (&c)[BK / 8][4],
                                          int kk) {
  split_f2(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split_f2(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split_f2(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split_f2(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

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

template <int DK, int DV>
__global__ void __launch_bounds__(NTHREADS)
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
  constexpr int QS = DK + 8;              // shared row strides (elements)
  constexpr int VS = DV + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + BQ * QS;
  __nv_bfloat16* sK = sdO + BQ * VS;
  __nv_bfloat16* sV = sK + BK * QS;
  int* sKseg = reinterpret_cast<int*>(sV + BK * VS);
  int* sKpos = sKseg + BK;
  float* sDelta = reinterpret_cast<float*>(sKpos + BK);

  const int g = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  const size_t head = (size_t)g * Hg + h;
  const __nv_bfloat16* qh = q + head * T * DK;
  const __nv_bfloat16* oh = out + head * T * DV;
  const __nv_bfloat16* doh = dout + head * T * DV;
  const __nv_bfloat16* kg = k + (size_t)g * S * DK;
  const __nv_bfloat16* vg = v + (size_t)g * S * DV;

  load_tile<DK>(sQ, qh, q0, T, BQ);
  load_tile<DV>(sdO, doh, q0, T, BQ);
  __syncthreads();

  // delta = rowsum(do * out) in fp32, two threads per row
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float d = 0.f;
    if (q0 + r < T) {
      const __nv_bfloat16* orow = oh + (size_t)(q0 + r) * DV;
      for (int c = half * (DV / 2); c < (half + 1) * (DV / 2); c += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(orow + c);
        const __nv_bfloat16* ov = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d += __bfloat162float(ov[e]) * __bfloat162float(sdO[r * VS + c + e]);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sDelta[r] = d;
      if (q0 + r < T) delta[head * T + q0 + r] = d;
    }
  }
  __syncthreads();

  // this thread's two q rows within the tile, and their metadata
  const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;
  const int t_lo = q0 + r_lo, t_hi = q0 + r_hi;
  const bool in_lo = t_lo < T, in_hi = t_hi < T;
  const int qseg_lo = in_lo ? q_seg[t_lo] : 0;
  const int qseg_hi = in_hi ? q_seg[t_hi] : 0;
  const int qpos_lo = in_lo ? q_pos[t_lo] : 0;
  const int qpos_hi = in_hi ? q_pos[t_hi] : 0;
  const float lse_lo = in_lo ? lse[head * T + t_lo] : 0.f;
  const float lse_hi = in_hi ? lse[head * T + t_hi] : 0.f;
  const float dl_lo = sDelta[r_lo], dl_hi = sDelta[r_hi];

  float acc[DK / 8][4];                   // dq / scale for rows lo, hi
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kv = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                      // previous tile fully consumed
    load_tile<DK>(sK, kg, k0, S, BK);
    load_tile<DV>(sV, vg, k0, S, BK);
    if (threadIdx.x < BK) {
      const int j = k0 + threadIdx.x;
      sKseg[threadIdx.x] = j < S ? k_seg[j] : 0;
      sKpos[threadIdx.x] = j < S ? k_pos[j] : 0;
    }
    __syncthreads();

    // dp = dO V^T and s = Q K^T for this warp's 16 rows x 64 columns
    float dp[BK / 8][4], s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sdO, VS, warp * 16 + gid, kk * 16, tig);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* vrow = sV + (nt * 8 + gid) * VS + kk * 16 + 2 * tig;
        mma_bf16_16816(dp[nt], a, ld32(vrow), ld32(vrow + 8));
      }
    }
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ, QS, warp * 16 + gid, kk * 16, tig);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* krow = sK + (nt * 8 + gid) * QS + kk * 16 + 2 * tig;
        mma_bf16_16816(s[nt], a, ld32(krow), ld32(krow + 8));
      }
    }

    // ds into s
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        const bool hi = e >= 2;
        const bool ok = visible(hi ? qseg_hi : qseg_lo, hi ? qpos_hi : qpos_lo,
                                sKseg[col], sKpos[col], causal, window);
        float p, ds;
        pair_grad(s[nt][e], dp[nt][e], ok, hi ? lse_hi : lse_lo,
                  hi ? dl_hi : dl_lo, scale, softcap, p, ds);
        s[nt][e] = ds;
      }
    }

    // dq += dS K: dS straight from registers as hi + lo A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ahi[4], alo[4];
      frag_to_a(ahi, alo, s, kk);
      const __nv_bfloat16* k0p = sK + (kk * 16 + 2 * tig) * QS + gid;
#pragma unroll
      for (int nt = 0; nt < DK / 8; ++nt) {
        const __nv_bfloat16* kp = k0p + nt * 8;
        const uint32_t b0 = pack_h2(kp[0], kp[QS]);
        const uint32_t b1 = pack_h2(kp[8 * QS], kp[9 * QS]);
        mma_bf16_16816(acc[nt], ahi, b0, b1);
        mma_bf16_16816(acc[nt], alo, b0, b1);
      }
    }
  }

  __nv_bfloat16* dq_h = dq + head * T * DK;
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt) {
    const int c = nt * 8 + 2 * tig;
    if (in_lo)
      *reinterpret_cast<uint32_t*>(dq_h + (size_t)t_lo * DK + c) =
          pack_f2(acc[nt][0] * scale, acc[nt][1] * scale);
    if (in_hi)
      *reinterpret_cast<uint32_t*>(dq_h + (size_t)t_hi * DK + c) =
          pack_f2(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

constexpr int DKV_NSTAGE = 2;             // q-tile ring depth

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
__global__ void __launch_bounds__(NTHREADS, 2)
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

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

  // dk / scale and dv for this warp's 16 kv rows (wgmma accumulator layout)
  float acc_k[DK / 2], acc_v[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc_k[i] = 0.f;
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
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss_n64(dpt, desc_k<DV>(sV, kk), desc_k<DV>(sdO, kk), 1);
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
    __syncthreads();                      // this stage may be refilled
    h = nh;
    qt = nqt;
    stage ^= 1;
  }

  // epilogue: rows < S, dk scaled; a tile no q row sees writes zeros
  __nv_bfloat16* dk_g = dk + (size_t)g * S * DK;
  __nv_bfloat16* dv_g = dv + (size_t)g * S * DV;
  const bool in_lo = j_lo < S, in_hi = j_hi < S;
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
  const size_t smem =
      (size_t)(BQ * (DK + 8) + BQ * (DV + 8) + BK * (DK + 8) + BK * (DV + 8)) *
          sizeof(__nv_bfloat16) +
      2 * BK * sizeof(int) + BQ * sizeof(float);
  auto kern = flash_bwd_dq_kernel<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + BQ - 1) / BQ, a.Hg, a.G);
  kern<<<grid, NTHREADS, smem, a.stream>>>(
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
  kern<<<grid, NTHREADS, smem, a.stream>>>(
      FLASH_BWD_INPUTS(a), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.lse),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<__nv_bfloat16*>(a.d0), static_cast<__nv_bfloat16*>(a.d1),
      a.Hg, a.T, a.S, a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

template <int DK>
cudaError_t dispatch_dv(int dv, int which, const Args& a) {
#define FLASH_BWD_DV(DV)                                                     \
  case DV:                                                                   \
    return which == 0 ? launch_dq<DK, DV>(a) : launch_dkv<DK, DV>(a);
  switch (dv) {
    FLASH_BWD_DV(32)
    FLASH_BWD_DV(64)
    FLASH_BWD_DV(128)
    default:
      return cudaErrorInvalidValue;
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
