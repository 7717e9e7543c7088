// Packed-segment flash attention forward for Hopper (sm_90a), bf16 in,
// fp32 online softmax.  One templated kernel, two epilogues:
//
//   CARRY = true   replaces repro/kernels/flash_attention.py::_fwd_carry_kernel
//                  (via flash_attention_fwd_carry): reads the carried
//                  unnormalised state (acc, m, l), folds every KV tile into
//                  it and writes it back IN PLACE.  Every prefill layer of the
//                  serving path runs this as ring step 0 from zero stats.
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
// kernel casts it.
//
// Design.  The TPU kernel walks the KV axis as the innermost "arbitrary"
// grid dimension and carries (acc, m, l) in VMEM scratch between grid
// steps.  On Hopper blocks run in no order, so one thread block owns one
// (g, h, 64-row q tile) and loops over ALL KV tiles itself, keeping the
// state in registers.  4 warps x 16 q rows; scores and PV run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
// score fragment is reused in registers as the A operand of the PV
// product (the FA2 layout identity), so P never touches shared memory.
// Ragged tails (T % 64, S % 64) are masked: rows past T load as zeros with
// segment 0 and are never stored, columns past S load as segment 0.
//
// Bound on this card.  At the serving slice's shape (G=8, Hg=3, T=S=4096,
// D=128) one launch computes every tile: 2*G*Hg*T*S*(Dk+Dv) = 206 GFLOP,
// 0.21 ms at 989 TFLOP/s bf16; its bytes (q, k, v read once, the fp32
// carry read and written, about 125 MB) take 37 us at 3.35 TB/s.  So the
// tensor cores bound it.  This first version does not skip tiles that
// the segment/position metadata proves empty, loads K/V synchronously
// (no cp.async / TMA pipeline) and uses mma.sync rather than wgmma; those
// are the known gaps to the bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); plain C entry
// point, loaded with ctypes, launched on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // q rows per block (16 per warp)
constexpr int BK = 64;            // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// rows [row0, row0 + BQ or BK) of a [n, D] bf16 matrix into shared memory
// with row stride D + 8; rows >= n are zero-filled.
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

template <int DK, int DV, bool CARRY>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_seg, const int* __restrict__ k_seg,
                 const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                 float* acc, float* m_io, float* l_io,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int Hg, int T, int S, float scale, int causal, int window,
                 float softcap) {
  constexpr int QS = DK + 8;              // shared row strides (elements)
  constexpr int VS = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * QS;
  __nv_bfloat16* sV = sK + BK * QS;
  int* sKseg = reinterpret_cast<int*>(sV + BK * VS);
  int* sKpos = sKseg + BK;

  const int g = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;   // mma row group / thread in group

  const size_t head = (size_t)g * Hg + h;
  const __nv_bfloat16* qh = q + head * T * DK;
  const __nv_bfloat16* kg = k + (size_t)g * S * DK;
  const __nv_bfloat16* vg = v + (size_t)g * S * DV;

  // this thread's two q rows within the tile, and their metadata
  const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;
  const int t_lo = q0 + r_lo, t_hi = q0 + r_hi;
  const bool in_lo = t_lo < T, in_hi = t_hi < T;
  const int qseg_lo = in_lo ? q_seg[t_lo] : 0;
  const int qseg_hi = in_hi ? q_seg[t_hi] : 0;
  const int qpos_lo = in_lo ? q_pos[t_lo] : 0;
  const int qpos_hi = in_hi ? q_pos[t_hi] : 0;

  load_tile<DK>(sQ, qh, q0, T, BQ);
  __syncthreads();

  // Q as mma A fragments, held for the whole KV loop
  uint32_t qa[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const int c = kk * 16 + 2 * tig;
    qa[kk][0] = ld32(sQ + r_lo * QS + c);
    qa[kk][1] = ld32(sQ + r_hi * QS + c);
    qa[kk][2] = ld32(sQ + r_lo * QS + c + 8);
    qa[kk][3] = ld32(sQ + r_hi * QS + c + 8);
  }

  // online-softmax state: o[nt] holds acc[row][nt*8 + 2*tig + {0,1}] for
  // rows lo (elements 0, 1) and hi (elements 2, 3)
  float o[DV / 8][4];
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  float* acc_h = acc + head * T * DV;
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    if (CARRY) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo) {
        const float2 a = *reinterpret_cast<const float2*>(acc_h + (size_t)t_lo * DV + c);
        o[nt][0] = a.x; o[nt][1] = a.y;
      }
      if (in_hi) {
        const float2 a = *reinterpret_cast<const float2*>(acc_h + (size_t)t_hi * DV + c);
        o[nt][2] = a.x; o[nt][3] = a.y;
      }
    }
  }
  if (CARRY) {
    if (in_lo) { m_lo = m_io[head * T + t_lo]; l_lo = l_io[head * T + t_lo]; }
    if (in_hi) { m_hi = m_io[head * T + t_hi]; l_hi = l_io[head * T + t_hi]; }
  }

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

    // scores S = Q K^T for this warp's 16 rows x 64 columns
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = sK + (nt * 8 + gid) * QS + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        mma_bf16_16816(s[nt], qa[kk], ld32(krow + kk * 16),
                       ld32(krow + kk * 16 + 8));
    }

    // scale, softcap, mask; row maxima
    uint32_t ok_bits = 0;                 // bit nt*4 + e: element unmasked
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        const int qs = e < 2 ? qseg_lo : qseg_hi;
        const int qp = e < 2 ? qpos_lo : qpos_hi;
        const int ks = sKseg[col], kp = sKpos[col];
        bool ok = (qs == ks) && (qs > 0) && (ks > 0);
        if (causal) ok = ok && (kp <= qp);
        if (window) ok = ok && (qp - kp < window);
        float x = s[nt][e] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        x = ok ? x : NEG_INF;
        s[nt][e] = x;
        if (ok) ok_bits |= 1u << (nt * 4 + e);
        if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
      }
    }
    // the four threads of a group share a row
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);

    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (ok_bits >> (nt * 4 + e)) & 1u;
        const float p = ok ? expf(s[nt][e] - (e < 2 ? mn_lo : mn_hi)) : 0.f;
        s[nt][e] = p;
        if (e < 2) rs_lo += p; else rs_hi += p;
      }
    }
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 1);
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 2);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 1);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 2);

    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * al_lo + rs_lo;
    l_hi = l_hi * al_hi + rs_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      o[nt][0] *= al_lo; o[nt][1] *= al_lo;
      o[nt][2] *= al_hi; o[nt][3] *= al_hi;
    }

    // O += P V: P (bf16) straight from the score registers as A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = sV + (kk * 16 + 2 * tig) * VS + gid;
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt) {
        const __nv_bfloat16* vp = v0 + nt * 8;
        const uint32_t b0 = pack_h2(vp[0], vp[VS]);
        const uint32_t b1 = pack_h2(vp[8 * VS], vp[9 * VS]);
        mma_bf16_16816(o[nt], pa, b0, b1);
      }
    }
  }

  // epilogue
  if (CARRY) {
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (in_lo)
        *reinterpret_cast<float2*>(acc_h + (size_t)t_lo * DV + c) =
            make_float2(o[nt][0], o[nt][1]);
      if (in_hi)
        *reinterpret_cast<float2*>(acc_h + (size_t)t_hi * DV + c) =
            make_float2(o[nt][2], o[nt][3]);
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
            live_lo ? pack_f2(o[nt][0] / d_lo, o[nt][1] / d_lo) : 0u;
      if (in_hi)
        *reinterpret_cast<uint32_t*>(out_h + (size_t)t_hi * DV + c) =
            live_hi ? pack_f2(o[nt][2] / d_hi, o[nt][3] / d_hi) : 0u;
    }
    if (tig == 0) {
      if (in_lo) lse[head * T + t_lo] = live_lo ? m_lo + logf(l_lo) : NEG_INF;
      if (in_hi) lse[head * T + t_hi] = live_hi ? m_hi + logf(l_hi) : NEG_INF;
    }
  }
}

template <int DK, int DV, bool CARRY>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_seg, const void* k_seg, const void* q_pos,
                   const void* k_pos, void* acc, void* m, void* l, void* out,
                   void* lse, int G, int Hg, int T, int S, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)(BQ * (DK + 8) + BK * (DK + 8) + BK * (DV + 8)) *
          sizeof(__nv_bfloat16) +
      2 * BK * sizeof(int);
  auto kern = flash_fwd_kernel<DK, DV, CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, Hg, G);
  kern<<<grid, NTHREADS, smem, stream>>>(
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
  switch (dv) {
    FLASH_DV(32)
    FLASH_DV(64)
    FLASH_DV(128)
    default:
      return cudaErrorInvalidValue;
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
    default:
      return cudaErrorInvalidValue;
  }
}
