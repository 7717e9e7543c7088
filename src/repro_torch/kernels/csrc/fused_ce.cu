// Fused softmax cross-entropy for Hopper (sm_90a), bf16 logits, fp32 math.
//
//   ce_fwd_kernel  replaces repro/kernels/fused_ce.py::_fwd_kernel (via
//                  fused_ce_fwd): one block per token row streams the row's
//                  logits once with a running max and sum-exp in fp32 and
//                  writes lse = m + log(sum), the target logit tgt and
//                  nll = lse - tgt.  A label outside [0, V) keeps tgt = -1e30,
//                  as the Pallas kernel's never-filled panel does.
//   ce_bwd_kernel  replaces repro/kernels/fused_ce.py::_bwd_kernel (via
//                  fused_ce_bwd): one elementwise pass,
//                  dlogits = (exp(lg - lse) - onehot(label)) * g, written in
//                  bf16.  A row with g = 0 (padding) gives exactly zero.
//
// Design.  The Pallas kernels walk vocabulary panels of 2048 as the
// sequential grid axis with the running stats in VMEM scratch; here one
// block of 256 threads owns a row and each thread streams 16-byte vectors
// (8 logits) through registers, folding each vector into its own (max,
// sum-exp) pair with one rescale; the pairs then merge across the block with
// warp shuffles.  The vocabulary needs no multiple of a panel: the loop ends
// at V (128256 = 62.6 panels of 2048).  Rows whose length is no multiple of 8
// logits take a scalar loop.
//
// Bound on this card: both are memory-bound.  At the training slice's shape
// (T = 4096, V = 128256) the forward reads 1.05 GB of logits (0.31 ms at
// 3.35 TB/s) and the backward reads and writes 1.05 GB each (0.63 ms); the
// exponentials (0.5 G) are far below the card's rate.  The design reads
// each logit once per kernel, the least either can do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); plain C entry
// points, loaded with ctypes, launched on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1.0e30f;

// fold a value set with max mx and sum-exp sx (relative to mx) into (m, s)
__device__ __forceinline__ void merge(float& m, float& s, float mx, float sx) {
  const float mn = fmaxf(m, mx);
  s = s * expf(m - mn) + sx * expf(mx - mn);
  m = mn;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__global__ void __launch_bounds__(NTHREADS)
ce_fwd_kernel(const __nv_bfloat16* __restrict__ logits,
              const int* __restrict__ labels, float* __restrict__ nll,
              float* __restrict__ lse_out, float* __restrict__ tgt_out,
              int V) {
  __shared__ float sm[NWARPS], ss[NWARPS];
  const int row = blockIdx.x;
  const __nv_bfloat16* lg = logits + (size_t)row * V;
  float m = NEG_INF, s = 0.f;
  if ((V & 7) == 0) {
    const uint4* vec = reinterpret_cast<const uint4*>(lg);
    for (int i = threadIdx.x; i < V / 8; i += NTHREADS) {
      float x[8];
      unpack8(vec[i], x);
      float mx = x[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, x[j]);
      float sx = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sx += expf(x[j] - mx);
      merge(m, s, mx, sx);
    }
  } else {
    for (int i = threadIdx.x; i < V; i += NTHREADS)
      merge(m, s, __bfloat162float(lg[i]), 1.f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, mo, so);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm[0];
    s = ss[0];
    for (int w = 1; w < NWARPS; ++w) merge(m, s, sm[w], ss[w]);
    const float l = m + logf(s);
    const int label = labels[row];
    const float t =
        (label >= 0 && label < V) ? __bfloat162float(lg[label]) : NEG_INF;
    lse_out[row] = l;
    tgt_out[row] = t;
    nll[row] = l - t;
  }
}

__global__ void __launch_bounds__(NTHREADS)
ce_bwd_kernel(const __nv_bfloat16* __restrict__ logits,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ g, __nv_bfloat16* __restrict__ dlogits,
              int V) {
  const int row = blockIdx.x;
  const __nv_bfloat16* lg = logits + (size_t)row * V;
  __nv_bfloat16* dl = dlogits + (size_t)row * V;
  const float l = lse[row], gr = g[row];
  const int label = labels[row];
  if ((V & 7) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(lg);
    uint4* dst = reinterpret_cast<uint4*>(dl);
    for (int i = threadIdx.x; i < V / 8; i += NTHREADS) {
      float x[8];
      unpack8(src[i], x);
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (expf(x[j] - l) - (i * 8 + j == label ? 1.f : 0.f)) * gr;
      uint4 o;
      __nv_bfloat162 h;
      h = __floats2bfloat162_rn(d[0], d[1]); o.x = *reinterpret_cast<uint32_t*>(&h);
      h = __floats2bfloat162_rn(d[2], d[3]); o.y = *reinterpret_cast<uint32_t*>(&h);
      h = __floats2bfloat162_rn(d[4], d[5]); o.z = *reinterpret_cast<uint32_t*>(&h);
      h = __floats2bfloat162_rn(d[6], d[7]); o.w = *reinterpret_cast<uint32_t*>(&h);
      dst[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < V; i += NTHREADS) {
      const float d =
          (expf(__bfloat162float(lg[i]) - l) - (i == label ? 1.f : 0.f)) * gr;
      dl[i] = __float2bfloat16(d);
    }
  }
}

}  // namespace

// Plain C entry points (ctypes).  logits [T,V] bf16, labels [T] int32,
// nll/lse/tgt/g [T] fp32, dlogits [T,V] bf16; all contiguous, logits
// 16-byte aligned.  Each returns the launch's cudaError_t (0 on success).

extern "C" int fused_ce_fwd_bf16(const void* logits, const void* labels,
                                 void* nll, void* lse, void* tgt, int T, int V,
                                 void* stream) {
  if (T == 0) return cudaSuccess;
  ce_fwd_kernel<<<T, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const int*>(labels), static_cast<float*>(nll),
      static_cast<float*>(lse), static_cast<float*>(tgt), V);
  return cudaGetLastError();
}

extern "C" int fused_ce_bwd_bf16(const void* logits, const void* labels,
                                 const void* lse, const void* g,
                                 void* dlogits, int T, int V, void* stream) {
  if (T == 0) return cudaSuccess;
  ce_bwd_kernel<<<T, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dlogits), V);
  return cudaGetLastError();
}
