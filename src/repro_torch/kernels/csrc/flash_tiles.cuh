// Device code shared by the Hopper flash kernels (flash_fwd.cu and
// flash_bwd.cu):
//
//  * Tile liveness.  `warp_tile_meta` (one warp) and `thread_tile_meta` (one
//    thread) reduce one 64-row tile of a packed buffer to the ranges (pos
//    min/max, seg min/max) of its non-padding tokens, and `tile_relevant`
//    decides from two such ranges whether any query of one tile can see
//    any key of the other: the rule of the reference's `core/ring.py::
//    _block_meta` / `_block_relevant`, applied per tile (the port's Python
//    copy is `repro_torch/core/ring.py`).  A tile it
//    rejects holds no visible pair, so skipping it adds exact zeros (p = 0,
//    alpha = 1) and changes no bit of the result.  `tile_full` marks the
//    live tiles whose every pair is visible (one segment, no padding,
//    entirely in the past and inside the window): their element-wise mask
//    is all true and is not evaluated.  `build_live_masks` writes both
//    verdicts for every tile of one axis into bitmasks in shared memory;
//    `next_live` walks the live one.
//  * The core-matrix layout in shared memory that wgmma reads without a
//    swizzle: 8 x 8 bf16 core matrices of 128 contiguous bytes (8 rows of 16
//    bytes), the D/8 core matrices of an 8-row group side by side, the
//    groups one after another.  One tile serves as a K-major operand (its
//    rows along M or N) and as an MN-major B operand (its rows along K):
//    only the descriptor differs.
//  * cp.async loads into that layout (zero-filled past the end of the
//    buffer), wgmma descriptors, and the wgmma instructions the kernels use
//    (m64n64k16 with both operands in shared memory; m64n{32,64,128}k16 with
//    A in registers and an MN-major B, and N = 192 and 256 as 128 + 64 and
//    128 + 128).
//
// Fragment layouts: the accumulator of an m64nNk16 wgmma gives warp w of the
// warpgroup rows 16w + gid and 16w + gid + 8 (gid = lane / 4) and, for each
// 8-column block j, d[4j + {0,1}] = (row gid, cols 8j + 2 tig + {0,1}) and
// d[4j + {2,3}] = (row gid + 8, same cols) (tig = lane % 4): per warp, the
// mma.m16n8k16 C fragment.  A register A operand takes the mma.m16n8k16 A
// fragment of the same rows, so a score accumulator becomes the A operand
// of the next product in registers (the FlashAttention-2 layout identity).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr int TILE = 64;                  // rows of every q and kv tile
constexpr int BIG = 1 << 30;              // _block_meta's empty-range sentinel

// ---------------------------------------------------------------------------
// tile liveness
// ---------------------------------------------------------------------------

struct TileMeta {
  int pos_min, pos_max, seg_min, seg_max;
  int n_valid;                            // rows with seg > 0
};

__device__ __forceinline__ void meta_add(TileMeta& m, int s, int p) {
  if (s > 0) {
    m.pos_min = min(m.pos_min, p);
    m.pos_max = max(m.pos_max, p);
    m.seg_min = min(m.seg_min, s);
    m.seg_max = max(m.seg_max, s);
    ++m.n_valid;
  }
}

// rows [tile * 64, tile * 64 + 64) of seg/pos [n], reduced by one warp over
// its non-padding tokens (seg > 0); rows >= n are padding.  A tile of
// padding only gives (BIG, -1, BIG, -1).
__device__ __forceinline__ TileMeta warp_tile_meta(const int* seg,
                                                   const int* pos, int n,
                                                   int tile, int lane) {
  TileMeta m{BIG, -1, BIG, -1, 0};
#pragma unroll
  for (int i = lane; i < TILE; i += 32) {
    const int r = tile * TILE + i;
    meta_add(m, r < n ? seg[r] : 0, r < n ? pos[r] : 0);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m.pos_min = min(m.pos_min, __shfl_xor_sync(0xffffffffu, m.pos_min, off));
    m.pos_max = max(m.pos_max, __shfl_xor_sync(0xffffffffu, m.pos_max, off));
    m.seg_min = min(m.seg_min, __shfl_xor_sync(0xffffffffu, m.seg_min, off));
    m.seg_max = max(m.seg_max, __shfl_xor_sync(0xffffffffu, m.seg_max, off));
    m.n_valid += __shfl_xor_sync(0xffffffffu, m.n_valid, off);
  }
  return m;
}

// the same, reduced by one thread: its 128 loads are independent, so the
// prologue pays about one round trip to L2 per tile a thread owns
__device__ __forceinline__ TileMeta thread_tile_meta(const int* seg,
                                                     const int* pos, int n,
                                                     int tile) {
  TileMeta m{BIG, -1, BIG, -1, 0};
  const int r0 = tile * TILE;
#pragma unroll 16
  for (int i = 0; i < TILE; ++i) {
    const int r = r0 + i;
    meta_add(m, r < n ? seg[r] : 0, r < n ? pos[r] : 0);
  }
  return m;
}

// can ANY query of tile q see ANY key of tile k?  (_block_relevant)
__device__ __forceinline__ bool tile_relevant(const TileMeta& q,
                                              const TileMeta& k, int causal,
                                              int window) {
  bool ok = (k.seg_min <= q.seg_max) && (q.seg_min <= k.seg_max);
  ok = ok && k.seg_max >= 0 && q.seg_max >= 0;
  if (causal) ok = ok && k.pos_min <= q.pos_max;
  if (window) ok = ok && k.pos_max > q.pos_min - window;
  return ok;
}

// can EVERY query of tile q see EVERY key of tile k?  Then the element-wise
// mask of the pair is all true and the kernels skip it.
__device__ __forceinline__ bool tile_full(const TileMeta& q, const TileMeta& k,
                                          int causal, int window) {
  bool ok = q.n_valid == TILE && k.n_valid == TILE &&
            q.seg_min == q.seg_max && k.seg_min == k.seg_max &&
            q.seg_min == k.seg_min;
  if (causal) ok = ok && k.pos_max <= q.pos_min;
  if (window) ok = ok && q.pos_max - k.pos_min < window;
  return ok;
}

// Tile verdicts for NM own tiles against every tile t of the axis seg/pos
// [n] (n_tiles tiles, `words` 32-bit words per bitmask): for own tile j
// (mines[j], a q tile when mine_is_q, a kv tile otherwise) bit t of
// masks[2j] is set where tile t is relevant and bit t of masks[2j + 1]
// where every pair of the two tiles is visible; with NM > 1, masks[2 NM]
// holds the union of the live masks.  Every thread of the block calls it,
// each reducing whole tiles; it ends with __syncthreads, so the masks are
// ready on return.
template <int NTHREADS, int NM>
__device__ __forceinline__ void build_live_masks(uint32_t* masks, int words,
                                                 int n_tiles, const int* seg,
                                                 const int* pos, int n,
                                                 const TileMeta* mines,
                                                 bool mine_is_q, int causal,
                                                 int window) {
  constexpr int NMASK = NM > 1 ? 2 * NM + 1 : 2;
  for (int i = threadIdx.x; i < NMASK * words; i += NTHREADS) masks[i] = 0u;
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += NTHREADS) {
    const TileMeta o = thread_tile_meta(seg, pos, n, t);
    const uint32_t b = 1u << (t & 31);
    bool any = false;
#pragma unroll
    for (int j = 0; j < NM; ++j) {
      const TileMeta& q = mine_is_q ? mines[j] : o;
      const TileMeta& k = mine_is_q ? o : mines[j];
      if (tile_relevant(q, k, causal, window)) {
        any = true;
        atomicOr(masks + 2 * j * words + (t >> 5), b);
        if (tile_full(q, k, causal, window))
          atomicOr(masks + (2 * j + 1) * words + (t >> 5), b);
      }
    }
    if (NM > 1 && any) atomicOr(masks + 2 * NM * words + (t >> 5), b);
  }
  __syncthreads();
}

__device__ __forceinline__ bool bit(const uint32_t* mask, int t) {
  return (mask[t >> 5] >> (t & 31)) & 1u;
}

// the first live tile at or after t, or n_tiles when none is left
__device__ __forceinline__ int next_live(const uint32_t* mask, int t,
                                         int n_tiles) {
  while (t < n_tiles) {
    const uint32_t w = mask[t >> 5] >> (t & 31);
    if (w) return t + __ffs(w) - 1;
    t = (t | 31) + 1;
  }
  return n_tiles;
}

// ---------------------------------------------------------------------------
// shared-memory layout and cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + 64) of a row-major [n, D] bf16 matrix into a core-layout
// tile at shared address dst (rows >= n zero-filled), copied by threads
// tid = 0 .. NTHREADS - 1.  Eight neighbouring threads fill one core matrix,
// so the shared stores are conflict-free.
template <int D, int NTHREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n, int tid) {
  constexpr int CH = D / 8;               // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < TILE * CH; i += NTHREADS) {
    const int r8 = i & 7, rest = i >> 3;
    const int grp = rest / CH, c = rest % CH;
    const int r = row0 + grp * 8 + r8;
    const bool ok = r < n;
    cp_async16(dst + grp * (16 * D) + c * 128 + r8 * 16,
               src + (size_t)(ok ? r : row0) * D + c * 8, ok);
  }
}

template <int D, int NTHREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n) {
  load_tile_async<D, NTHREADS>(dst, src, row0, n, threadIdx.x);
}

// threadIdx.x, read where it is used: the compiler cannot hoist the read
// out of a loop, so addresses derived from it hold no register across it
__device__ __forceinline__ int tid_here() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// rows [row0, row0 + 64) of a 4-byte vector [n] into shared memory (rows >= n
// zero-filled); threads 0..63 copy one value each
template <typename T>
__device__ __forceinline__ void load_vec_async(uint32_t dst, const T* src,
                                               int row0, int n) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  if (threadIdx.x < TILE) {
    const int r = row0 + threadIdx.x;
    const bool ok = r < n;
    cp_async4(dst + threadIdx.x * 4, src + (ok ? r : row0), ok);
  }
}

// make this thread's generic-proxy writes to shared memory (cp.async
// included) visible to wgmma's async proxy; then a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// matrix descriptor of a core-layout operand, no swizzle: start address,
// leading-dimension byte offset (between core matrices along K, for K-major
// and MN-major operands alike) and stride byte offset (between core matrices
// along M or N), as an H100 confirmed for both operand majors
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// a core-layout tile with D columns as a K-major operand (rows along M or N,
// columns along K); k-step kk takes columns [16 kk, 16 kk + 16)
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + kk * 256, 128, 16 * D);
}

// a core-layout tile with D columns as an MN-major B operand (rows along K,
// columns along N); k-step kk takes rows [16 kk, 16 kk + 16)
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 32 * D, 16 * D, 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin accumulator registers in program order around an asynchronous wgmma
// (no read moves above the wait, no write below the issue)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[32] (+)= A[64x16] . B[16x64]: A and B from shared memory, both
// K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[16] (+)= A[64x16] . B[16x32]: A from registers, B from shared memory,
// MN-major (trans-b)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[32] (+)= A[64x16] . B[16x64]: A from registers, B from shared memory,
// MN-major (trans-b)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64] (+)= A[64x16] . B[16x128]: A from registers, B from shared memory,
// MN-major (trans-b)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[N/2] (+)= A[64x16] . B[16xN] with A in registers, B MN-major.  N = 192
// and 256 issue an m64n128k16 on columns [0, 128) and an m64n64k16 or a
// second m64n128k16 on the rest: in the core layout column c starts c / 8
// core matrices (16 c bytes) further along N, so columns [128, N) take the
// first descriptor with its start address moved by 2048 >> 4, and the parts
// of d are their accumulators in the same fragment layout.  The same shift
// of the start address by 16 c0 bytes makes any column range [c0, c0 + N)
// of a wider tile the B operand (the (576, 512) kernels).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 192 || N == 256,
                "N in {32, 64, 128, 192, 256}");
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, scale_d);
  else if constexpr (N == 192) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, db, scale_d);
    wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&d[64]), a,
                 db + (2048 >> 4), scale_d);
  } else {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, db, scale_d);
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a,
                  db + (2048 >> 4), scale_d);
  }
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// k-step kk (16 columns) of a 64-column accumulator d[32] as the A operand
// of the next product, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&d)[32], int kk) {
  a[0] = pack_f2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_f2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_f2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_f2(d[8 * kk + 6], d[8 * kk + 7]);
}

// the same, split into bf16 hi = bf16(x) and lo = bf16(x - hi) fragments,
// so that hi + lo carries x to ~16 bits
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&d)[32], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = d[8 * kk + 2 * i], y = d[8 * kk + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_f2(x - hf.x, y - hf.y);
  }
}

}  // namespace flash
