// The decode GEMM (M <= 16 rows) of the port's five int8 kernels, for
// sm_90a:
//
//     out[m, n] = (float)(sum_k x[m, k] * w[k, n]) * sx * sw[n]
//
// for the int8 and ternary columns, and, for split_precision's bf16
// columns, out[m, n] = sum_k x_bf16[m, k] * w_bf16[k, n] in float32.  At M
// = batch the weight stream bounds it (bytes), so the design is about
// keeping that stream in flight on every SM:
//
//   - Grid.  A block owns a column tile of `bn` columns (16, 32, 64 or
//     128) and one of `split` slices of K; the `split` blocks of a column
//     tile form a thread-block cluster.  `bn` and `split` come from the
//     wrappers' launch plan (kernels/quant_matmul.py `decode_plan`), a
//     pure function of M, K, N and the SM count that gives every served
//     shape at least one block per SM.
//   - Warps.  Each of the 8 warps owns 16 columns of the tile and a
//     sub-slice of the block's K slice (8 / (bn / 16) warps per 16
//     columns), and keeps 4 chunks of 64 K-bytes of its two columns per
//     lane in flight: 16-byte loads that bypass L1, 4 KB per warp.
//   - Tensor cores.  A warp's 16 columns are the 16 rows of mma.sync
//     m16n8k32 s8 (the weights as operand A, so nothing is transposed),
//     x's rows the 8 columns of operand B (two products for M > 8).  Lane
//     (g = lane / 4, q = lane % 4) holds columns 2g and 2g + 1 of the
//     group, and K bytes [16 q, 16 q + 16) of each 64-byte chunk: words 0
//     and 1 feed the chunk's first product, words 2 and 3 its second, so
//     a K-major column's 16-byte run is one load and a packed column's
//     four packed rows four 2-byte loads (both columns at once), each
//     byte unpacked in registers into one operand word.  int32 sums are
//     exact in any order.
//   - x.  The block's K slice of x (M rows) is staged once in shared
//     memory (row stride = 64 mod 128 bytes: the 16-byte operand reads of
//     a quarter warp hit distinct banks).
//   - Reduction.  Each warp writes its 16 x 16 partial tile to shared
//     memory; the block sums its warps in a fixed order, then, after a
//     cluster barrier, rank r of the cluster sums the `split` blocks'
//     partials of its share of the outputs through distributed shared
//     memory (ranks in order) and applies the epilogue.  One launch, no
//     workspace, no atomics.
//
// The epilogue is int8_gemm.cuh's `dequant` (f32(acc) * sx, then * sw[n],
// never fused), stores masked at M and N: integer outputs are
// bit-identical to the plain versions.  bf16 columns (split_precision)
// run on CUDA cores: products of two bf16 values (exact in f32) summed by
// fmaf, each lane over the K rows it reads (K ascending), then across the
// 8 lanes of a column group by a shuffle butterfly, then over the warps
// of the block and the blocks of the cluster in order -- another order
// than the plain version's, within `bf16_error_bound`.
//
// Weight sources (the `Src` parameter):
//   KMajorCodes     (N, K) int8, K a multiple of 16, rows 16-byte aligned
//                   (quant_matmul, ternary_matmul); columns at or above
//                   `limit` are not read;
//   PackedStream    (Kp, N) 2-bit stream as stored, N even, code c of K
//                   row 4k + c in bits 2c .. 2c+1 of byte [k, n], biased
//                   by +1 (ternary_packed); columns below `first` are not
//                   read;
//   SplitTernary    the two above, per column at `boundary`
//                   (split_ternary: any boundary);
//   SplitPrecision  KMajorCodes below `boundary`, bf16 (K, N) row-major
//                   at or above it, N a multiple of 4 (split_precision).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_gemm.cuh"

namespace i8gemv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;      // K bytes per chunk (two m16n8k32 products)
constexpr int kUnroll = 4;      // chunks of loads in flight per warp
constexpr int kMaxBN = 128;
constexpr int kMaxSplit = 8;    // portable cluster size
// chunks of K per block (the shared x slice): K up to 8 x 48 x 64 = 24576,
// nemotron-4-15b's FFN input
constexpr int kMaxSpan = 48;

// Row stride of the staged x slice of `span` chunks: = 64 mod 128 bytes.
__host__ __device__ inline int x_stride(int span) {
  return (span * kChunk + 127) / 128 * 128 + 64;
}

// Dynamic shared memory of a launch: M rows of x_q (+ x_bf16).
__host__ __device__ inline int smem_bytes(int M, int span, bool bf16) {
  return M * x_stride(span) + (bf16 ? M * span * kChunk * 2 : 0);
}

__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ldg_u16(const void* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 ldg_u64(const void* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}

// D += A B, m16n8k32, s8 x s8 -> s32 (A row-major 16 x 32, B 32 x 8).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ sources --

// K-major (N, K) int8 codes.
struct KMajorCodes {
  static constexpr bool kBf16 = false;
  const int8_t* w;
  int k;
  int limit;  // columns >= limit (N, or a boundary) are not read

  __device__ bool int_cols(int c0) const { return c0 < limit; }
  __device__ bool int_col(int) const { return true; }
  // words 0..3 of columns n and n + 1 at K bytes [k16, k16 + 16)
  __device__ __forceinline__ void load(int n, int k16, uint4& a,
                                       uint4& b) const {
    const bool in_k = k16 < k;
    if (in_k && n < limit) a = ldg_stream(w + static_cast<size_t>(n) * k + k16);
    if (in_k && n + 1 < limit)
      b = ldg_stream(w + static_cast<size_t>(n + 1) * k + k16);
  }
};

// The (Kp, N) 2-bit stream.
struct PackedStream {
  static constexpr bool kBf16 = false;
  const uint8_t* p;
  int n_cols;  // N, even
  int kp;      // packed rows
  int first;   // columns < first are not read

  __device__ bool int_cols(int c0) const { return c0 < n_cols; }
  __device__ bool int_col(int) const { return true; }
  // packed rows k16 / 4 + j of columns n, n + 1 (n even), unpacked: word
  // j of each column; rows past Kp and columns past N give code 0
  __device__ __forceinline__ void load(int n, int k16, uint4& a,
                                       uint4& b) const {
    const int r0 = k16 / 4;
    uint32_t h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = 0x5555u;  // code 0 in every field
      if (n + 1 >= first && n < n_cols && r0 + j < kp)
        h[j] = ldg_u16(p + static_cast<size_t>(r0 + j) * n_cols + n);
    }
    a = make_uint4(i8gemm::unpack_ternary_word(h[0] & 0xFFu),
                   i8gemm::unpack_ternary_word(h[1] & 0xFFu),
                   i8gemm::unpack_ternary_word(h[2] & 0xFFu),
                   i8gemm::unpack_ternary_word(h[3] & 0xFFu));
    b = make_uint4(i8gemm::unpack_ternary_word(h[0] >> 8),
                   i8gemm::unpack_ternary_word(h[1] >> 8),
                   i8gemm::unpack_ternary_word(h[2] >> 8),
                   i8gemm::unpack_ternary_word(h[3] >> 8));
  }
};

// Columns below `boundary` from the int8 codes, the rest from the stream.
struct SplitTernary {
  static constexpr bool kBf16 = false;
  KMajorCodes q;    // limit = min(boundary, N)
  PackedStream t;   // first = boundary
  int boundary;

  __device__ bool int_cols(int c0) const { return c0 < t.n_cols; }
  __device__ bool int_col(int) const { return true; }
  // a, b arrive zero; q.load leaves columns >= boundary zero
  __device__ __forceinline__ void load(int n, int k16, uint4& a,
                                       uint4& b) const {
    q.load(n, k16, a, b);
    if (n + 1 >= boundary) {  // the pair reaches the stream
      uint4 ta, tb;
      t.load(n, k16, ta, tb);
      if (n >= boundary) a = ta;
      b = tb;
    }
  }
};

// Columns below `boundary` from the int8 codes, the rest bf16.
struct SplitPrecision {
  static constexpr bool kBf16 = true;
  KMajorCodes q;          // limit = min(boundary, N)
  const uint16_t* wb;     // (K, N) bf16 row-major
  int n_cols;             // N, a multiple of 4
  int boundary;

  __device__ bool int_cols(int c0) const { return q.int_cols(c0); }
  __device__ bool int_col(int n) const { return n < boundary; }
  __device__ bool bf16_cols(int c0) const {
    return c0 + 16 > boundary && c0 < n_cols;
  }
  __device__ __forceinline__ void load(int n, int k16, uint4& a,
                                       uint4& b) const {
    q.load(n, k16, a, b);
  }
};

// ----------------------------------------------------------- mainloops --

// int32 partial sums of a warp's 16 columns (n0w .. n0w + 15) over chunks
// [w_lo, w_hi): acc[h] is the m16n8 tile of x rows 8h .. 8h + 7.  x rows
// live in `xs` from chunk c_lo on.  Each pass issues the loads of kUnroll
// chunks, then multiplies them (double-buffering the loads raised the
// registers from 62 to 97 and slowed every decode shape).
template <int MT, class Src>
__device__ __forceinline__ void int8_warp(const Src& src, const int8_t* xs,
                                          int xstride, int M, int n0w,
                                          int c_lo, int w_lo, int w_hi,
                                          int lane, int (&acc)[MT / 8][4]) {
  const int g = lane >> 2, q = lane & 3;
  const int n = n0w + 2 * g;
  for (int c = w_lo; c < w_hi; c += kUnroll) {
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = b[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c + u < w_hi) src.load(n, (c + u) * kChunk + 16 * q, a[u], b[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u >= w_hi) break;  // warp-uniform
      const int off = (c + u - c_lo) * kChunk + 16 * q;
#pragma unroll
      for (int h = 0; h < MT / 8; ++h) {
        const int row = 8 * h + g;
        uint4 xv = make_uint4(0u, 0u, 0u, 0u);
        if (row < M)
          xv = *reinterpret_cast<const uint4*>(xs + row * xstride + off);
        mma_s8(acc[h], a[u].x, b[u].x, a[u].y, b[u].y, xv.x, xv.y);
        mma_s8(acc[h], a[u].z, b[u].z, a[u].w, b[u].w, xv.z, xv.w);
      }
    }
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// f32 partial sums of a warp's 16 bf16 columns over chunks [w_lo, w_hi):
// lane (c = lane % 4, r = lane / 4) reads columns n0w + 4c .. + 3 at K rows
// = r mod 8 (8-byte loads of 4 bf16); acc[j][m] after the butterfly over
// the 8 lanes of a column group (valid in lanes 0..3).
template <int MT>
__device__ __forceinline__ void bf16_warp(const SplitPrecision& src,
                                          const uint16_t* xsb, int span,
                                          int M, int K, int n0w, int c_lo,
                                          int w_lo, int w_hi, int lane,
                                          float (&acc)[4][MT]) {
  const int cc = lane & 3, r = lane >> 2;
  const int n = n0w + 4 * cc;
  const bool read = n < src.n_cols && n + 3 >= src.boundary;
  constexpr int kRows = kChunk / 8;  // K rows per lane and chunk
  for (int c = w_lo; c < w_hi; ++c) {
    uint2 w[kRows];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int k = c * kChunk + 8 * s + r;
      w[s] = make_uint2(0u, 0u);
      if (read && k < K)
        w[s] = ldg_u64(src.wb + static_cast<size_t>(k) * src.n_cols + n);
    }
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int off = (c - c_lo) * kChunk + 8 * s + r;
      const float wv[4] = {bf16_lo(w[s].x), bf16_hi(w[s].x), bf16_lo(w[s].y),
                           bf16_hi(w[s].y)};
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float xv = __uint_as_float(
              static_cast<uint32_t>(xsb[m * span * kChunk + off]) << 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j][m] = fmaf(xv, wv[j], acc[j][m]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[j][m];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[j][m] = v;
    }
}

// ------------------------------------------------------------- kernel --

template <bool kBf16>
struct Partials;

template <>
struct Partials<false> {
  int slot[kWarps][16][16];  // per warp: [x row][column of its group]
  int part[16][kMaxBN];      // per block: [x row][tile column]
};

template <>
struct Partials<true> : Partials<false> {
  float fslot[kWarps][16][16];
  float fpart[16][kMaxBN];
};

template <int MT, class Src>
__global__ void __launch_bounds__(kThreads)
    gemv(const int8_t* __restrict__ x, const uint16_t* __restrict__ xb,
         const Src src, const float* __restrict__ sx,
         const float* __restrict__ sw, float* __restrict__ out, int M, int N,
         int K, int bn, int split) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ Partials<Src::kBf16> sh;

  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / split) * bn;
  const int nck = (K + kChunk - 1) / kChunk;
  const int span = (nck + split - 1) / split;
  const int xstride = x_stride(span);
  const int c_lo = rank * nck / split, c_hi = (rank + 1) * nck / split;

  // stage x rows [0, M), K bytes of chunks [c_lo, c_hi), zeros past K
  int8_t* xs = reinterpret_cast<int8_t*>(dyn);
  uint16_t* xsb = reinterpret_cast<uint16_t*>(dyn + M * xstride);
  {
    const int vecs = (c_hi - c_lo) * kChunk / 16;
    for (int i = threadIdx.x; i < M * vecs; i += kThreads) {
      const int m = i / vecs, v = i % vecs;
      const int k = c_lo * kChunk + 16 * v;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < K)
        val = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m) * K + k));
      *reinterpret_cast<uint4*>(xs + m * xstride + 16 * v) = val;
    }
    if constexpr (Src::kBf16) {
      const int hvecs = (c_hi - c_lo) * kChunk / 8;
      for (int i = threadIdx.x; i < M * hvecs; i += kThreads) {
        const int m = i / hvecs, v = i % hvecs;
        const int k = c_lo * kChunk + 8 * v;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k < K)
          val = __ldg(reinterpret_cast<const uint4*>(
              xb + static_cast<size_t>(m) * K + k));
        *reinterpret_cast<uint4*>(xsb + m * span * kChunk + 8 * v) = val;
      }
    }
  }
  __syncthreads();

  // warp -> (16-column group, K sub-slice)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ng = bn / 16, wpg = kWarps / ng;
  const int grp = warp % ng, wk = warp / ng;
  const int parts = split * wpg, p = rank * wpg + wk;
  const int w_lo = p * nck / parts, w_hi = (p + 1) * nck / parts;
  const int n0w = n0 + 16 * grp;

  int acc[MT / 8][4];
#pragma unroll
  for (int h = 0; h < MT / 8; ++h)
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0;
  if (src.int_cols(n0w))  // warp-uniform
    int8_warp<MT>(src, xs, xstride, M, n0w, c_lo, w_lo, w_hi, lane, acc);
  {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int h = 0; h < MT / 8; ++h) {
      const int r = 8 * h + 2 * q;
      sh.slot[warp][r][2 * g] = acc[h][0];
      sh.slot[warp][r + 1][2 * g] = acc[h][1];
      sh.slot[warp][r][2 * g + 1] = acc[h][2];
      sh.slot[warp][r + 1][2 * g + 1] = acc[h][3];
    }
  }
  if constexpr (Src::kBf16) {
    float facc[4][MT];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m) facc[j][m] = 0.f;
    if (src.bf16_cols(n0w))  // warp-uniform
      bf16_warp<MT>(src, xsb, span, M, K, n0w, c_lo, w_lo, w_hi, lane,
                    facc);
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < MT; ++m) sh.fslot[warp][m][4 * lane + j] = facc[j][m];
    }
  }
  __syncthreads();

  // the block's sum over its warps, in warp order
  for (int i = threadIdx.x; i < MT * bn; i += kThreads) {
    const int m = i / bn, nl = i % bn, gi = nl / 16, col = nl % 16;
    int s = 0;
    for (int w = 0; w < wpg; ++w) s += sh.slot[w * ng + gi][m][col];
    sh.part[m][nl] = s;
    if constexpr (Src::kBf16) {
      float f = 0.f;
      for (int w = 0; w < wpg; ++w) f += sh.fslot[w * ng + gi][m][col];
      sh.fpart[m][nl] = f;
    }
  }
  cluster.sync();

  // rank r: its share of the tile's outputs, summed over the cluster's
  // blocks in rank order, then the epilogue
  const float s = *sx;
  for (int i = rank * kThreads + threadIdx.x; i < M * bn;
       i += kThreads * split) {
    const int m = i / bn, nl = i % bn, n = n0 + nl;
    if (n >= N) continue;
    float v;
    if (src.int_col(n)) {
      int t = 0;
      for (int r = 0; r < split; ++r) t += *cluster.map_shared_rank(&sh.part[m][nl], r);
      v = i8gemm::dequant(t, s, sw[n]);
    } else {
      float t = 0.f;
      if constexpr (Src::kBf16)
        for (int r = 0; r < split; ++r)
          t += *cluster.map_shared_rank(&sh.fpart[m][nl], r);
      v = t;
    }
    out[static_cast<size_t>(m) * N + n] = v;
  }
  cluster.sync();  // no block leaves while its partials are read
}

// ---------------------------------------------------------------- host --

// The host helpers have internal linkage: a function-local static of a
// template with external linkage is one object across every loaded
// library (GNU unique symbol), so only the first library to launch an
// instantiation would set the shared-memory attribute of its own kernel.
namespace {

template <int MT, class Src>
int launch_mt(const int8_t* x, const uint16_t* xb, const Src& src,
              const float* sx, const float* sw, float* out, int M, int N,
              int K, int bn, int split, cudaStream_t stream) {
  constexpr int kMaxSmem = 16 * (kMaxSpan * kChunk + 128) +
                           (Src::kBf16 ? 16 * kMaxSpan * kChunk * 2 : 0);
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemv<MT, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nck = (K + kChunk - 1) / kChunk;
  const int span = (nck + split - 1) / split;
  const int smem = smem_bytes(M, span, Src::kBf16);
  if (span > kMaxSpan || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + bn - 1) / bn * split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = static_cast<unsigned>(split);
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, gemv<MT, Src>, x, xb, src,
                                            sx, sw, out, M, N, K, bn, split);
  const cudaError_t last = cudaGetLastError();  // also clears a refusal
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

// Launches the decode GEMM of x (M, K) int8 row-major (K a multiple of 16,
// rows 16-byte aligned; M 1 .. 16) against `src` with the plan (bn,
// split); xb: x in bf16 (SplitPrecision only).  Returns a CUDA error code,
// 0 on success.
template <class Src>
int launch(const int8_t* x, const uint16_t* xb, const Src& src,
           const float* sx, const float* sw, float* out, int M, int N, int K,
           int bn, int split, cudaStream_t stream) {
  if (M < 1 || M > 16 || K % 16 || split < 1 || split > kMaxSplit ||
      (bn != 16 && bn != 32 && bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  return M <= 8 ? launch_mt<8>(x, xb, src, sx, sw, out, M, N, K, bn, split,
                               stream)
                : launch_mt<16>(x, xb, src, sx, sw, out, M, N, K, bn, split,
                                stream);
}

}  // namespace

}  // namespace i8gemv
