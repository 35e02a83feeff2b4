// Shared-memory-tiled int8 x int8 -> exact int32 GEMM on __dp4a, with the
// per-tensor x per-column dequant epilogue of the w8a8 kernels:
//
//     out[m, n] = (float)(sum_k x[m, k] * w[k, n]) * sx * sw[n]
//
// evaluated in exactly that order (int32 -> f32 round-to-nearest, then two
// f32 multiplies, never fused), so the f32 output is bit-identical to the
// plain PyTorch versions beside the wrappers.
//
// Layout: x (M, K) int8 row-major, K a multiple of 4 (the wrappers pad);
// the weight side is read through a loader (`WLoad`) that turns 4
// consecutive K rows of 4 columns into 4 dp4a operands, one int32 per
// column.  The int8 loader transposes a 4x4 byte block in registers; the
// 2-bit loader unpacks one packed byte straight into one operand (the 4
// codes of a byte are 4 consecutive K rows of one column).  The K-major
// loader (`KMajorInt8Weights`, quant_matmul's weight held as (N, K)) gives
// 4 operands of one column, 16 consecutive K bytes, from one 16-byte load;
// `KMajorInt8Columns` reads the same layout one K word of 4 columns at a
// time (split_ternary's int8 columns beside its packed ones).
//
// Tiles: BN = 64 columns, BK = 64 K-bytes per stage, BM = 16 * TM rows;
// 256 threads, each holding TM x 4 int32 accumulators.  The next stage's
// global loads are issued into registers before the current stage is
// computed from shared memory (one-stage register prefetch).  No atomics,
// no split-K: the result does not depend on scheduling order.  The
// mainloop (`dp4a_tile`) is a device function of its own, so that
// split_precision.cu runs it on the int8 tiles of its two-domain GEMM.
// This is the decode GEMM of the port (M = batch, bound by the weight
// bytes); quant_matmul.cu, split_ternary.cu and ternary_packed.cu run
// M > 16 on int8 wgmma instead (int8_wgmma.cuh).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include <type_traits>

namespace i8gemm {

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 64;         // K bytes per stage
constexpr int kKW = kBK / 4;    // int32 words per tile row

// 4 rows (K) x 4 columns (N) of int8, one uint32 per row -> one uint32 per
// column holding that column's 4 K values, K-ascending from the low byte.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             int (&c)[4]) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  c[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
  c[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
  c[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
  c[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

// Weight side of quant_matmul: w (K, N) int8 row-major, N % 4 == 0.
struct Int8Weights {
  const int8_t* w;
  int n_cols;
  int k_words;  // K / 4

  // Operands of K rows [4 * kw, 4 * kw + 4) for columns [n, n + 4).
  __device__ __forceinline__ void load(int kw, int n, int (&c)[4]) const {
    if (kw >= k_words || n >= n_cols) {
      c[0] = c[1] = c[2] = c[3] = 0;
      return;
    }
    const size_t stride = static_cast<size_t>(n_cols) / 4;  // words per row
    const uint32_t* p = reinterpret_cast<const uint32_t*>(
        w + static_cast<size_t>(4 * kw) * n_cols + n);
    transpose4x4(__ldg(p), __ldg(p + stride), __ldg(p + 2 * stride),
                 __ldg(p + 3 * stride), c);
  }
};

// One packed byte -> one dp4a operand: byte j = code(j) - 1 in {-1, 0, 1}.
__device__ __forceinline__ int unpack_ternary_word(uint32_t b) {
  const uint32_t t = (b & 0x3u) | ((b & 0xCu) << 6) | ((b & 0x30u) << 12) |
                     ((b & 0xC0u) << 18);
  return static_cast<int>(__vsub4(t, 0x01010101u));
}

// Weight side of ternary_packed (and of split_ternary's ternary columns):
// w_packed (K/4, N) uint8, N % 4 == 0 -- code c of K row 4k + c in bits
// 2c .. 2c+1 of byte [k, n], biased by +1.  A byte holds 4 consecutive K
// rows of one column, so it unpacks in registers into exactly one operand.
struct PackedTernaryWeights {
  const uint8_t* packed;
  int n_cols;
  int k_words;  // K / 4, the packed rows

  __device__ __forceinline__ void load(int kw, int n, int (&c)[4]) const {
    if (kw >= k_words || n >= n_cols) {
      c[0] = c[1] = c[2] = c[3] = 0;
      return;
    }
    const uint32_t b4 = __ldg(reinterpret_cast<const uint32_t*>(
        packed + static_cast<size_t>(kw) * n_cols + n));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = unpack_ternary_word((b4 >> (8 * j)) & 0xFFu);
  }
};

// Weight side of quant_matmul at decode: its K-major copy w (N, K) int8,
// K a multiple of 16, each row 16-byte aligned.  One 16-byte load gives
// the operands of K bytes [4 kw, 4 kw + 16) of column n, kw a multiple of 4.
struct KMajorInt8Weights {
  const int8_t* w;
  int n_cols;
  int k_words;  // K / 4

  __device__ __forceinline__ void load(int kw, int n, int (&c)[4]) const {
    if (kw >= k_words || n >= n_cols) {
      c[0] = c[1] = c[2] = c[3] = 0;
      return;
    }
    const int4 v = __ldg(reinterpret_cast<const int4*>(
        w + (static_cast<size_t>(n) * k_words + kw) * 4));
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
  }
};

// Weight side of split_ternary's int8 columns at decode: the K-major
// (N, K) int8 codes, K a multiple of 4.  One K word of 4 columns, as the
// row-major loaders give it: four 4-byte loads, one per column, no
// transpose (each already holds 4 consecutive K bytes), each predicated
// on its own column and without a branch (a branching form ran slower).
struct KMajorInt8Columns {
  const int8_t* w;
  int n_cols;
  int k_words;  // K / 4

  __device__ __forceinline__ void load(int kw, int n, int (&c)[4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = (kw < k_words && n + j < n_cols)
                 ? __ldg(reinterpret_cast<const int*>(w) +
                         static_cast<size_t>(n + j) * k_words + kw)
                 : 0;
  }
};

// Loaders whose `load` gives 4 K words of one column, not one K word of 4
// columns.
template <class WLoad>
struct loads_k_words : std::false_type {};
template <>
struct loads_k_words<KMajorInt8Weights> : std::true_type {};

// Exact int32 sum over all of K of the (16 * TM) x kBN output tile at
// (m0, n0): thread (tx, ty) = (tid % 16, tid / 16) holds rows ty + 16 * i
// and columns n0 + tx + 16 * j in acc[i][j].  Block-uniform control flow
// (it synchronises the block).
template <int TM, class WLoad>
__device__ __forceinline__ void dp4a_tile(const int8_t* __restrict__ x,
                                          const WLoad& wl, int m0, int n0,
                                          int M, int K, int (&acc)[TM][4]) {
  constexpr int BM = 16 * TM;
  __shared__ int xs[BM][kKW + 1];
  __shared__ int ws[kBN][kKW + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k_words = K / 4;
  const int* xw = reinterpret_cast<const int*>(x);
  // weight loads: thread -> (word row q, 4 columns starting at c4), or for
  // a loader of K words (4 words starting at q, column c4)
  constexpr bool kWords = loads_k_words<WLoad>::value;
  const int wq_row = kWords ? (tid % 4) * 4 : tid / 16;
  const int c4 = kWords ? tid / 4 : (tid % 16) * 4;

  int xr[TM];
  int wr[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int idx = tid + kThreads * i;  // BM * kKW == kThreads * TM
      const int r = idx / kKW, q = idx % kKW;
      const int m = m0 + r, kw = k0 / 4 + q;
      xr[i] = (m < M && kw < k_words)
                  ? __ldg(xw + static_cast<size_t>(m) * k_words + kw) : 0;
    }
    wl.load(k0 / 4 + wq_row, n0 + c4, wr);
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int idx = tid + kThreads * i;
      xs[idx / kKW][idx % kKW] = xr[i];
    }
    if constexpr (kWords) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[c4][wq_row + j] = wr[j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[c4 + j][wq_row] = wr[j];
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    stash();
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);
#pragma unroll
    for (int q = 0; q < kKW; ++q) {
      int a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][q];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The w8a8 epilogue of one output: f32(acc) * sx, then * sw[n].
__device__ __forceinline__ float dequant(int acc, float sx, float swn) {
  const float v = static_cast<float>(acc) * sx;
  return v * swn;
}

template <int TM, class WLoad>
__global__ void __launch_bounds__(kThreads)
gemm_dp4a(const int8_t* __restrict__ x, WLoad wl,
          const float* __restrict__ sx, const float* __restrict__ sw,
          float* __restrict__ out, int M, int N, int K) {
  const int m0 = blockIdx.y * 16 * TM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int acc[TM][4];
  dp4a_tile<TM>(x, wl, m0, n0, M, K, acc);

  const float s = *sx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        out[static_cast<size_t>(m) * N + n] = dequant(acc[i][j], s, sw[n]);
    }
  }
}

// Small M (decode: M = batch) takes 16-row tiles, larger M 64-row tiles.
template <class WLoad>
inline int launch(const int8_t* x, WLoad wl, const float* sx, const float* sw,
                  float* out, int M, int N, int K, cudaStream_t stream) {
  const unsigned gx = static_cast<unsigned>((N + kBN - 1) / kBN);
  if (M <= 16) {
    dim3 grid(gx, static_cast<unsigned>((M + 15) / 16));
    gemm_dp4a<1, WLoad><<<grid, kThreads, 0, stream>>>(x, wl, sx, sw, out,
                                                       M, N, K);
  } else {
    dim3 grid(gx, static_cast<unsigned>((M + 63) / 64));
    gemm_dp4a<4, WLoad><<<grid, kThreads, 0, stream>>>(x, wl, sx, sw, out,
                                                       M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8gemm
