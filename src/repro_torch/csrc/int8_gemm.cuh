// Shared pieces of the port's w8a8 kernels, and the shared-memory-tiled
// int8 x int8 -> exact int32 GEMM on __dp4a that ternary_matmul runs above
// 16 rows:
//
//     out[m, n] = (float)(sum_k x[m, k] * w[k, n]) * sx * sw[n]
//
// evaluated in exactly that order (int32 -> f32 round-to-nearest, then two
// f32 multiplies, never fused: `dequant`, the epilogue of every int8
// kernel), so the f32 output is bit-identical to the plain PyTorch
// versions beside the wrappers.  `transpose4x4` and `unpack_ternary_word`
// are the byte shuffles the 2-bit paths of int8_wgmma.cuh and
// int8_gemv.cuh use.
//
// The GEMM: x (M, K) int8 row-major and the K-major weight (N, K) int8, K
// a multiple of 16, each row 16-byte aligned (`KMajorInt8Weights`: one
// 16-byte load gives the 4 dp4a operands of 16 consecutive K bytes of one
// column).  Tiles: BN = 64 columns, BK = 64 K-bytes per stage, BM = 16 *
// TM rows; 256 threads, each holding TM x 4 int32 accumulators.  The next
// stage's global loads are issued into registers before the current stage
// is computed from shared memory (one-stage register prefetch).  No
// atomics, no split-K: the result does not depend on scheduling order.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

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

// One packed byte -> one dp4a operand: byte j = code(j) - 1 in {-1, 0, 1}.
__device__ __forceinline__ int unpack_ternary_word(uint32_t b) {
  const uint32_t t = (b & 0x3u) | ((b & 0xCu) << 6) | ((b & 0x30u) << 12) |
                     ((b & 0xC0u) << 18);
  return static_cast<int>(__vsub4(t, 0x01010101u));
}

// The K-major weight w (N, K) int8.  One 16-byte load gives the operands
// of K bytes [4 kw, 4 kw + 16) of column n, kw a multiple of 4.
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

// Exact int32 sum over all of K of the (16 * TM) x kBN output tile at
// (m0, n0): thread (tx, ty) = (tid % 16, tid / 16) holds rows ty + 16 * i
// and columns n0 + tx + 16 * j in acc[i][j].  Block-uniform control flow
// (it synchronises the block).
template <int TM>
__device__ __forceinline__ void dp4a_tile(const int8_t* __restrict__ x,
                                          const KMajorInt8Weights& wl,
                                          int m0, int n0, int M, int K,
                                          int (&acc)[TM][4]) {
  constexpr int BM = 16 * TM;
  __shared__ int xs[BM][kKW + 1];
  __shared__ int ws[kBN][kKW + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k_words = K / 4;
  const int* xw = reinterpret_cast<const int*>(x);
  // weight loads: thread -> 4 K words starting at wq_row of column c4
  const int wq_row = (tid % 4) * 4;
  const int c4 = tid / 4;

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
#pragma unroll
    for (int j = 0; j < 4; ++j) ws[c4][wq_row + j] = wr[j];
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

template <int TM>
__global__ void __launch_bounds__(kThreads)
gemm_dp4a(const int8_t* __restrict__ x, KMajorInt8Weights wl,
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

}  // namespace i8gemm
