// Fused int8 + bf16 two-domain GEMM (the paper's Fig. 3 layer on a GPU
// tensor-core pair), for sm_90a.
//
// Replaces the Pallas TPU kernel `split_precision_matmul` (src/repro/
// kernels/split_precision.py).  Output columns below `boundary` (the
// wrapper passes it already rounded up to the ops' N-block) are the w8a8
// contraction f32(x_q @ w_q) * sx * sw[n], exact in int32 (__dp4a, the
// mainloop of int8_gemm.cuh); columns at or above it are x_bf16 @ w_bf16,
// products of two bf16 values (exact in f32) summed in f32 by fmaf, K in
// ascending order.  One launch writes the one f32 output: no gather, no
// concat.
//
// Each 64-column tile runs the int8 mainloop only if it holds a column
// below the boundary and the bf16 mainloop only if it holds one at or
// above it; a tile that straddles the boundary runs both and the epilogue
// picks per column, so the result does not depend on the tile width.
// Unlike the TPU kernel, whose BlockSpecs stream both weight blocks at
// every grid step, w_q is read only for 4-column groups that start below
// the boundary and w_bf16 only for 2-column pairs that reach it.
//
// Bound: at decode (M = batch) by the weight stream (int8 below the
// boundary, bf16 above: bytes), at prefill by operations.  The bf16 half
// runs on FMA units, not tensor cores (mma/wgmma is later work).
#include "int8_gemm.cuh"

namespace {

constexpr int kBKH = 32;  // bf16 K values per stage of the bf16 mainloop

// w_q read only for 4-column groups that start below the boundary.
struct LowInt8Weights {
  i8gemm::Int8Weights q;
  int boundary;

  __device__ __forceinline__ void load(int kw, int n, int (&c)[4]) const {
    if (n < boundary) {
      q.load(kw, n, c);
    } else {
      c[0] = c[1] = c[2] = c[3] = 0;
    }
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// f32 sum over all of K of the bf16 products of the output tile at
// (m0, n0), in the thread -> (row, column) layout of i8gemm::dp4a_tile.
// x (M, K) and w (K, N) bf16 row-major, read as bf16 pairs (K and N even);
// w pairs whose both columns lie below `boundary` are not read.
template <int TM>
__device__ __forceinline__ void bf16_tile(const uint32_t* __restrict__ xp,
                                          const uint32_t* __restrict__ wp,
                                          int m0, int n0, int M, int N,
                                          int K, int boundary,
                                          float (&acc)[TM][4]) {
  constexpr int BM = 16 * TM;
  constexpr int kPairs = kBKH / 2;  // x pairs per tile row and stage
  __shared__ float xs[BM][kBKH + 1];
  __shared__ float ws[kBKH][i8gemm::kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k_pairs = K / 2, n_pairs = N / 2;
  // weight loads: thread -> rows tid / 32 + 8 * j, column pair tid % 32
  const int w_row = tid / 32, w_col = 2 * (tid % 32);
  const int n = n0 + w_col;
  const bool w_read = n < N && n + 1 >= boundary;

  uint32_t xr[TM], wr[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int idx = tid + i8gemm::kThreads * i;  // BM * kPairs == 256 * TM
      const int m = m0 + idx / kPairs, kp = k0 / 2 + idx % kPairs;
      xr[i] = (m < M && kp < k_pairs)
                  ? __ldg(xp + static_cast<size_t>(m) * k_pairs + kp) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + w_row + 8 * j;
      wr[j] = (w_read && k < K)
                  ? __ldg(wp + static_cast<size_t>(k) * n_pairs + n / 2) : 0u;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int idx = tid + i8gemm::kThreads * i;
      const int r = idx / kPairs, q = 2 * (idx % kPairs);
      xs[r][q] = bf16_lo(xr[i]);
      xs[r][q + 1] = bf16_hi(xr[i]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ws[w_row + 8 * j][w_col] = bf16_lo(wr[j]);
      ws[w_row + 8 * j][w_col + 1] = bf16_hi(wr[j]);
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBKH) {
    stash();
    __syncthreads();
    if (k0 + kBKH < K) fetch(k0 + kBKH);
#pragma unroll
    for (int k = 0; k < kBKH; ++k) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int TM>
__global__ void __launch_bounds__(i8gemm::kThreads)
split_precision_kernel(const uint32_t* __restrict__ x_bf16,
                       const int8_t* __restrict__ x_q,
                       const uint32_t* __restrict__ w_bf16,
                       LowInt8Weights wl, const float* __restrict__ sx,
                       const float* __restrict__ sw, float* __restrict__ out,
                       int M, int N, int K, int boundary) {
  const int m0 = blockIdx.y * 16 * TM, n0 = blockIdx.x * i8gemm::kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int acc_i[TM][4] = {};
  float acc_f[TM][4] = {};
  if (n0 < boundary)  // block-uniform: the tile holds an int8 column
    i8gemm::dp4a_tile<TM>(x_q, wl, m0, n0, M, K, acc_i);
  if (n0 + i8gemm::kBN > boundary)  // ... and/or a bf16 column
    bf16_tile<TM>(x_bf16, w_bf16, m0, n0, M, N, K, boundary, acc_f);

  const float s = *sx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      out[static_cast<size_t>(m) * N + n] =
          n < boundary ? i8gemm::dequant(acc_i[i][j], s, sw[n])
                       : acc_f[i][j];
    }
  }
}

}  // namespace

// x_bf16 (M, K) bf16, x_q (M, K) int8, w_bf16 (K, N) bf16, w_q (K, N) int8,
// sx (1,) f32, sw (N,) f32 -> out (M, N) f32; K and N multiples of 4.
extern "C" int split_precision_launch(const void* x_bf16, const void* x_q,
                                      const void* w_bf16, const void* w_q,
                                      const void* sx, const void* sw,
                                      void* out, int M, int N, int K,
                                      int boundary, void* stream) {
  LowInt8Weights wl{{static_cast<const int8_t*>(w_q), N, K / 4}, boundary};
  const auto xb = static_cast<const uint32_t*>(x_bf16);
  const auto xq = static_cast<const int8_t*>(x_q);
  const auto wb = static_cast<const uint32_t*>(w_bf16);
  const auto sxp = static_cast<const float*>(sx);
  const auto swp = static_cast<const float*>(sw);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned gx = static_cast<unsigned>((N + i8gemm::kBN - 1) /
                                            i8gemm::kBN);
  if (M <= 16) {
    dim3 grid(gx, static_cast<unsigned>((M + 15) / 16));
    split_precision_kernel<1><<<grid, i8gemm::kThreads, 0, st>>>(
        xb, xq, wb, wl, sxp, swp, o, M, N, K, boundary);
  } else {
    dim3 grid(gx, static_cast<unsigned>((M + 63) / 64));
    split_precision_kernel<4><<<grid, i8gemm::kThreads, 0, st>>>(
        xb, xq, wb, wl, sxp, swp, o, M, N, K, boundary);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* split_precision_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
