// Fused int8 + bf16 two-domain GEMM (the paper's Fig. 3 layer on a GPU
// tensor-core pair), for sm_90a.
//
// Replaces the Pallas TPU kernel `split_precision_matmul` (src/repro/
// kernels/split_precision.py).  Output columns below `boundary` (the
// wrapper passes it already rounded up to the ops' N-block) are the w8a8
// contraction f32(x_q @ w_q) * sx * sw[n], exact in int32, with w_q the
// K-major (N, K) codes the layers hold; columns at or above it are x_bf16
// @ w_bf16, products of two bf16 values (exact in f32) summed in f32, with
// w_bf16 (K, N) row-major.  One launch writes the one f32 output: no
// gather, no concat.  Two mainloops, split on M:
//
//   M <= 16 (decode, M = batch): bound by the weight stream (int8 below
//     the boundary, bf16 above).  The decode GEMM of int8_gemv.cuh
//     (`SplitPrecision`): mma.sync int8 products on the int8 columns,
//     fmaf on CUDA cores on the bf16 ones (8-byte loads of 4 bf16
//     columns), each lane summing its K rows in ascending order, then a
//     shuffle butterfly over 8 lanes, the warps of the block and the
//     blocks of the cluster in order.
//   M > 16 (prefill): bound by operations.  The wgmma GEMM of
//     int8_wgmma.cuh (`PrecisionCodes`, 128 x 128 tiles, 64 K per stage):
//     int8 wgmma on TMA tiles of the K-major codes for column tiles below
//     the boundary, bf16 wgmma (f32 accumulators, an order of summation
//     of the tensor cores' own within each 16-wide K step, steps in
//     ascending K) on TMA tiles of x_bf16 and w_bf16 (MN-major, the
//     transpose bit set) for tiles at or above it, both for the tile the
//     boundary falls in.  K is split over the `split` blocks of a cluster
//     (1 to 8; the wrapper's `wgmma_split` takes up to 4: at M 512 x N 512
//     the 16 tiles would leave 116 of 132 SMs idle), whose partial tiles
//     are summed through distributed shared memory, ranks in order.  N is
//     a multiple of 16 here (TMA row strides), which the wrapper pads.
//
// Either way the epilogue picks per column, so any boundary is exact and
// the result does not depend on the tile width; w_q is read only for
// column tiles (at decode: columns) below the boundary and w_bf16 only for
// those at or above it.  The int8 columns are bit-identical to the plain
// version, the bf16 columns within its float32 summation bound.
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_gemv.cuh"
#include "int8_wgmma.cuh"

// x_bf16 (M, K) bf16, x_q (M, K) int8, both row-major; w_bf16 (K, N) bf16
// row-major; w_q the K-major codes (N, K) int8; K a multiple of 16, N of 4
// (of 16 at M > 16), all 16-byte aligned; sx (1,) f32, sw (N,) f32 -> out
// (M, N) f32; bn, split: the decode GEMM's plan at M <= 16, the K split
// of the wgmma GEMM above (bn unused).
extern "C" int split_precision_launch(const void* x_bf16, const void* x_q,
                                      const void* w_bf16, const void* w_q,
                                      const void* sx, const void* sw,
                                      void* out, int M, int N, int K,
                                      int boundary, int bn, int split,
                                      void* stream) {
  const auto xb = static_cast<const uint16_t*>(x_bf16);
  const auto xq = static_cast<const int8_t*>(x_q);
  const auto wb = static_cast<const uint16_t*>(w_bf16);
  const auto wq = static_cast<const int8_t*>(w_q);
  const auto sxp = static_cast<const float*>(sx);
  const auto swp = static_cast<const float*>(sw);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (K % 16 || N % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 16) {
    const i8gemv::SplitPrecision src{{wq, K, boundary < N ? boundary : N},
                                     wb, N, boundary};
    return i8gemv::launch(xq, xb, src, sxp, swp, o, M, N, K, bn, split, st);
  }
  if (N % 16) return static_cast<int>(cudaErrorInvalidValue);
  i8wgmma::PrecisionCodes src;
  src.boundary = boundary;
  using T = i8wgmma::Tile<128, i8wgmma::PrecisionCodes>;
  int rc = i8wgmma::codes_map(&src.codes, wq, N, K, 128, T::BK);
  if (!rc) rc = i8wgmma::bf16_maps(&src, xb, wb, M, N, K, T::BK);
  if (rc) return rc;
  return i8wgmma::launch<128>(xq, src, sxp, swp, o, M, N, K, st, split);
}

extern "C" const char* split_precision_error_string(int code) {
  return hopper::error_string(code);
}
