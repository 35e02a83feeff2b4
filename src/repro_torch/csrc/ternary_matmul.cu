// Ternary-weight GEMM (the DIANA AIMC-domain layer), for sm_90a.
//
// Replaces the Pallas TPU kernel `ternary_matmul` (src/repro/kernels/
// ternary_matmul.py): the w8a8 contraction of int8 activations with weight
// codes in {-1, 0, +1} stored as int8, exact int32 accumulation, then the
// epilogue f32(acc) * sx * sw[n].  The codes arrive K-major, as the (N, K)
// int8 tensor whose transposed view the layers hold (K a multiple of 16,
// which the wrapper pads).  Two mainloops, split on M:
//
//   M <= 16 (decode, M = batch): bound by the int8 code stream (bytes).
//     The decode GEMM of int8_gemv.cuh (`KMajorCodes`), as quant_matmul's.
//   M > 16 (prefill): the int8 wgmma GEMM of int8_wgmma.cuh on TMA tiles
//     of the K-major codes (`Int8Codes`), as quant_matmul's, with K split
//     over the blocks of a cluster: the served wk / wv shape (M 512, N
//     512) has 16 output tiles of 128 x 128 for 132 SMs, so the wrapper's
//     plan (`wgmma_split`) spreads each tile's K over up to 8 blocks,
//     whose int32 partials are summed through distributed shared memory.
//
// Both end in int8_gemm.cuh's `dequant` (f32(acc) * sx, then * sw[n],
// never fused): the output is bit-identical to the plain version.  The
// 2-bit-packed stream that would read 4x fewer bytes is split_ternary's
// and ternary_packed's.
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_gemv.cuh"
#include "int8_wgmma.cuh"

// x_q (M, K) int8 row-major, w_k the K-major codes (N, K) int8, both with K
// a multiple of 16 and 16-byte-aligned rows; sx one f32, sw (N,) f32
// (8-byte aligned); out (M, N) f32; bn, split: the decode GEMM's plan at M
// <= 16, the K split of the wgmma GEMM above (bn unused).
extern "C" int ternary_matmul_launch(const void* x_q, const void* w_k,
                                     const void* sx, const void* sw,
                                     void* out, int M, int N, int K, int bn,
                                     int split, void* stream) {
  const int8_t* x = static_cast<const int8_t*>(x_q);
  const int8_t* w = static_cast<const int8_t*>(w_k);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 16)
    return i8gemv::launch(x, nullptr, i8gemv::KMajorCodes{w, K, N}, sxp, swp,
                          o, M, N, K, bn, split, st);
  return i8wgmma::launch_codes(x, w, sxp, swp, o, M, N, K, st, split);
}

extern "C" const char* ternary_matmul_error_string(int code) {
  return hopper::error_string(code);
}
