// w8a8 GEMM with int32 accumulation and per-column dequant, for sm_90a:
//
//     out[m, n] = (float)(sum_k x[m, k] * w[k, n]) * sx * sw[n]
//
// Replaces the Pallas TPU kernel `quant_matmul` (src/repro/kernels/
// quant_matmul.py).  The weight arrives K-major, as the (N, K) int8 tensor
// whose transposed view the layers hold (x (M, K) row-major; K a multiple
// of 16, which the wrapper pads).  Two mainloops, split on M:
//
//   M <= 16 (decode, M = batch): bound by the weight bytes.  The decode
//     GEMM of int8_gemv.cuh (`KMajorCodes`): 16-byte loads along each
//     column's K run, 4 KB in flight per warp, the K
//     slices of a column tile spread over the blocks of a cluster, which
//     sum their int32 partials through distributed shared memory, and
//     mma.sync int8 products (the weights as operand A).
//   M > 16 (prefill, M = batch * prompt): bound by int8 operations.  The
//     int8 wgmma GEMM of int8_wgmma.cuh (128 x BN output tiles, a 4-stage
//     TMA ring, two consumer warpgroups) with its B tiles loaded by TMA
//     from the K-major codes (`Int8Codes`).
//
// Both mainloops end in the same epilogue, int8_gemm.cuh's `dequant`:
// f32(acc) * sx, then * sw[n], never fused, stores masked at M and N; the
// output is bit-identical to the plain version.
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_gemm.cuh"
#include "int8_gemv.cuh"
#include "int8_wgmma.cuh"

// x_q (M, K) int8 row-major, w_q the K-major weight (N, K) int8, both with
// K a multiple of 16 and 16-byte-aligned rows; sx one f32, sw (N,) f32;
// out (M, N) f32; bn, split: the decode GEMM's plan (M <= 16 only).
extern "C" int quant_matmul_launch(const void* x_q, const void* w_q,
                                   const void* sx, const void* sw, void* out,
                                   int M, int N, int K, int bn, int split,
                                   void* stream) {
  const int8_t* x = static_cast<const int8_t*>(x_q);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 16)
    return i8gemv::launch(x, nullptr, i8gemv::KMajorCodes{w, K, N}, sxp, swp,
                          o, M, N, K, bn, split, st);
  return i8wgmma::launch_codes(x, w, sxp, swp, o, M, N, K, st);
}

extern "C" const char* quant_matmul_error_string(int code) {
  return hopper::error_string(code);
}
