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
//   M > 16 (prefill): the shared-memory-tiled __dp4a GEMM of int8_gemm.cuh
//     (64-row tiles), one 16-byte load per 16 K bytes of a column.
//
// The 2-bit-packed stream that would read 4x fewer bytes is
// split_ternary's and ternary_packed's.
#include "int8_gemm.cuh"
#include "int8_gemv.cuh"

// x_q (M, K) int8 row-major, w_k the K-major codes (N, K) int8, both with K
// a multiple of 16 and 16-byte-aligned rows; sx one f32, sw (N,) f32; out
// (M, N) f32; bn, split: the decode GEMM's plan (M <= 16 only).
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
  const dim3 grid((N + i8gemm::kBN - 1) / i8gemm::kBN, (M + 63) / 64);
  i8gemm::gemm_dp4a<4><<<grid, i8gemm::kThreads, 0, st>>>(
      x, i8gemm::KMajorInt8Weights{w, N, K / 4}, sxp, swp, o, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ternary_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
