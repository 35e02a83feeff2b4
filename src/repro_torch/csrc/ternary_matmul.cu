// Ternary-weight GEMM (the DIANA AIMC-domain layer), for sm_90a.
//
// Replaces the Pallas TPU kernel `ternary_matmul` (src/repro/kernels/
// ternary_matmul.py): the w8a8 contraction of int8 activations with weight
// codes in {-1, 0, +1} stored as int8, exact int32 accumulation, then the
// epilogue f32(acc) * sx * sw[n].  Bound: at decode (M = batch) by the
// int8 code stream (bytes), at prefill by int8 operations.  The codes are
// int8 bytes like quant_matmul's, so the kernel is the shared-memory-tiled
// __dp4a GEMM of int8_gemm.cuh with the int8 loader; the 2-bit-packed
// stream that would read 4x fewer bytes is split_ternary's.
#include "int8_gemm.cuh"

extern "C" int ternary_matmul_launch(const void* x_q, const void* w_t,
                                     const void* sx, const void* sw,
                                     void* out, int M, int N, int K,
                                     void* stream) {
  i8gemm::Int8Weights wl{static_cast<const int8_t*>(w_t), N, K / 4};
  return i8gemm::launch(static_cast<const int8_t*>(x_q), wl,
                        static_cast<const float*>(sx),
                        static_cast<const float*>(sw),
                        static_cast<float*>(out), M, N, K,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* ternary_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
