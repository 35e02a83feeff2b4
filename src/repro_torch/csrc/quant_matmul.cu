// w8a8 GEMM with int32 accumulation and per-column dequant, for sm_90a.
//
// Replaces the Pallas TPU kernel `quant_matmul` (src/repro/kernels/
// quant_matmul.py).  Bound: at decode (M = batch) by the int8 weight
// stream (bytes), at prefill (M = batch * prompt) by int8 operations.  The
// design streams each weight byte once per 16- or 64-row tile of x through
// shared memory and contracts with __dp4a (see int8_gemm.cuh); tensor-core
// mma/wgmma is later work.
#include "int8_gemm.cuh"

extern "C" int quant_matmul_launch(const void* x_q, const void* w_q,
                                   const void* sx, const void* sw, void* out,
                                   int M, int N, int K, void* stream) {
  i8gemm::Int8Weights wl{static_cast<const int8_t*>(w_q), N, K / 4};
  return i8gemm::launch(static_cast<const int8_t*>(x_q), wl,
                        static_cast<const float*>(sx),
                        static_cast<const float*>(sw),
                        static_cast<float*>(out), M, N, K,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
