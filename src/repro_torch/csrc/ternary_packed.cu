// Ternary GEMM on 2-bit-packed weights, for sm_90a.
//
// Replaces the Pallas TPU kernel `ternary_packed_matmul` (src/repro/
// kernels/ternary_packed.py): int8 activations x_q (M, K) against ternary
// codes packed 4 to a byte, w_packed (K/4, N) -- code c of K row 4k + c in
// bits 2c .. 2c+1 of byte [k, n], biased by +1 -- exact int32
// accumulation, then the epilogue f32(acc) * sx * sw[n].  It is the
// shared-memory-tiled __dp4a GEMM of int8_gemm.cuh with the packed loader
// that split_ternary.cu runs on its ternary columns: each packed byte (4
// consecutive K rows of one column) unpacks in registers into one dp4a
// operand, and nothing is unpacked to global memory.
//
// Bound: at decode (M = batch) by the weight stream, which is K/4 * N
// bytes, 4x fewer than ternary_matmul's int8 codes (bytes); at prefill by
// int8 operations.
#include "int8_gemm.cuh"

extern "C" int ternary_packed_launch(const void* x_q, const void* w_packed,
                                     const void* sx, const void* sw,
                                     void* out, int M, int N, int K,
                                     void* stream) {
  i8gemm::PackedTernaryWeights wl{static_cast<const uint8_t*>(w_packed), N,
                                  K / 4};
  return i8gemm::launch(static_cast<const int8_t*>(x_q), wl,
                        static_cast<const float*>(sx),
                        static_cast<const float*>(sw),
                        static_cast<float*>(out), M, N, K,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* ternary_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
