// Ternary GEMM on 2-bit-packed weights, for sm_90a.
//
// Replaces the Pallas TPU kernel `ternary_packed_matmul` (src/repro/
// kernels/ternary_packed.py): int8 activations x_q (M, K) against ternary
// codes packed 4 to a byte, w_packed (Kp, N) -- code c of K row 4k + c in
// bits 2c .. 2c+1 of byte [k, n], biased by +1 -- exact int32
// accumulation, then the epilogue f32(acc) * sx * sw[n], bit-identical to
// the plain version.  Nothing is unpacked to global memory.  Two
// mainloops, split on M:
//
//   M <= 16 (decode, M = batch): bound by the weight stream, K/4 * N
//     bytes, 4x fewer than ternary_matmul's int8 codes.  The decode GEMM of
//     int8_gemv.cuh (`PackedStream`): each lane reads four packed rows of
//     two columns, unpacks each byte in registers into one operand word of
//     mma.sync int8 products; the K slices of a column tile spread over the
//     blocks of a cluster.
//   M > 16 (prefill): bound by int8 operations.  The int8 wgmma GEMM of
//     int8_wgmma.cuh (`PackedCodes`, 128 x 128 tiles): TMA loads 32 packed
//     rows x 128 columns per stage, the consumer warpgroups unpack them in
//     shared memory into the K-major B tile.  No split-K.  N is a multiple
//     of 16 here (the TMA row stride), which the wrapper pads.
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_gemv.cuh"
#include "int8_wgmma.cuh"

namespace {

template <int BN>
int launch_wgmma(const int8_t* x, const uint8_t* p, const float* sx,
                 const float* sw, float* out, int M, int N, int K, int Kp,
                 cudaStream_t stream) {
  i8wgmma::PackedCodes src;
  const int rc = i8wgmma::packed_map(&src.packed, p, N, Kp, BN);
  if (rc) return rc;
  return i8wgmma::launch<BN>(x, src, sx, sw, out, M, N, K, stream);
}

}  // namespace

// x_q (M, K) int8 row-major, K a multiple of 16, rows 16-byte aligned;
// w_packed (Kp, N) uint8 row-major, Kp = ceil(K_true / 4) <= K / 4, N a
// multiple of 4 (of 16 at M > 16), 16-byte aligned; sx one f32, sw (N,)
// f32; out (M, N) f32; bn, split: the decode GEMM's plan (M <= 16 only).
extern "C" int ternary_packed_launch(const void* x_q, const void* w_packed,
                                     const void* sx, const void* sw,
                                     void* out, int M, int N, int K, int Kp,
                                     int bn, int split, void* stream) {
  const int8_t* x = static_cast<const int8_t*>(x_q);
  const uint8_t* p = static_cast<const uint8_t*>(w_packed);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 16 || N % 4 || 4 * Kp > K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 16)
    return i8gemv::launch(x, nullptr, i8gemv::PackedStream{p, N, Kp, 0}, sxp,
                          swp, o, M, N, K, bn, split, st);
  if (N % 16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma<128>(x, p, sxp, swp, o, M, N, K, Kp, st);
}

extern "C" const char* ternary_packed_error_string(int code) {
  return hopper::error_string(code);
}
