// Shared pieces of the port's w8a8 kernels: the epilogue every int8 kernel
// ends in,
//
//     out[m, n] = (float)(sum_k x[m, k] * w[k, n]) * sx * sw[n]
//
// evaluated in exactly that order (int32 -> f32 round-to-nearest, then two
// f32 multiplies, never fused: `dequant`), so the f32 output is
// bit-identical to the plain PyTorch versions beside the wrappers; and
// `transpose4x4` and `unpack_ternary_word`, the byte shuffles of the 2-bit
// paths of int8_wgmma.cuh and int8_gemv.cuh.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace i8gemm {

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

// One packed byte -> one operand word of 4 int8 codes: byte j = code(j) -
// 1 in {-1, 0, 1}.
__device__ __forceinline__ int unpack_ternary_word(uint32_t b) {
  const uint32_t t = (b & 0x3u) | ((b & 0xCu) << 6) | ((b & 0x30u) << 12) |
                     ((b & 0xC0u) << 18);
  return static_cast<int>(__vsub4(t, 0x01010101u));
}

// The w8a8 epilogue of one output: f32(acc) * sx, then * sw[n].
__device__ __forceinline__ float dequant(int acc, float sx, float swn) {
  const float v = static_cast<float>(acc) * sx;
  return v * swn;
}

}  // namespace i8gemm
