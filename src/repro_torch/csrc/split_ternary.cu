// Fused int8 + 2-bit ternary two-domain GEMM (DIANA digital + AIMC
// pairing), for sm_90a.
//
// Replaces the Pallas TPU kernel `split_ternary_matmul` (src/repro/kernels/
// split_ternary.py).  Columns below `boundary` read int8 codes from the
// K-major w_q (N, K) (the transposed view the layers hold; K a multiple of
// 16); columns at or above it read the 2-bit-packed stream w_packed
// (Kp, N) -- code c of K row 4k + c in bits 2c..2c+1 of byte [k, n],
// biased by +1 -- and never touch w_q.  The selection is per column, so
// any boundary is exact.  One int32 accumulator serves both domains; the
// epilogue is the quant_matmul one (acc -> f32, * sx, * sw[n]), so the
// output is bit-identical to the plain version.  Nothing is unpacked to
// global memory.  Two mainloops, split on M:
//
//   M <= 16 (decode, M = batch): bound by the weight stream, whose ternary
//     side is 4x smaller than int8 (bytes).  The decode GEMM of
//     int8_gemv.cuh (`SplitTernary`): per column, 16-byte loads of the
//     K-major codes below the boundary, or the packed bytes at or above it
//     (each unpacked in registers into one operand word), into mma.sync
//     int8 products; the K slices of a column tile spread over the blocks
//     of a cluster.
//   M > 16 (prefill): bound by int8 operations.  The int8 wgmma GEMM of
//     int8_wgmma.cuh (`SplitCodes`, 128 x 128 tiles): column tiles below
//     the boundary load their int8 B tiles by TMA, tiles above it load 32
//     packed rows per stage by TMA, which the consumer warpgroups unpack in
//     shared memory into the K-major B tile, and the tile the boundary
//     falls in does both, column by column.  No split-K.  N is a multiple
//     of 16 here (a TMA row stride of the packed stream), which the
//     wrapper pads.
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_gemv.cuh"
#include "int8_wgmma.cuh"

namespace {

template <int BN>
int launch_wgmma(const int8_t* x, const int8_t* w, const uint8_t* p,
                 const float* sx, const float* sw, float* out, int M, int N,
                 int K, int Kp, int boundary, cudaStream_t stream) {
  i8wgmma::SplitCodes src;
  src.boundary = boundary;
  int rc = i8wgmma::codes_map(&src.codes, w, N, K, BN);
  if (!rc) rc = i8wgmma::packed_map(&src.packed, p, N, Kp, BN);
  if (rc) return rc;
  return i8wgmma::launch<BN>(x, src, sx, sw, out, M, N, K, stream);
}

}  // namespace

// x_q (M, K) int8 row-major and w_q the K-major codes (N, K) int8, K a
// multiple of 16, rows 16-byte aligned; w_packed (Kp, N) uint8 row-major,
// Kp = ceil(K_true / 4) <= K / 4, N a multiple of 4 (of 16 at M > 16),
// 16-byte aligned; sx one f32, sw (N,) f32; out (M, N) f32; bn, split:
// the decode GEMM's plan (M <= 16 only).
extern "C" int split_ternary_launch(const void* x_q, const void* w_q,
                                    const void* w_packed, const void* sx,
                                    const void* sw, void* out, int M, int N,
                                    int K, int Kp, int boundary, int bn,
                                    int split, void* stream) {
  const int8_t* x = static_cast<const int8_t*>(x_q);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const uint8_t* p = static_cast<const uint8_t*>(w_packed);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 16 || N % 4 || 4 * Kp > K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 16) {
    const i8gemv::SplitTernary src{{w, K, boundary < N ? boundary : N},
                                   {p, N, Kp, boundary}, boundary};
    return i8gemv::launch(x, nullptr, src, sxp, swp, o, M, N, K, bn, split,
                          st);
  }
  if (N % 16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma<128>(x, w, p, sxp, swp, o, M, N, K, Kp, boundary, st);
}

extern "C" const char* split_ternary_error_string(int code) {
  return hopper::error_string(code);
}
