// Fused int8 + 2-bit ternary two-domain GEMM (DIANA digital + AIMC
// pairing), for sm_90a.
//
// Replaces the Pallas TPU kernel `split_ternary_matmul` (src/repro/kernels/
// split_ternary.py).  Columns below `boundary` read int8 codes from w_q
// (K, N); columns at or above it read the 2-bit-packed stream w_packed
// (K/4, N) -- code c of K row 4k + c in bits 2c..2c+1 of byte [k, n],
// biased by +1 -- and never touch w_q.  A packed byte holds 4 consecutive
// K rows of one column, so it unpacks in registers into exactly one __dp4a
// operand; nothing is unpacked to global memory.  The selection is per
// column, so a 4-column group or a tile that straddles the boundary is
// still exact.  One int32 accumulator serves both domains; the epilogue is
// the quant_matmul one (acc -> f32, * sx, * sw[n]).
//
// Bound: at decode by the weight stream, whose ternary side is 4x smaller
// than int8 (bytes); at prefill by int8 operations (int8_gemm.cuh).
#include "int8_gemm.cuh"

namespace {

struct SplitWeights {
  i8gemm::Int8Weights q;                // int8 codes, columns < boundary
  i8gemm::PackedTernaryWeights packed;  // (K/4, N), columns >= boundary
  int boundary;

  __device__ __forceinline__ void load(int kw, int n, int (&c)[4]) const {
    if (n + 4 <= boundary) {  // int8 domain only
      q.load(kw, n, c);
      return;
    }
    int t[4];
    packed.load(kw, n, t);
    if (n >= boundary) {      // ternary domain only
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = t[j];
      return;
    }
    q.load(kw, n, c);         // the group straddles the boundary
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = (n + j < boundary) ? c[j] : t[j];
  }
};

}  // namespace

extern "C" int split_ternary_launch(const void* x_q, const void* w_q,
                                    const void* w_packed, const void* sx,
                                    const void* sw, void* out, int M, int N,
                                    int K, int boundary, void* stream) {
  SplitWeights wl{{static_cast<const int8_t*>(w_q), N, K / 4},
                  {static_cast<const uint8_t*>(w_packed), N, K / 4},
                  boundary};
  return i8gemm::launch(static_cast<const int8_t*>(x_q), wl,
                        static_cast<const float*>(sx),
                        static_cast<const float*>(sw),
                        static_cast<float*>(out), M, N, K,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* split_ternary_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
