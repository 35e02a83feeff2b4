// w8a8 GEMM with int32 accumulation and per-column dequant, for sm_90a:
//
//     out[m, n] = (float)(sum_k x[m, k] * w[k, n]) * sx * sw[n]
//
// Replaces the Pallas TPU kernel `quant_matmul` (src/repro/kernels/
// quant_matmul.py).  The weight arrives K-major, as the (N, K) int8 tensor
// whose transposed view the layers hold (x (M, K) row-major; K a multiple
// of 16, which the wrapper pads).  Two mainloops, split on M:
//
//   M <= 16 (decode, M = batch): bound by the weight bytes.  The __dp4a
//     GEMM of int8_gemm.cuh streams each weight byte once per 16-row tile
//     of x through shared memory, reading the K-major weight with one
//     16-byte load per 4 operands of one column (`KMajorInt8Weights`).
//   M > 16 (prefill, M = batch * prompt): bound by int8 operations.  A
//     block of three warpgroups computes a 128 x BN output tile (BN = 128
//     or 256, picked per shape for the fewest waves of 132 SMs) on Hopper's
//     int8 tensor cores (hopper.cuh):
//       - one thread of warpgroup 2 (the producer, which gives its
//         registers to the consumers by setmaxnreg) keeps a ring of 4
//         stages of 128 K-bytes full by TMA: the x tile (128 rows) and the
//         w tile (BN rows of (N, K)), both with a 128-byte swizzle; rows
//         past M and N and bytes past K arrive as zeros;
//       - consumer warpgroups 0 and 1 own 64 rows each and run wgmma
//         m64nBNk32 s8 x s8 -> s32 with both operands K-major from shared
//         memory, keeping one stage's products in flight while the next
//         stage's are issued; a stage is handed back to the producer once
//         its products are done;
//       - blocks walk the tiles in groups of 8 row tiles, so that
//         neighbouring blocks share x and w tiles in L2.
//     int32 accumulation is exact (|acc| <= 127 * 127 * K), so the order
//     of the products does not matter.
//
// Both mainloops end in the same epilogue, int8_gemm.cuh's `dequant`:
// f32(acc) * sx, then * sw[n], never fused, stores masked at M and N; the
// output is bit-identical to the plain version.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "int8_gemm.cuh"

namespace {

constexpr int kBM = 128;       // rows per block: two consumer warpgroups
constexpr int kBK = 128;       // K bytes per stage (one 128-byte swizzle row)
constexpr int kStages = 4;
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256;
constexpr int kGroupM = 8;     // row tiles per group of the block order

template <int BN>
struct Tile {
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + 2 * kStages * 8 + 1024;
};

template <int BN>
__device__ __forceinline__ void mma(int (&acc)[BN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (BN == 256)
    hopper::mma_s8_m64n256k32_ss(acc, da, db, 1);
  else
    hopper::mma_s8_m64n128k32_ss(acc, da, db, 1);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_wgmma(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap,
              const float* __restrict__ sx, const float* __restrict__ sw,
              float* __restrict__ out, int M, int N, int K) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* empty = full + kStages;

  // block -> (row tile, column tile), row tiles fastest within groups
  const int n_m = (M + kBM - 1) / kBM, n_n = (N + BN - 1) / BN;
  const int per_group = kGroupM * n_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kGroupM;
  const int group_m = min(n_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * kBM;
  const int n0 = (in_group / group_m) * BN;
  const int n_k = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 2 * 128) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          hopper::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        uint8_t* a = smem + s * T::kStageBytes;
        hopper::mbar_expect_tx(&full[s], T::kStageBytes);
        hopper::tma_load_2d(a, &xmap, &full[s], kt * kBK, m0);
        hopper::tma_load_2d(a + T::kABytes, &wmap, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  // consumers
  hopper::reg_alloc<232>();
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* a = smem + s * T::kStageBytes + wg * 64 * kBK;
    const uint8_t* b = smem + s * T::kStageBytes + T::kABytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      mma<BN>(acc,
              hopper::make_desc(a + kk * 32, 16, 8 * kBK,
                                hopper::kSwizzle128),
              hopper::make_desc(b + kk * 32, 16, 8 * kBK,
                                hopper::kSwizzle128));
    hopper::wgmma_commit();
    // the previous stage's products are done: hand its tiles back
    hopper::wgmma_wait<1>();
    if (kt > 0) hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const float s = *sx;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (m >= M) continue;
    float* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n + 1 < N && (N % 2) == 0) {
        const float2 sw2 = *reinterpret_cast<const float2*>(sw + n);
        *reinterpret_cast<float2*>(orow + n) =
            make_float2(i8gemm::dequant(acc[4 * j + 2 * r], s, sw2.x),
                        i8gemm::dequant(acc[4 * j + 2 * r + 1], s, sw2.y));
      } else {
        if (n < N) orow[n] = i8gemm::dequant(acc[4 * j + 2 * r], s, sw[n]);
        if (n + 1 < N)
          orow[n + 1] = i8gemm::dequant(acc[4 * j + 2 * r + 1], s, sw[n + 1]);
      }
    }
  }
}

// Waves of 132 SMs times tile width: the time of a shape in tile-columns.
long long cost(long long tiles, int bn) { return (tiles + 131) / 132 * bn; }

template <int BN>
int launch_wgmma(const int8_t* x, const int8_t* w, const float* sx,
                 const float* sw, float* out, int M, int N, int K,
                 cudaStream_t stream) {
  CUtensorMap xm, wm;
  const uint64_t xdim[2] = {static_cast<uint64_t>(K),
                            static_cast<uint64_t>(M)};
  const uint64_t wdim[2] = {static_cast<uint64_t>(K),
                            static_cast<uint64_t>(N)};
  const uint64_t stride[1] = {static_cast<uint64_t>(K)};
  const uint32_t xbox[2] = {kBK, kBM}, wbox[2] = {kBK, BN};
  int rc = hopper::encode_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdim,
                              stride, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc)
    rc = hopper::encode_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdim,
                            stride, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<BN>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  qmm_wgmma<BN><<<static_cast<unsigned>(tiles), kThreads, Tile<BN>::kSmem,
                  stream>>>(xm, wm, sx, sw, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_q (M, K) int8 row-major, w_q the K-major weight (N, K) int8, both with
// K a multiple of 16 and 16-byte-aligned rows; sx one f32, sw (N,) f32;
// out (M, N) f32.
extern "C" int quant_matmul_launch(const void* x_q, const void* w_q,
                                   const void* sx, const void* sw, void* out,
                                   int M, int N, int K, void* stream) {
  const int8_t* x = static_cast<const int8_t*>(x_q);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 16) {  // one 16-row tile of the dp4a GEMM
    const i8gemm::KMajorInt8Weights wl{w, N, K / 4};
    const unsigned grid = (N + i8gemm::kBN - 1) / i8gemm::kBN;
    i8gemm::gemm_dp4a<1><<<grid, i8gemm::kThreads, 0, st>>>(x, wl, sxp, swp,
                                                            o, M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  const long long m_tiles = (M + kBM - 1) / kBM;
  const bool wide = cost(m_tiles * ((N + 255) / 256), 256) <=
                    cost(m_tiles * ((N + 127) / 128), 128);
  return wide ? launch_wgmma<256>(x, w, sxp, swp, o, M, N, K, st)
              : launch_wgmma<128>(x, w, sxp, swp, o, M, N, K, st);
}

extern "C" const char* quant_matmul_error_string(int code) {
  return hopper::error_string(code);
}
