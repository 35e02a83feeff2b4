// The int8 tensor-core GEMM of the port's w8a8 kernels at M > 16, for
// sm_90a:
//
//     out[m, n] = (float)(sum_k x[m, k] * w[k, n]) * sx * sw[n]
//
// shared by quant_matmul.cu, split_ternary.cu and ternary_packed.cu, which
// differ only in how the weight (B) tile of a stage is filled, the `Src`
// template parameter:
//
//   Int8Codes     TMA of BN rows x 128 K-bytes of the K-major (N, K) int8
//                 codes (quant_matmul; split_ternary's column tiles
//                 entirely below the boundary);
//   PackedCodes   TMA of 32 rows x BN columns of the row-major (K/4, N)
//                 2-bit stream, as it is stored (4 KB per stage at BN 128
//                 against 16 KB of int8 codes), unpacked in shared memory
//                 into the K-major B tile (ternary_packed; split_ternary's
//                 column tiles entirely at or above the boundary);
//   SplitCodes    per column tile one of the two above, or, for the tile
//                 the boundary falls in, both: the int8 tile by TMA, then
//                 its columns at or above the boundary overwritten by the
//                 unpacked codes (split_ternary).
//
// A block of three warpgroups computes a 128 x BN output tile (BN = 128 or
// 256 for Int8Codes, picked per shape for the fewest waves of 132 SMs; 128
// for the packed sources):
//   - thread 0 of warpgroup 2, the producer, which gives its registers to
//     the consumers by setmaxnreg, keeps a ring of 4 stages of 128 K-bytes
//     full by TMA: the x tile (128 rows, 128-byte swizzle), and the int8 B
//     tile and / or the packed tile of the block's fill, all completing on
//     the stage's `full` barrier;
//   - consumer warpgroups 0 and 1 own 64 rows each and run wgmma
//     m64nBNk32 s8 x s8 -> s32 with both operands K-major from shared
//     memory, keeping one stage's products in flight while the next
//     stage's are issued; a stage goes back to the producer once its
//     products are done.  Where the stage holds a packed tile, the 256
//     consumer threads first unpack it into the stage's 128-byte-swizzled
//     K-major B tile (each packed byte -> 4 int8 codes of 4 consecutive K
//     rows of one column), while the tensor cores still run the previous
//     stage's products; each thread then issues
//     fence.proxy.async.shared::cta (wgmma reads through the async proxy)
//     and the two warpgroups meet at a named barrier before either issues
//     the stage's wgmma;
//   - blocks walk the tiles in groups of 8 row tiles, so that neighbouring
//     blocks share x and weight tiles in L2.
// Rows past M and N, and bytes past K, arrive as zeros from TMA; a packed
// zero byte decodes to -1, which meets only zero activations (K) or
// masked outputs (N).  No split-K: int32 accumulation is exact (|acc| <=
// 127 * 127 * K) in any order, and the epilogue is int8_gemm.cuh's
// `dequant` (f32(acc) * sx, then * sw[n], never fused), so the output is
// bit-identical to the plain versions.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "int8_gemm.cuh"

namespace i8wgmma {

constexpr int kBM = 128;       // rows per block: two consumer warpgroups
constexpr int kBK = 128;       // K bytes per stage (one 128-byte swizzle row)
constexpr int kPackedRows = kBK / 4;  // packed rows per stage
constexpr int kStages = 4;
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256;
constexpr int kGroupM = 8;     // row tiles per group of the block order
// setmaxnreg budgets: 128 * 40 + 256 * 232 <= 384 * 168 (the launch's)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barrier of the two consumer warpgroups (0 is __syncthreads)
constexpr int kConsumerBarrier = 1;

// How a block fills the B tiles of its column tile.
enum Fill { kInt8 = 0, kUnpack = 1, kBoth = 2 };

// K-major (N, K) int8 codes, read by TMA.
struct Int8Codes {
  static constexpr bool kPacked = false;
  CUtensorMap codes;

  __device__ Fill fill(int, int) const { return kInt8; }
  __device__ int first_unpacked(int) const { return 0; }
};

// The (ceil(K/4), N) 2-bit stream, unpacked in shared memory.
struct PackedCodes {
  static constexpr bool kPacked = true;
  CUtensorMap packed;

  __device__ Fill fill(int, int) const { return kUnpack; }
  __device__ int first_unpacked(int) const { return 0; }
};

// Columns below `boundary` from the int8 codes, the rest from the stream.
struct SplitCodes {
  static constexpr bool kPacked = true;
  CUtensorMap codes;
  CUtensorMap packed;
  int boundary;

  // n_end: the first column past the tile (clamped to N)
  __device__ Fill fill(int n0, int n_end) const {
    if (n_end <= boundary) return kInt8;
    return n0 >= boundary ? kUnpack : kBoth;
  }
  // first tile row (column n0 + row) that comes from the stream
  __device__ int first_unpacked(int n0) const {
    return boundary > n0 ? boundary - n0 : 0;
  }
};

template <int BN, class Src>
struct Tile {
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kPBytes = Src::kPacked ? kPackedRows * BN : 0;
  static constexpr int kStageBytes = kABytes + kBBytes + kPBytes;
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

// 4 biased 2-bit codes, one per byte (0, 1, 2, 3) -> int8 code - 1 per
// byte, without borrows between bytes.
__device__ __forceinline__ uint32_t decode4(uint32_t b) {
  return ((b | 0x80808080u) - 0x01010101u) ^ 0x80808080u;
}

// Consumer thread `u` (0 .. kConsumers - 1) writes its share of one stage's B
// tile (BN rows of 128 K-bytes, 128-byte swizzle: 16-byte chunk c of row
// r at chunk position c ^ (r % 8)) from the packed tile `p` (32 rows of BN
// bytes, row-major): tile rows >= `lo` only.  A unit is 4 columns x one
// 16-byte K chunk: 4 packed words (4 rows, 4 columns each) in, four
// 16-byte stores out.  A warp's 32 units share the chunk and take
// consecutive column groups, so its loads hit 32 banks; each unit rotates
// its 4 columns by (group / 2) % 4, so the 8 lanes of a quarter warp store
// to 8 rows of distinct r % 8, i.e. 8 distinct chunk positions.
template <int BN>
__device__ __forceinline__ void unpack_tile(const uint8_t* __restrict__ p,
                                            uint8_t* __restrict__ b,
                                            int lo, int u) {
  constexpr int kGroups = BN / 4;                // column groups
  constexpr int kUnits = kGroups * (kBK / 16);   // x 8 K chunks
  for (int unit = u; unit < kUnits; unit += kConsumers) {
    const int g = unit % kGroups, c = unit / kGroups;
    const int n = 4 * g;
    if (n + 4 <= lo) continue;
    const int rot = (g >> 1) & 3;
    uint32_t col[4][4];  // [column slot][K word of the chunk]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t w = *reinterpret_cast<const uint32_t*>(
          p + (4 * c + i) * BN + n);
      w = __funnelshift_r(w, w, 8 * rot);  // byte j: column (j + rot) % 4
      int t[4];
      i8gemm::transpose4x4(decode4(w & 0x03030303u),
                           decode4((w >> 2) & 0x03030303u),
                           decode4((w >> 4) & 0x03030303u),
                           decode4((w >> 6) & 0x03030303u), t);
#pragma unroll
      for (int j = 0; j < 4; ++j) col[j][i] = static_cast<uint32_t>(t[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = n + ((j + rot) & 3);
      if (r < lo) continue;
      *reinterpret_cast<uint4*>(b + r * kBK + ((c ^ (r & 7)) << 4)) =
          make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
    }
  }
}

template <int BN, class Src>
__global__ void __launch_bounds__(kThreads, 1)
    igemm_wgmma(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ Src src,
                const float* __restrict__ sx, const float* __restrict__ sw,
                float* __restrict__ out, int M, int N, int K) {
  using T = Tile<BN, Src>;
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
  const Fill fill = src.fill(n0, min(n0 + BN, N));

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
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      const int bytes = T::kABytes + (fill != kUnpack ? T::kBBytes : 0) +
                        (fill != kInt8 ? T::kPBytes : 0);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          hopper::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        uint8_t* a = smem + s * T::kStageBytes;
        uint8_t* bt = a + T::kABytes;
        hopper::mbar_expect_tx(&full[s], bytes);
        hopper::tma_load_2d(a, &xmap, &full[s], kt * kBK, m0);
        if constexpr (!std::is_same<Src, PackedCodes>::value) {
          if (fill != kUnpack)
            hopper::tma_load_2d(bt, &src.codes, &full[s], kt * kBK, n0);
        }
        if constexpr (Src::kPacked) {
          if (fill != kInt8)
            hopper::tma_load_2d(bt + T::kBBytes, &src.packed, &full[s], n0,
                                kt * kPackedRows);
        }
      }
    }
    return;
  }

  // consumers
  hopper::reg_alloc<kConsumerRegs>();
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int lo = src.first_unpacked(n0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* a = smem + s * T::kStageBytes + wg * 64 * kBK;
    uint8_t* b = smem + s * T::kStageBytes + T::kABytes;
    if constexpr (Src::kPacked) {
      if (fill != kInt8) {  // block-uniform
        unpack_tile<BN>(b + T::kBBytes, b, lo, threadIdx.x);
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(kConsumerBarrier, kConsumers);
      }
    }
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

// ---------------------------------------------------------------- host --

// The tiled map of a row-major 2-D uint8 tensor (rows x cols, row stride
// `stride` bytes), box (box_cols x box_rows).
inline int map_2d(CUtensorMap* map, const void* base, int cols, int rows,
                  int stride, int box_cols, int box_rows,
                  CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(stride)};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols),
                           static_cast<uint32_t>(box_rows)};
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base,
                            dims, strides, box, swizzle);
}

// Map of the K-major (N, K) codes, K a multiple of 16: BN rows x 128 bytes.
inline int codes_map(CUtensorMap* map, const int8_t* w, int N, int K,
                     int bn) {
  return map_2d(map, w, K, N, K, kBK, bn, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Map of the (Kp, N) packed stream, N a multiple of 16: 32 rows x BN bytes.
inline int packed_map(CUtensorMap* map, const uint8_t* p, int N, int Kp,
                      int bn) {
  return map_2d(map, p, N, Kp, N, bn, kPackedRows,
                CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Waves of 132 SMs times tile width: the time of a shape in tile-columns.
inline long long cost(long long tiles, int bn) {
  return (tiles + 131) / 132 * bn;
}

// The tile width with the fewest waves (ties to the wider tile).
inline int pick_bn(int M, int N) {
  const long long m_tiles = (M + kBM - 1) / kBM;
  return cost(m_tiles * ((N + 255) / 256), 256) <=
                 cost(m_tiles * ((N + 127) / 128), 128)
             ? 256
             : 128;
}

// Launches the GEMM of x (M, K) int8 row-major (K a multiple of 16, rows
// 16-byte aligned) against `src`, whose maps were encoded for tile width
// BN; returns a CUDA error or map-encoding code, 0 on success.
template <int BN, class Src>
int launch(const int8_t* x, const Src& src, const float* sx, const float* sw,
           float* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap xm;
  int rc = map_2d(&xm, x, K, M, K, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  using T = Tile<BN, Src>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      igemm_wgmma<BN, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  igemm_wgmma<BN, Src><<<static_cast<unsigned>(tiles), kThreads, T::kSmem,
                         stream>>>(xm, src, sx, sw, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8wgmma
