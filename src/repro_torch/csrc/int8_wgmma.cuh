// The int8 tensor-core GEMM of the port's w8a8 kernels at M > 16, for
// sm_90a:
//
//     out[m, n] = (float)(sum_k x[m, k] * w[k, n]) * sx * sw[n]
//
// shared by quant_matmul.cu, ternary_matmul.cu, split_ternary.cu,
// ternary_packed.cu and split_precision.cu, which differ only in how the
// weight (B) tile of a stage is filled, the `Src` template parameter:
//
//   Int8Codes     TMA of BN rows x 128 K-bytes of the K-major (N, K) int8
//                 codes (quant_matmul and ternary_matmul, `launch_codes`;
//                 split_ternary's column tiles entirely below the
//                 boundary);
//   PackedCodes   TMA of 32 rows x BN columns of the row-major (K/4, N)
//                 2-bit stream, as it is stored (4 KB per stage at BN 128
//                 against 16 KB of int8 codes), unpacked in shared memory
//                 into the K-major B tile (ternary_packed; split_ternary's
//                 column tiles entirely at or above the boundary);
//   SplitCodes    per column tile one of the two above, or, for the tile
//                 the boundary falls in, both: the int8 tile by TMA, then
//                 its columns at or above the boundary overwritten by the
//                 unpacked codes (split_ternary);
//   PrecisionCodes columns below the boundary int8 as Int8Codes, the rest
//                 bf16: TMA of the x_bf16 tile (K-major) and of the
//                 w_bf16 (K, N) tile as it is stored (MN-major), into bf16
//                 wgmma m64n128k16 with the transpose bit on B and f32
//                 accumulators; a column tile runs the int8 products, the
//                 bf16 ones, or, where the boundary falls in it, both,
//                 and the epilogue picks per column (split_precision).
//                 64 K per stage (int8 tiles in the 64-byte swizzle), so
//                 that 4 stages of both fit.
//
// A block of three warpgroups computes a 128 x BN output tile (BN = 128 or
// 256 for Int8Codes, picked per shape for the fewest waves of 132 SMs; 128
// for the packed sources):
//   - thread 0 of warpgroup 2, the producer, which gives its registers to
//     the consumers by setmaxnreg, keeps a ring of 4 stages of 128 K-bytes
//     (64 for PrecisionCodes) full by TMA: the x tile (128 rows, 128-byte
//     swizzle), and the int8 B tile, the packed tile and / or the two bf16
//     tiles of the block's fill, all completing on the stage's `full`
//     barrier;
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
//     blocks share x and weight tiles in L2;
//   - the consumers stage the block's BN steps sw[n] in shared memory
//     while the first stage loads, so the epilogue reads sw from shared
//     memory, not through a chain of global round trips.
// Rows past M and N, and bytes past K, arrive as zeros from TMA; a packed
// zero byte decodes to -1, which meets only zero activations (K) or
// masked outputs (N).  A launch may split K over the blocks of a cluster
// (`ksplit`, 1 to 8, chosen by the wrapper: split_precision's and
// ternary_matmul's plans, kernels/split_precision.py `wgmma_split`; 1 for
// the others): each sums its stages, and the cluster adds the partial
// tiles through distributed shared memory (`split_epilogue`).  int32
// accumulation is exact (|acc| <= 127 * 127 * K) in any order, and the
// epilogue is int8_gemm.cuh's `dequant` (f32(acc) * sx, then * sw[n],
// never fused), so the int8 output is bit-identical to the plain
// versions.  bf16 columns: each wgmma sums its 16 products in f32 in an
// order of its own, into accumulators carried over K in ascending stages
// (with split-K: per slice, then the slices in order) -- another order
// than the plain version's, within its float32 summation bound.
#pragma once

#include <cooperative_groups.h>
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
constexpr int kHalfCols = 64;  // bf16 columns per 128-byte swizzle row
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256;
constexpr int kGroupM = 8;     // row tiles per group of the block order
// setmaxnreg budgets: 128 * 40 + 256 * 232 <= 384 * 168 (the launch's)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barrier of the two consumer warpgroups (0 is __syncthreads)
constexpr int kConsumerBarrier = 1;

// How a block fills the B tiles of its column tile (flags).
enum Fill { kInt8 = 1, kUnpack = 2, kBoth = kInt8 | kUnpack, kBf16 = 4 };

// What a source has unless it says otherwise: 128 K-bytes per stage, 4
// stages, no bf16 tiles.
struct SrcDefaults {
  static constexpr bool kBf16Tiles = false;
  static constexpr int kStageK = kBK;
};

// K-major (N, K) int8 codes, read by TMA.
struct Int8Codes : SrcDefaults {
  static constexpr bool kPacked = false;
  CUtensorMap codes;

  __device__ Fill fill(int, int) const { return kInt8; }
  __device__ int first_unpacked(int) const { return 0; }
};

// The (ceil(K/4), N) 2-bit stream, unpacked in shared memory.
struct PackedCodes : SrcDefaults {
  static constexpr bool kPacked = true;
  CUtensorMap packed;

  __device__ Fill fill(int, int) const { return kUnpack; }
  __device__ int first_unpacked(int) const { return 0; }
};

// Columns below `boundary` from the int8 codes, the rest from the stream.
struct SplitCodes : SrcDefaults {
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

// Columns below `boundary` from the K-major int8 codes (64 K-bytes per
// stage), the rest bf16: x_bf16 (M, K) and w_bf16 (K, N) row-major.
struct PrecisionCodes {
  static constexpr bool kPacked = false;
  static constexpr bool kBf16Tiles = true;
  static constexpr int kStageK = 64;
  CUtensorMap codes;  // box 64 K-bytes x BN rows, 64-byte swizzle
  CUtensorMap xh;     // box 64 K x 128 rows of x_bf16, 128-byte swizzle
  CUtensorMap wh;     // box 64 columns x 64 K rows of w_bf16, 128-byte
  int boundary;

  __device__ Fill fill(int n0, int n_end) const {
    if (n_end <= boundary) return kInt8;
    return n0 >= boundary ? kBf16 : static_cast<Fill>(kInt8 | kBf16);
  }
  __device__ int first_unpacked(int) const { return 0; }
};

template <int BN, class Src>
struct Tile {
  static constexpr int BK = Src::kStageK;  // K values per stage
  static constexpr int kABytes = kBM * BK;
  static constexpr int kBBytes = BN * BK;
  static constexpr int kPBytes = Src::kPacked ? kPackedRows * BN : 0;
  // bf16 x tile (128 rows x BK) and w tile (BK rows x BN, as BN / 64
  // boxes of 64 columns), each row 128 bytes
  static constexpr int kXHBytes = Src::kBf16Tiles ? kBM * BK * 2 : 0;
  static constexpr int kWHBytes = Src::kBf16Tiles ? BK * BN * 2 : 0;
  static constexpr int kStageBytes =
      kABytes + kBBytes + kPBytes + kXHBytes + kWHBytes;
  static constexpr int kBarOffset = kStages * kStageBytes;
  // the block's BN steps sw[n0 ..], staged once for the epilogue
  static constexpr int kSwOffset = kBarOffset + 2 * kStages * 8;
  static constexpr int kSmem = kSwOffset + BN * 4 + 1024;
  // a split-K block's partial tile (int32, + f32 for bf16 tiles), written
  // over the ring once its stages are consumed; rows of BN + 8 words, so
  // the 8 rows of a warp's 32-byte row segments fall in distinct banks
  static constexpr int kPartialStride = BN + 8;
  static constexpr int kPartialBytes =
      kBM * kPartialStride * 4 * (Src::kBf16Tiles ? 2 : 1);
  static_assert(kPartialBytes <= kBarOffset, "partial tile overflows the ring");
  // wgmma layout type of the int8 tiles: one swizzle row is BK bytes
  static constexpr int kLayout =
      BK == 128 ? hopper::kSwizzle128 : hopper::kSwizzle64;
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

// The epilogue of a split-K block (consumer threads): its partial tile to
// shared memory, over the consumed ring (both warpgroups' products done
// first); after a cluster barrier, rank r sums rows [r, r + 1) * kBM /
// ksplit of the cluster's partials through distributed shared memory,
// ranks in order (int32: exact; f32: another order of the same sums),
// and writes them through the epilogue with the block's steps `sws`; a
// second barrier keeps every block's shared memory until all have read
// it.
template <int BN, class Src, class Acc, class HAcc>
__device__ __forceinline__ void split_epilogue(
    const Src& src, const Acc& acc, const HAcc& hacc, uint8_t* smem,
    const float* sws, float s, float* __restrict__ out, int M, int N,
    int m0, int n0, int rank, int ksplit) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int S = Tile<BN, Src>::kPartialStride;
  int* pi = reinterpret_cast<int*>(smem);
  float* pf = reinterpret_cast<float*>(smem + kBM * S * 4);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  hopper::named_barrier_sync(kConsumerBarrier, kConsumers);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg * 64 + warp * 16 + lane / 4 + 8 * r;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<int2*>(pi + row * S + col) =
          make_int2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      if constexpr (Src::kBf16Tiles)
        *reinterpret_cast<float2*>(pf + row * S + col) =
            make_float2(hacc[4 * j + 2 * r], hacc[4 * j + 2 * r + 1]);
    }
  }
  cluster.sync();
  const int r_lo = rank * kBM / ksplit, r_hi = (rank + 1) * kBM / ksplit;
  for (int e = threadIdx.x; e < (r_hi - r_lo) * (BN / 4); e += kConsumers) {
    const int row = r_lo + e / (BN / 4), col = 4 * (e % (BN / 4));
    const int m = m0 + row;
    if (m >= M) continue;
    int t[4] = {0, 0, 0, 0};
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < ksplit; ++q) {
      const int4 v = *cluster.map_shared_rank(
          reinterpret_cast<int4*>(pi + row * S + col), q);
      t[0] += v.x;
      t[1] += v.y;
      t[2] += v.z;
      t[3] += v.w;
      if constexpr (Src::kBf16Tiles) {
        const float4 h = *cluster.map_shared_rank(
            reinterpret_cast<float4*>(pf + row * S + col), q);
        f[0] += h.x;
        f[1] += h.y;
        f[2] += h.z;
        f[3] += h.w;
      }
    }
    float y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      bool half = false;  // a bf16 column (PrecisionCodes)
      if constexpr (Src::kBf16Tiles) half = n0 + col + c >= src.boundary;
      y[c] = half ? f[c] : i8gemm::dequant(t[c], s, sws[col + c]);
    }
    float* orow = out + static_cast<size_t>(m) * N + n0 + col;
    if (N % 4 == 0 && n0 + col + 3 < N) {
      *reinterpret_cast<float4*>(orow) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n0 + col + c < N) orow[c] = y[c];
    }
  }
  cluster.sync();
}

template <int BN, class Src>
__global__ void __launch_bounds__(kThreads, 1)
    igemm_wgmma(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ Src src,
                const float* __restrict__ sx, const float* __restrict__ sw,
                float* __restrict__ out, int M, int N, int K, int ksplit) {
  using T = Tile<BN, Src>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* empty = full + kStages;

  // block -> (output tile, K slice): the ksplit blocks of a tile form a
  // cluster, rank r taking stages [kt_lo, kt_lo + n_k); tiles ->
  // (row tile, column tile), row tiles fastest within groups
  const int tile = blockIdx.x / ksplit, rank = blockIdx.x % ksplit;
  const int n_m = (M + kBM - 1) / kBM, n_n = (N + BN - 1) / BN;
  const int per_group = kGroupM * n_n;
  const int group = tile / per_group;
  const int first_m = group * kGroupM;
  const int group_m = min(n_m - first_m, kGroupM);
  const int in_group = tile % per_group;
  const int m0 = (first_m + in_group % group_m) * kBM;
  const int n0 = (in_group / group_m) * BN;
  const int stages = (K + T::BK - 1) / T::BK;
  const int kt_lo = rank * stages / ksplit;
  const int n_k = (rank + 1) * stages / ksplit - kt_lo;
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
      const bool ints = fill & kBoth;
      const int bytes = (ints ? T::kABytes : 0) +
                        (fill & kInt8 ? T::kBBytes : 0) +
                        (fill & kUnpack ? T::kPBytes : 0) +
                        (fill & kBf16 ? T::kXHBytes + T::kWHBytes : 0);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          hopper::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        uint8_t* a = smem + s * T::kStageBytes;
        uint8_t* bt = a + T::kABytes;
        hopper::mbar_expect_tx(&full[s], bytes);
        const int k0 = (kt_lo + kt) * T::BK;
        if (ints) hopper::tma_load_2d(a, &xmap, &full[s], k0, m0);
        if constexpr (!std::is_same<Src, PackedCodes>::value) {
          if (fill & kInt8)
            hopper::tma_load_2d(bt, &src.codes, &full[s], k0, n0);
        }
        if constexpr (Src::kPacked) {
          if (fill & kUnpack)
            hopper::tma_load_2d(bt + T::kBBytes, &src.packed, &full[s], n0,
                                (kt_lo + kt) * kPackedRows);
        }
        if constexpr (Src::kBf16Tiles) {
          if (fill & kBf16) {
            uint8_t* xh = bt + T::kBBytes + T::kPBytes;
            uint8_t* wh = xh + T::kXHBytes;
            hopper::tma_load_2d(xh, &src.xh, &full[s], k0, m0);
#pragma unroll
            for (int c = 0; c < BN / kHalfCols; ++c)
              hopper::tma_load_2d(wh + c * T::BK * 128, &src.wh, &full[s],
                                  n0 + c * kHalfCols, k0);
          }
        }
      }
    }
    if (ksplit > 1) {  // the cluster's two barriers of the reduction
      __syncwarp();
      cooperative_groups::this_cluster().sync();
      cooperative_groups::this_cluster().sync();
    }
    return;
  }

  // consumers; the block's steps go to shared memory while the first
  // stage loads (the epilogue reads them after a consumer barrier)
  hopper::reg_alloc<kConsumerRegs>();
  float* sws = reinterpret_cast<float*>(smem + T::kSwOffset);
  for (int i = threadIdx.x; i < BN; i += kConsumers)
    sws[i] = n0 + i < N ? sw[n0 + i] : 0.f;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  // f32 accumulators of the bf16 columns (PrecisionCodes, BN 128)
  float hacc[Src::kBf16Tiles ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < (Src::kBf16Tiles ? BN / 2 : 1); ++i) hacc[i] = 0.f;
  const int lo = src.first_unpacked(n0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* a = smem + s * T::kStageBytes + wg * 64 * T::BK;
    uint8_t* b = smem + s * T::kStageBytes + T::kABytes;
    if constexpr (Src::kPacked) {
      if (fill & kUnpack) {  // block-uniform
        unpack_tile<BN>(b + T::kBBytes, b, lo, threadIdx.x);
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(kConsumerBarrier, kConsumers);
      }
    }
    hopper::wgmma_fence();
    if (fill & kBoth) {  // block-uniform
#pragma unroll
      for (int kk = 0; kk < T::BK / 32; ++kk)
        mma<BN>(acc,
                hopper::make_desc(a + kk * 32, 16, 8 * T::BK, T::kLayout),
                hopper::make_desc(b + kk * 32, 16, 8 * T::BK, T::kLayout));
    }
    if constexpr (Src::kBf16Tiles) {
      static_assert(BN == 128, "bf16 tiles run m64n128k16 only");
      if (fill & kBf16) {  // block-uniform
        // x_bf16: K-major, 128-byte rows; w_bf16: MN-major, BN / 64 boxes
        // of BK rows x 128 bytes (LBO: one box), transpose bit on B
        const uint8_t* xh = b + T::kBBytes + T::kPBytes + wg * 64 * 128;
        const uint8_t* wh = b + T::kBBytes + T::kPBytes + T::kXHBytes;
#pragma unroll
        for (int kk = 0; kk < T::BK / 16; ++kk)
          hopper::mma_bf16_m64n128k16_ss_tb(
              hacc,
              hopper::make_desc(xh + kk * 32, 16, 8 * 128,
                                hopper::kSwizzle128),
              hopper::make_desc(wh + kk * 16 * 128, T::BK * 128, 8 * 128,
                                hopper::kSwizzle128),
              1);
      }
    }
    hopper::wgmma_commit();
    // the previous stage's products are done: hand its tiles back
    hopper::wgmma_wait<1>();
    if (kt > 0) hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);
  hopper::fence_operands(hacc);

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const float s = *sx;
  if (ksplit > 1) {
    split_epilogue<BN, Src>(src, acc, hacc, smem, sws, s, out, M, N, m0, n0,
                            rank, ksplit);
    return;
  }
  hopper::named_barrier_sync(kConsumerBarrier, kConsumers);  // sws
  // output i of a column: int8 products dequantised, or a bf16 column's
  // f32 sum (PrecisionCodes at or above the boundary)
  auto value = [&](int i, int n, float swn) {
    if constexpr (Src::kBf16Tiles) {
      if (n >= src.boundary) return hacc[i];
    }
    return i8gemm::dequant(acc[i], s, swn);
  };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (m >= M) continue;
    float* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      const float2 sw2 = *reinterpret_cast<const float2*>(sws + n - n0);
      if (n + 1 < N && (N % 2) == 0) {
        *reinterpret_cast<float2*>(orow + n) =
            make_float2(value(4 * j + 2 * r, n, sw2.x),
                        value(4 * j + 2 * r + 1, n + 1, sw2.y));
      } else {
        if (n < N) orow[n] = value(4 * j + 2 * r, n, sw2.x);
        if (n + 1 < N) orow[n + 1] = value(4 * j + 2 * r + 1, n + 1, sw2.y);
      }
    }
  }
}

// ---------------------------------------------------------------- host --

// The tiled map of a row-major 2-D tensor (rows x cols elements, row
// stride `stride` bytes), box (box_cols x box_rows).
inline int map_2d(CUtensorMap* map, const void* base, int cols, int rows,
                  int stride, int box_cols, int box_rows,
                  CUtensorMapSwizzle swizzle,
                  CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_UINT8) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(stride)};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols),
                           static_cast<uint32_t>(box_rows)};
  return hopper::encode_map(map, dtype, 2, base, dims, strides, box,
                            swizzle);
}

// The swizzle of int8 tiles whose rows are `bk` bytes (128 or 64).
inline CUtensorMapSwizzle int8_swizzle(int bk) {
  return bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// Map of the K-major (N, K) codes, K a multiple of 16: BN rows x bk bytes.
inline int codes_map(CUtensorMap* map, const int8_t* w, int N, int K,
                     int bn, int bk = kBK) {
  return map_2d(map, w, K, N, K, bk, bn, int8_swizzle(bk));
}

// Maps of split_precision's bf16 operands (128-byte swizzle): x_bf16 (M,
// K) in boxes of 64 K x 128 rows, w_bf16 (K, N) in boxes of 64 columns x
// `bk` K rows; K and N multiples of 8.
inline int bf16_maps(PrecisionCodes* src, const void* xb, const void* wb,
                     int M, int N, int K, int bk) {
  const int rc = map_2d(&src->xh, xb, K, M, 2 * K, kHalfCols, kBM,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  return rc ? rc
            : map_2d(&src->wh, wb, N, K, 2 * N, kHalfCols, bk,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
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
// BN; returns a CUDA error or map-encoding code, 0 on success.  Internal
// linkage: every library keeps its own attribute static (int8_gemv.cuh).
namespace {

template <int BN, class Src>
int launch(const int8_t* x, const Src& src, const float* sx, const float* sw,
           float* out, int M, int N, int K, cudaStream_t stream,
           int ksplit = 1) {
  using T = Tile<BN, Src>;
  if (ksplit < 1 || ksplit > 8 || ksplit > (K + T::BK - 1) / T::BK)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm;
  int rc = map_2d(&xm, x, K, M, K, T::BK, kBM, int8_swizzle(T::BK));
  if (rc) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      igemm_wgmma<BN, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  if (ksplit == 1) {
    igemm_wgmma<BN, Src><<<static_cast<unsigned>(tiles), kThreads, T::kSmem,
                           stream>>>(xm, src, sx, sw, out, M, N, K, 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * ksplit));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = static_cast<unsigned>(ksplit);
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t lrc = cudaLaunchKernelEx(&cfg, igemm_wgmma<BN, Src>, xm,
                                             src, sx, sw, out, M, N, K,
                                             ksplit);
  const cudaError_t last = cudaGetLastError();  // also clears a refusal
  return static_cast<int>(lrc != cudaSuccess ? lrc : last);
}

template <int BN>
int launch_codes_bn(const int8_t* x, const int8_t* w, const float* sx,
                    const float* sw, float* out, int M, int N, int K,
                    cudaStream_t stream, int ksplit) {
  Int8Codes src;
  const int rc = codes_map(&src.codes, w, N, K, BN);
  if (rc) return rc;
  return launch<BN>(x, src, sx, sw, out, M, N, K, stream, ksplit);
}

// The GEMM on the K-major (N, K) int8 codes `w` (`Int8Codes`, rows
// 16-byte aligned), tiles of the width `pick_bn` gives, K split `ksplit`.
inline int launch_codes(const int8_t* x, const int8_t* w, const float* sx,
                        const float* sw, float* out, int M, int N, int K,
                        cudaStream_t stream, int ksplit = 1) {
  return pick_bn(M, N) == 256
             ? launch_codes_bn<256>(x, w, sx, sw, out, M, N, K, stream, ksplit)
             : launch_codes_bn<128>(x, w, sx, sw, out, M, N, K, stream,
                                    ksplit);
}

}  // namespace

}  // namespace i8wgmma
