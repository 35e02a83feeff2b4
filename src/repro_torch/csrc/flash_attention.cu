// Causal flash attention with online softmax and grouped-query heads, for
// sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py).  It computes that kernel's function, not its block
// structure: query head h reads KV head h / G (KV never repeated in
// memory), scores q k^T * D^-0.5 summed in f32, the causal mask
// kpos <= qpos with positions from 0, keys at kpos >= kv_end masked, the
// running max and denominator in f32, p rounded to bf16 for the PV product
// (the denominator sums the unrounded p), an f32 accumulator, and
// acc / max(l, 1e-30) stored as bf16.
//
// Bound: at the prefill shapes by bf16 tensor-core operations (4 * D flops
// per attended (query, key) pair against about 2 bytes of q and o per
// flop / D), not by bytes.  The design feeds Hopper's wgmma from a TMA
// ring, so that loads overlap the products (hopper.cuh):
//   - one block of three warpgroups per (b, h, 128 query rows): consumer
//     warpgroups 0 and 1 own 64 rows each, one thread of warpgroup 2 (the
//     producer, which gives its registers to the consumers by setmaxnreg)
//     issues every TMA load;
//   - Q comes in once; K and V tiles of 128 keys pass through a ring of 2
//     stages guarded by full / empty mbarriers.  The tensor maps take
//     their S extent from kv_end, so TMA zero-fills the keys past it, and
//     order the (s, h, b) dimensions by stride, so the model's (B, S, H,
//     D) layout is read through its transposed views without a copy.
//     Rows of D = 128 split into two 64-column chunks with a 128-byte
//     swizzle, rows of D = 16 take a 32-byte swizzle;
//   - S = Q K^T runs on wgmma m64n128k16 bf16 -> f32, A (Q) and B (K) from
//     shared memory, both K-major as stored; the softmax runs on the S
//     accumulator in registers, in the log2 domain (exp2f of scores
//     pre-scaled by D^-0.5 * log2 e), each row's max and sum reduced over
//     the 4 lanes of a quad;
//   - O += P V runs on wgmma m64nDk16 with A = P in registers (the S
//     accumulator rounded to bf16, register for register the A fragment)
//     and B = the V tile, MN-major, read with the transpose bit;
//   - the G query heads of one KV head take adjacent blocks, so their K /
//     V tiles hit in L2, and causal query tiles launch heaviest first;
//   - key tiles wholly above the diagonal or past kv_end are never loaded;
//     the mask is evaluated only on tiles that cross the diagonal or
//     kv_end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;        // query rows per block
constexpr int kBK = 128;        // keys per K / V tile
constexpr int kStages = 2;      // depth of the K / V ring
constexpr int kThreads = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256;

template <int D>
struct Tile {
  static constexpr int kSw = D >= 64 ? 128 : 2 * D;  // swizzle = row bytes
  static constexpr int kCols = kSw / 2;              // bf16 per chunk row
  static constexpr int kChunks = D / kCols;
  static constexpr int kLayout =
      kSw == 128 ? hopper::kSwizzle128 : hopper::kSwizzle32;
  static constexpr CUtensorMapSwizzle kMapSwizzle =
      kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kKVBytes;
  static constexpr int kSmem = kBarOffset + 64 + 1024;  // + align slack
};

struct Params {
  __nv_bfloat16* o;
  int B, H, KVH, G, Sq, kv_end, causal, n_qtiles;
  long long o_b, o_h, o_s;
  // position (1..3) of the (s, h, b) coordinates in each tensor map
  int qpos[3], kpos[3], vpos[3];
  float scale_log2;  // D^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ int coord(int which, const int (&pos)[3], int s,
                                     int h, int b) {
  return pos[0] == which ? s : pos[1] == which ? h : b;
}

// One TMA box (kCols columns from `col` of rows from `s`) of head h,
// batch b.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, const int (&pos)[3],
                                         int col, int s, int h, int b) {
  hopper::tma_load_4d(dst, map, bar, col, coord(1, pos, s, h, b),
                      coord(2, pos, s, h, b), coord(3, pos, s, h, b));
}

template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128)
    hopper::mma_bf16_m64n128k16_rs_tb(o, a, db, 1);
  else
    hopper::mma_bf16_m64n16k16_rs_tb(o, a, db, 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ Params p) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* kv = smem + T::kQBytes;  // stage s: K at kv + 2 s kKVBytes, V after
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // block -> (query tile, batch, KV head, query head of the group)
  int idx = blockIdx.x;
  const int g = idx % p.G;
  idx /= p.G;
  const int kvh = idx % p.KVH;
  idx /= p.KVH;
  const int b = idx % p.B;
  idx /= p.B;
  const int qt = p.causal ? p.n_qtiles - 1 - idx : idx;
  const int h = kvh * p.G + g;
  const int q0 = qt * kBQ;
  int kv_stop = p.kv_end;
  if (p.causal) kv_stop = min(kv_stop, q0 + kBQ);
  const int n_tiles = (kv_stop + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 2 * 128) {
      hopper::mbar_expect_tx(qbar, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        load_box(qs + c * kBQ * T::kSw, &qmap, qbar, p.qpos, c * T::kCols,
                 q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          hopper::mbar_wait(&empty[s], (t / kStages - 1) & 1);
        uint8_t* kd = kv + s * 2 * T::kKVBytes;
        uint8_t* vd = kd + T::kKVBytes;
        hopper::mbar_expect_tx(&full[s], 2 * T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          load_box(kd + c * kBK * T::kSw, &kmap, &full[s], p.kpos,
                   c * T::kCols, t * kBK, kvh, b);
          load_box(vd + c * kBK * T::kSw, &vmap, &full[s], p.vpos,
                   c * T::kCols, t * kBK, kvh, b);
        }
      }
    }
    return;
  }

  // consumers
  hopper::reg_alloc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r_lo = q0 + wg * 64;  // first query row of this warpgroup
  const int row[2] = {r_lo + warp * 16 + lane / 4,
                      r_lo + warp * 16 + lane / 4 + 8};
  const uint8_t* qw = qs + wg * 64 * T::kSw;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's partial sums

  hopper::mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const uint8_t* kd = kv + s * 2 * T::kKVBytes;
    const uint8_t* vd = kd + T::kKVBytes;

    // S = Q K^T: sc[4 j + i] is row row[i / 2], key k0 + 8 j + 2 (lane %
    // 4) + i % 2
    float sc[kBK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / T::kCols, off = (kk * 16 % T::kCols) * 2;
      const uint64_t da = hopper::make_desc(qw + c * kBQ * T::kSw + off, 16,
                                            8 * T::kSw, T::kLayout);
      const uint64_t db = hopper::make_desc(kd + c * kBK * T::kSw + off, 16,
                                            8 * T::kSw, T::kLayout);
      hopper::mma_bf16_m64n128k16_ss(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);

    const int k0 = t * kBK;
    const bool edge =
        k0 + kBK > p.kv_end || (p.causal && k0 + kBK - 1 > r_lo);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      float v = sc[i] * p.scale_log2;
      if (edge) {
        const int key = k0 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
        const bool ok =
            key < p.kv_end && (!p.causal || key <= row[(i >> 1) & 1]);
        v = ok ? v : -INFINITY;
      }
      sc[i] = v;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      sc[i] = exp2f(sc[i] - base[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V: P's A fragment for keys 16 kk .. 16 kk + 15 is sc[8 kk ..
    // 8 kk + 7] rounded to bf16
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      mma_pv<D>(o, pa[kk],
                hopper::make_desc(vd + kk * 16 * T::kSw, kBK * T::kSw,
                                  8 * T::kSw, T::kLayout));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
    hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
  __nv_bfloat16* ob = p.o + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Sq) continue;
    __nv_bfloat16* orow = ob + row[r] * p.o_s + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) = pack_bf16(
          o[4 * j + 2 * r] / l_run[r], o[4 * j + 2 * r + 1] / l_run[r]);
  }
}

// Tensor map of a bf16 (batch, heads, rows, D) operand with unit stride in
// D: D innermost in boxes of kCols columns, then the (rows, heads, batch)
// dimensions of more than one element ordered by stride, those of one
// element outermost; a box spans `box_rows` rows of one head.  pos[i]
// receives the map position of rows (i = 0), heads (1) and batch (2).
template <int D>
int encode_operand(CUtensorMap* map, const void* base, long long rows,
                   long long s_rows, long long heads, long long s_heads,
                   long long batch, long long s_batch, int box_rows,
                   int (&pos)[3]) {
  using T = Tile<D>;
  struct Dim {
    long long n, stride;
    int which;
    uint32_t box;
  } dims[3] = {{rows, s_rows, 0, static_cast<uint32_t>(box_rows)},
               {heads, s_heads, 1, 1},
               {batch, s_batch, 2, 1}};
  // insertion sort: dimensions of one element last, the others by stride
  auto before = [](const Dim& a, const Dim& b) {
    if ((a.n == 1) != (b.n == 1)) return b.n == 1;
    return a.n != 1 && a.stride < b.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(dims[j], dims[j - 1]); --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  uint64_t gdim[4] = {static_cast<uint64_t>(D)};
  uint64_t gstride[3];
  uint32_t box[4] = {static_cast<uint32_t>(T::kCols)};
  long long extent = D;  // elements spanned so far, for one-element dims
  for (int i = 0; i < 3; ++i) {
    const long long stride = dims[i].n == 1 ? extent : dims[i].stride;
    gdim[i + 1] = static_cast<uint64_t>(dims[i].n);
    gstride[i] = static_cast<uint64_t>(stride) * 2;
    box[i + 1] = dims[i].box;
    pos[dims[i].which] = i + 1;
    extent = stride * dims[i].n;
  }
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                            gdim, gstride, box, T::kMapSwizzle);
}

template <int D>
int launch(const void* q, const void* k, const void* v, Params& p,
           long long Sq, long long kv_end, long long q_b, long long q_h,
           long long q_s, long long k_b, long long k_h, long long k_s,
           long long v_b, long long v_h, long long v_s, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int rc = encode_operand<D>(&qm, q, Sq, q_s, p.H, q_h, p.B, q_b, kBQ, p.qpos);
  if (!rc)
    rc = encode_operand<D>(&km, k, kv_end, k_s, p.KVH, k_h, p.B, k_b, kBK,
                           p.kpos);
  if (!rc)
    rc = encode_operand<D>(&vm, v, kv_end, v_s, p.KVH, v_h, p.B, v_b, kBK,
                           p.vpos);
  if (rc) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<D>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned grid = static_cast<unsigned>(p.n_qtiles) * p.B * p.H;
  flash_fwd<D><<<grid, kThreads, Tile<D>::kSmem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KVH, int Sq, int kv_end, int D, long long q_b, long long q_h,
    long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b,
    long long o_h, long long o_s, int causal, void* stream) {
  Params p{};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.G = H / KVH;
  p.Sq = Sq;
  p.kv_end = kv_end;
  p.causal = causal;
  p.n_qtiles = (Sq + kBQ - 1) / kBQ;
  p.o_b = o_b;
  p.o_h = o_h;
  p.o_s = o_s;
  p.scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(double(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, p, Sq, kv_end, q_b, q_h, q_s, k_b, k_h, k_s,
                        v_b, v_h, v_s, s);
    case 128:
      return launch<128>(q, k, v, p, Sq, kv_end, q_b, q_h, q_s, k_b, k_h,
                         k_s, v_b, v_h, v_s, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return hopper::error_string(code);
}
