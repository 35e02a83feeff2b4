// Causal flash attention with online softmax and grouped-query heads, for
// sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py).  It computes that kernel's function, not its block
// structure: query head h reads KV head h / G (KV never repeated in
// memory), scores q k^T * D^-0.5 summed in f32 (D the query / key head
// dim; the value head dim Dv may differ: MLA's 192 / 128), the causal mask
// kpos <= qpos with positions from 0, keys at kpos >= kv_end masked, the
// running max and denominator in f32, p rounded to bf16 for the PV product
// (the denominator sums the unrounded p), an f32 accumulator, and
// acc / max(l, 1e-30) stored as bf16.  A sliding window (window > 0) also
// masks keys at kpos <= qpos - window, as the JAX model's
// chunked_attention(window=) does (src/repro/models/attention.py); a row
// with no key left stores 0.
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
//     swizzle, rows of D = 64 are one such chunk, rows of D = 192 (MLA's
//     queries and keys, 128 nope + 64 rope) three, rows of D = 16 take a
//     32-byte swizzle; V tiles are laid out by their own width Dv, so
//     deepseek's 192 / 128 block holds Q 48 KiB + 2 x (K 48 + V 32) KiB
//     = 208 KiB, where a uniform 192 would need 240.  D = 120 (no multiple of wgmma's k16) is laid out
//     as D = 128: its maps have the real width 120, so TMA zero-fills
//     columns 120-127 of the second chunk, which adds 0 to QK^T and gives
//     PV's columns 120-127 zeros that the store leaves out (in the model
//     layout they are the next head's first columns);
//   - S = Q K^T runs on wgmma m64n128k16 bf16 -> f32, A (Q) and B (K) from
//     shared memory, both K-major as stored; the softmax runs on the S
//     accumulator in registers, in the log2 domain (exp2f of scores
//     pre-scaled by D^-0.5 * log2 e), each row's max and sum reduced over
//     the 4 lanes of a quad;
//   - O += P V runs on wgmma m64nDvk16 with A = P in registers (the S
//     accumulator rounded to bf16, register for register the A fragment)
//     and B = the V tile, MN-major, read with the transpose bit;
//   - the G query heads of one KV head take adjacent blocks, so their K /
//     V tiles hit in L2, and causal query tiles launch heaviest first;
//   - key tiles wholly above the diagonal, past kv_end or below the
//     window of every row of the query tile are never loaded (producer and
//     consumers start at the same first tile, max(0, q0 - window + 1) /
//     128, so the ring's stage and parity agree); the mask is evaluated
//     only on tiles that cross the diagonal, kv_end or the window's lower
//     edge.  The window is a template parameter: a call without one runs
//     an instantiation whose loop and mask are the causal / kv_end ones
//     alone.
//
// The (D, Dv, windowed) triples instantiated come from the build:
// FLASH_SHAPES is a list of X(D, Dv, windowed) that kernels/_build.py
// defines from kernels/flash_attention.py's SHAPES; another triple returns
// cudaErrorInvalidValue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

#ifndef FLASH_SHAPES
#error "FLASH_SHAPES (the X(D, Dv, windowed) list) is defined by the build"
#endif

namespace {

constexpr int kBQ = 128;        // query rows per block
constexpr int kBK = 128;        // keys per K / V tile
constexpr int kStages = 2;      // depth of the K / V ring
constexpr int kThreads = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256;

// The width a head dim is laid out with in shared memory: D = 120 as 128;
// 192 stays 192 (three 64-column chunks).
template <int D>
constexpr int kPadded = D > 128 ? D : D > 64 ? 128 : D;

template <int D>  // D: the padded width of one operand's rows
struct Rows {
  static constexpr int kSw = D >= 64 ? 128 : 2 * D;  // swizzle = row bytes
  static constexpr int kCols = kSw / 2;              // bf16 per chunk row
  static constexpr int kChunks = D / kCols;
  static constexpr int kLayout =
      kSw == 128 ? hopper::kSwizzle128 : hopper::kSwizzle32;
  static constexpr CUtensorMapSwizzle kMapSwizzle =
      kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
};

template <int DQ, int DV>  // the padded query / key and value widths
struct Tile {
  static constexpr int kQBytes = kBQ * DQ * 2;
  static constexpr int kKBytes = kBK * DQ * 2;  // one K tile
  static constexpr int kVBytes = kBK * DV * 2;  // one V tile
  static constexpr int kBarOffset = kQBytes + kStages * (kKBytes + kVBytes);
  static constexpr int kSmem = kBarOffset + 64 + 1024;  // + align slack
  static_assert(kSmem <= 227 * 1024, "over the block's shared memory");
};

struct Params {
  __nv_bfloat16* o;
  int B, H, KVH, G, Sq, kv_end, causal, n_qtiles;
  long long o_b, o_h, o_s;
  // position (1..3) of the (s, h, b) coordinates in each tensor map
  int qpos[3], kpos[3], vpos[3];
  float scale_log2;  // D^-0.5 * log2(e), with the real query / key D
  int window;        // 0: none
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
  else if constexpr (D == 64)
    hopper::mma_bf16_m64n64k16_rs_tb(o, a, db, 1);
  else
    hopper::mma_bf16_m64n16k16_rs_tb(o, a, db, 1);
}

// D: the real query / key head dim, Dv the value one; DP and DVP: the
// widths they are laid out and multiplied with.  kWindow: the sliding
// window is on (p.window > 0); without it the kernel compiles to the
// causal / kv_end mask alone
template <int D, int Dv, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ Params p) {
  constexpr int DP = kPadded<D>, DVP = kPadded<Dv>;
  using T = Tile<DP, DVP>;
  using RQ = Rows<DP>;   // Q and K tiles
  using RV = Rows<DVP>;  // V tiles
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  // stage s: K at kv + s (kKBytes + kVBytes), V after it
  uint8_t* kv = smem + T::kQBytes;
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
  // the first key tile some row of the tile reads: below it every key is
  // outside the window of row q0, the tile's first
  const int t0 = kWindow ? max(0, q0 - p.window + 1) / kBK : 0;

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
      for (int c = 0; c < RQ::kChunks; ++c)
        load_box(qs + c * kBQ * RQ::kSw, &qmap, qbar, p.qpos, c * RQ::kCols,
                 q0, h, b);
      for (int t = t0; t < n_tiles; ++t) {
        const int i = t - t0;  // ring position
        const int s = i % kStages;
        if (i >= kStages)
          hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        uint8_t* kd = kv + s * (T::kKBytes + T::kVBytes);
        uint8_t* vd = kd + T::kKBytes;
        hopper::mbar_expect_tx(&full[s], T::kKBytes + T::kVBytes);
        // K and V chunk c in turn (with Dv = D the loads of one chunk
        // pair issue together)
#pragma unroll
        for (int c = 0; c < (RQ::kChunks > RV::kChunks ? RQ::kChunks
                                                       : RV::kChunks); ++c) {
          if (c < RQ::kChunks)
            load_box(kd + c * kBK * RQ::kSw, &kmap, &full[s], p.kpos,
                     c * RQ::kCols, t * kBK, kvh, b);
          if (c < RV::kChunks)
            load_box(vd + c * kBK * RV::kSw, &vmap, &full[s], p.vpos,
                     c * RV::kCols, t * kBK, kvh, b);
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
  const uint8_t* qw = qs + wg * 64 * RQ::kSw;

  float o[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's partial sums
  // with the window, the keys each of the lane's two rows reads,
  // inclusive: from row - window + 1, below kv_end, up to the row when
  // causal (two compares per score on the tiles that need a mask)
  int key_lo[2], key_hi[2];
  if constexpr (kWindow) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      key_hi[r] = p.causal ? min(row[r], p.kv_end - 1) : p.kv_end - 1;
      key_lo[r] = row[r] - p.window + 1;
    }
  }

  hopper::mbar_wait(qbar, 0);
  for (int t = t0; t < n_tiles; ++t) {
    const int s = (t - t0) % kStages;
    hopper::mbar_wait(&full[s], ((t - t0) / kStages) & 1);
    const uint8_t* kd = kv + s * (T::kKBytes + T::kVBytes);
    const uint8_t* vd = kd + T::kKBytes;

    // S = Q K^T: sc[4 j + i] is row row[i / 2], key k0 + 8 j + 2 (lane %
    // 4) + i % 2
    float sc[kBK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk * 16 / RQ::kCols, off = (kk * 16 % RQ::kCols) * 2;
      const uint64_t da = hopper::make_desc(qw + c * kBQ * RQ::kSw + off, 16,
                                            8 * RQ::kSw, RQ::kLayout);
      const uint64_t db = hopper::make_desc(kd + c * kBK * RQ::kSw + off, 16,
                                            8 * RQ::kSw, RQ::kLayout);
      hopper::mma_bf16_m64n128k16_ss(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);

    const int k0 = t * kBK;
    const bool edge = k0 + kBK > p.kv_end ||
                      (p.causal && k0 + kBK - 1 > r_lo) ||
                      (kWindow && k0 <= r_lo + 63 - p.window);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      float v = sc[i] * p.scale_log2;
      if (edge) {
        const int key = k0 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
        const int r = (i >> 1) & 1;
        bool ok;
        if constexpr (kWindow)
          ok = (key >= key_lo[r]) & (key <= key_hi[r]);
        else
          ok = key < p.kv_end && (!p.causal || key <= row[r]);
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
    for (int i = 0; i < DVP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

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
      mma_pv<DVP>(o, pa[kk],
                 hopper::make_desc(vd + kk * 16 * RV::kSw, kBK * RV::kSw,
                                   8 * RV::kSw, RV::kLayout));
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
    for (int j = 0; j < Dv / 8; ++j)  // the real columns only
      *reinterpret_cast<uint32_t*>(orow + j * 8) = pack_bf16(
          o[4 * j + 2 * r] / l_run[r], o[4 * j + 2 * r + 1] / l_run[r]);
  }
}

// Tensor map of a bf16 (batch, heads, rows, D) operand with unit stride in
// D: D innermost in boxes of kCols columns (the real width D, so columns
// past it up to the padded width are zero-filled), then the (rows, heads,
// batch) dimensions of more than one element ordered by stride, those of
// one element outermost; a box spans `box_rows` rows of one head.  pos[i]
// receives the map position of rows (i = 0), heads (1) and batch (2).
template <int D>
int encode_operand(CUtensorMap* map, const void* base, long long rows,
                   long long s_rows, long long heads, long long s_heads,
                   long long batch, long long s_batch, int box_rows,
                   int (&pos)[3]) {
  using T = Rows<kPadded<D>>;
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

template <int D, int Dv, bool kWindow>
int start(const CUtensorMap& qm, const CUtensorMap& km,
          const CUtensorMap& vm, const Params& p, cudaStream_t stream) {
  constexpr int smem = Tile<kPadded<D>, kPadded<Dv>>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<D, Dv, kWindow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned grid = static_cast<unsigned>(p.n_qtiles) * p.B * p.H;
  flash_fwd<D, Dv, kWindow><<<grid, kThreads, smem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int Dv, bool kWindowed>
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
    rc = encode_operand<Dv>(&vm, v, kv_end, v_s, p.KVH, v_h, p.B, v_b, kBK,
                            p.vpos);
  if (rc) return rc;
  if (p.window <= 0) return start<D, Dv, false>(qm, km, vm, p, stream);
  if constexpr (kWindowed)
    return start<D, Dv, true>(qm, km, vm, p, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KVH, int Sq, int kv_end, int D, int Dv, long long q_b, long long q_h,
    long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b,
    long long o_h, long long o_s, int causal, int window, void* stream) {
  Params p{};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.G = H / KVH;
  p.Sq = Sq;
  p.kv_end = kv_end;
  p.causal = causal;
  p.window = window;
  p.n_qtiles = (Sq + kBQ - 1) / kBQ;
  p.o_b = o_b;
  p.o_h = o_h;
  p.o_s = o_s;
  p.scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(double(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define X(d, dv, windowed)                                               \
  if (D == d && Dv == dv)                                                 \
    return launch<d, dv, windowed>(q, k, v, p, Sq, kv_end, q_b, q_h, q_s, \
                                   k_b, k_h, k_s, v_b, v_h, v_s, s);
  FLASH_SHAPES
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return hopper::error_string(code);
}
