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
// flop / D), not by bytes.  The design keeps every score in registers:
//   - one block of 4 warps per (b * H + h, 64-query tile); each warp owns
//     16 query rows, whose Q fragments it loads once into registers;
//   - K and V tiles of 64 rows are staged through shared memory (rows
//     padded by 8 bf16 so the fragment loads are free of bank conflicts);
//     rows past kv_end are zero-filled, so masked keys never meet garbage;
//   - QK^T and PV run on `mma.sync.m16n8k16` bf16 -> f32; the S
//     accumulator of QK^T is, register for register, the A operand of PV
//     once rounded to bf16, and V's B operand comes from `ldmatrix.trans`;
//   - the softmax runs in the log2 domain (exp2f of scores pre-scaled by
//     D^-0.5 * log2 e); the row max is reduced over the 4 lanes of a quad;
//   - key tiles wholly above the diagonal or past kv_end are never loaded.
// Not yet done (later work): wgmma, TMA, a pipelined ring of K/V tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per tile

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int H, G, Sq, kv_end, causal;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float scale_log2;  // D^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&t);
}

// d += a * b: A 16x16 bf16 row-major, B 16x8 bf16 column-major, D f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: lanes 8i .. 8i+7 give the row
// addresses of matrix i; lane l receives, of matrix i, rows 2(l%4) and
// 2(l%4)+1 of column l/4 in r[i].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int KD = D / 16;   // k-steps of QK^T
  constexpr int ND = D / 8;    // 8-column tiles of the output
  constexpr int LDS = D + 8;   // shared row stride in bf16 (16-byte multiple)
  constexpr int CH = D / 8;    // 16-byte chunks per K / V row
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * LDS];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = p.q + b * p.q_b + h * p.q_h;
  const __nv_bfloat16* kb = p.k + b * p.k_b + kvh * p.k_h;
  const __nv_bfloat16* vb = p.v + b * p.v_b + kvh * p.v_h;

  // this thread's two query rows: fragment rows g and g + 8 of the warp
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // A fragments of Q: a[i] holds row row[i & 1], columns 2t, 2t + 1 (+ 8
  // when i & 2) of the 16-column step
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row[i & 1], c = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      qa[kk][i] = r < p.Sq ? *reinterpret_cast<const uint32_t*>(
                                 qb + r * p.q_s + c)
                           : 0u;
    }

  float acc[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's partial sums

  int kv_stop = p.kv_end;
  if (p.causal) kv_stop = min(kv_stop, q0 + kBQ);
  const int n_tiles = (kv_stop + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    for (int idx = tid; idx < kBK * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const int key = k0 + r;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
      if (key < p.kv_end) {
        kw = *reinterpret_cast<const uint4*>(kb + key * p.k_s + c);
        vw = *reinterpret_cast<const uint4*>(vb + key * p.v_s + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * LDS + c]) = kw;
      *reinterpret_cast<uint4*>(&vs[r * LDS + c]) = vw;
    }
    __syncthreads();

    // S = Q K^T over 8 tiles of 8 keys: s[nt][i] is row row[i >> 1], key
    // k0 + 8 nt + 2t + (i & 1)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      const __nv_bfloat16* kp = &ks[(nt * 8 + g) * LDS + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kp + kk * 16 + 8);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        const bool ok =
            key < p.kv_end && (!p.causal || key <= row[i >> 1]);
        s[nt][i] = ok ? s[nt][i] * p.scale_log2 : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
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
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp2f(s[nt][i] - base[i >> 1]);
        rs[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += P V: P's A fragment for keys 16 kk2 .. 16 kk2 + 15 is the S
    // accumulator of key tiles 2 kk2 and 2 kk2 + 1, rounded to bf16
#pragma unroll
    for (int kk2 = 0; kk2 < 4; ++kk2) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk2][0], s[2 * kk2][1]),
                              pack_bf16(s[2 * kk2][2], s[2 * kk2][3]),
                              pack_bf16(s[2 * kk2 + 1][0], s[2 * kk2 + 1][1]),
                              pack_bf16(s[2 * kk2 + 1][2], s[2 * kk2 + 1][3])};
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int dt = 0; dt < ND; dt += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, &vs[(kk2 * 16 + (mi & 1) * 8 + rr) * LDS + (dt + (mi >> 1)) * 8]);
        mma_bf16(acc[dt], pa, vf[0], vf[1]);
        mma_bf16(acc[dt + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();
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
    __nv_bfloat16* orow = ob + row[r] * p.o_s + 2 * t;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(acc[dt][2 * r] / l_run[r], acc[dt][2 * r + 1] / l_run[r]);
  }
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KVH, int Sq, int kv_end, int D, long long q_b, long long q_h,
    long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b,
    long long o_h, long long o_s, int causal, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v),
           static_cast<__nv_bfloat16*>(o),
           H, H / KVH, Sq, kv_end, causal,
           q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s,
           static_cast<float>(1.4426950408889634 / std::sqrt(double(D)))};
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: flash_fwd<16><<<grid, kThreads, 0, s>>>(p); break;
    case 128: flash_fwd<128><<<grid, kThreads, 0, s>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
