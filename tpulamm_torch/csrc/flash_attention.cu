// Flash attention over the slot KV cache, two entry points for sm_90a.
//
// Replaces tpulamm/ops/flash_attention.py::flash_attention (Pallas body
// `_kernel`) and ::flash_decode (`_decode_kernel` plus its cross-chunk
// combine). Both compute, for q (B, Hkv, T*G, hd) with the G query heads of
// one KV head folded into the rows, softmax(q k^T * scale) v over the cache
// rows k / v (B, Hkv, S, hd) under the mask the engine's einsum path uses:
//   live = kpos >= 0 (and col < S);
//   causal: kpos <= qbase[b] + row / G and row / G < qlen[b].
// A q8_0 cache passes int8 codes with per-row f32 scales ks / vs (B, Hkv, S):
// ks folds into the score columns, vs into p before the PV product, so the
// cache streams at one byte per element and is never dequantized whole.
// Fully masked rows give exact zeros (the l > 0 guard).
//
// Numerics as on the TPU: q, k, v and p are rounded to bf16 before each
// product (int8 codes convert to bf16 exactly); scores, the softmax and all
// sums are f32. NEG_INF is -1e30 and p = 0 where s <= NEG_INF.
//
// What bounds it on an H100: a prefill ubatch (T = 512) over a long span
// does 4 * T * G * S * hd operations per head on ~S * hd * 2 bytes of K/V,
// ~1000 operations per byte: operations. A decode step (T * G < 64) reads
// the whole K/V span once for a few rows: bytes.
//
// Design:
// - flash_attention: one block of 4 warps per (b, h, 64-row tile); each
//   warp owns 16 query rows. The block loops over S itself (the TPU ran the
//   S tiles as a sequential fourth grid axis): each K/V tile of BN rows is
//   converted to bf16 into shared memory, QK^T and PV run on the tensor
//   cores as mma.sync m16n8k16 (bf16 in, f32 accumulate), and the running
//   (acc, m, l) stay in registers. The S accumulator fragment is the A
//   fragment of the PV product, so p never leaves registers. A tile whose
//   keys are all dead for every row of the block (empty cells, or keys
//   after the block's last query position) is skipped: it would add exact
//   zeros.
// - flash_decode: the same block body over one chunk of S per block, grid
//   (row tiles x chunks, Hkv, B); the chunk is chosen by the wrapper so the
//   grid fills the card. Each block writes its unnormalised partial
//   (acc, m, l); `fd_combine` then applies the max / denominator rescale.
//   A chunk with no live key (the one-key last chunk of S = n_ctx + 1 holds
//   the trash cell) gives m = -1e30, l = 0, acc = 0, which the combine
//   weighs to nothing.
// - K, V, kpos, ks and vs are read through their strides: the span view of
//   a (B, Hkv, n_ctx + 1, hd) cache buffer is never copied.
// - Shared memory rows are padded by 8 bf16 so the fragment loads of a warp
//   fall in 32 different banks.
// No wgmma, TMA or load/compute overlap yet: a simple kernel first.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace {

constexpr int BM = 64;          // query rows per block (4 warps x 16)
constexpr int THREADS = 128;

enum { T_F32 = 0, T_BF16 = 1, T_F16 = 2, T_I8 = 3 };

struct Args {
  const float* q;                  // (B, Hkv, TG, hd) contiguous
  const void* k;                   // strided, last stride 1
  const void* v;
  const int* kpos;                 // (B, S), last stride 1
  const int* qbase;                // (B,)
  const int* qlen;                 // (B,)
  const float* ks;                 // (B, Hkv, S) or null
  const float* vs;
  float* out;                      // (B, Hkv, TG, hd), or the acc partials
  float* m_part;                   // (B, Hkv, ns, TG) for the split kernel
  float* l_part;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, kp_sb;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  int k_type, v_type;
  int Hkv, TG, S, G, causal, chunk, n_chunks;
  float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive elements of a K / V row as bf16, 16 bytes
__device__ __forceinline__ uint4 load8_bf16(const void* base, int type,
                                            long long off) {
  uint4 r;
  if (type == T_BF16) {
    r = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(base) + off);
  } else if (type == T_F32) {
    const float4* p = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(base) + off);
    float4 a = p[0], b = p[1];
    r.x = pack_bf16(a.x, a.y);
    r.y = pack_bf16(a.z, a.w);
    r.z = pack_bf16(b.x, b.y);
    r.w = pack_bf16(b.z, b.w);
  } else if (type == T_F16) {
    uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __half*>(base) + off);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
    float2 f0 = __half22float2(h[0]), f1 = __half22float2(h[1]);
    float2 f2 = __half22float2(h[2]), f3 = __half22float2(h[3]);
    r.x = pack_bf16(f0.x, f0.y);
    r.y = pack_bf16(f1.x, f1.y);
    r.z = pack_bf16(f2.x, f2.y);
    r.w = pack_bf16(f3.x, f3.y);
  } else {                                       // int8 codes: exact in bf16
    uint2 u = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const int8_t*>(base) + off);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
    r.x = pack_bf16((float)c[0], (float)c[1]);
    r.y = pack_bf16((float)c[2], (float)c[3]);
    r.z = pack_bf16((float)c[4], (float)c[5]);
    r.w = pack_bf16((float)c[6], (float)c[7]);
  }
  return r;
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int HD, int BN>
constexpr int smem_bytes() {
  return (BM + 2 * BN) * (HD + 8) * 2 + BN * 12;
}

template <int HD, int BN, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const Args a) {
  constexpr int LD = HD + 8;                     // padded smem row (bf16)
  constexpr int NT = BN / 8;                     // score n-tiles per warp
  constexpr int DT = HD / 8;                     // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;
  int* kp_s = reinterpret_cast<int*>(Vs + BN * LD);
  float* ks_s = reinterpret_cast<float*>(kp_s + BN);
  float* vs_s = ks_s + BN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int rtile = SPLIT ? blockIdx.x / a.n_chunks : blockIdx.x;
  const int chunk = SPLIT ? blockIdx.x % a.n_chunks : 0;
  const int row0 = rtile * BM;
  const int s_begin = chunk * a.chunk;
  const int s_end = SPLIT ? min(a.S, s_begin + a.chunk) : a.S;
  const int qb = a.qbase[b], ql = a.qlen[b];
  const int G = a.G, TG = a.TG;
  const bool causal = a.causal != 0;
  const bool has_ks = a.ks != nullptr, has_vs = a.vs != nullptr;

  // stage this block's query rows as bf16; rows past TG are zeros
  const float* qg = a.q + (long long)(b * a.Hkv + h) * TG * HD;
  for (int i = tid; i < BM * (HD / 4); i += THREADS) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < TG)
      x = *reinterpret_cast<const float4*>(qg + (long long)(row0 + r) * HD + c);
    uint2 p;
    p.x = pack_bf16(x.x, x.y);
    p.y = pack_bf16(x.z, x.w);
    *reinterpret_cast<uint2*>(Qs + r * LD + c) = p;
  }

  // this thread's two rows (g and g + 8 of the warp's 16)
  const int wr = warp * 16;
  const int rA = row0 + wr + g, rB = rA + 8;
  const int tA = rA / G, tB = rB / G;
  const int qposA = qb + tA, qposB = qb + tB;
  const bool okA = !causal || tA < ql, okB = !causal || tB < ql;
  // the warp has work if its first row is a real, live row
  const int wt0 = (row0 + wr) / G;
  const bool warp_live = (row0 + wr < TG) && (!causal || wt0 < ql);
  // the block's last live query position bounds the keys it can see
  const int rend = min(TG, row0 + BM);
  const int t_last = min((rend - 1) / G, ql - 1);
  const bool block_live = rend > row0 && (!causal || row0 / G < ql);
  const int qpos_max = qb + t_last;

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;

  const long long kbase = b * a.k_sb + h * a.k_sh;
  const long long vbase = b * a.v_sb + h * a.v_sh;
  const int* kp_row = a.kpos + b * a.kp_sb;

  for (int s0 = s_begin; block_live && s0 < s_end; s0 += BN) {
    __syncthreads();                         // previous tile fully consumed
    int any = 0;
    for (int i = tid; i < BN; i += THREADS) {
      const int col = s0 + i;
      int kp = -1;
      float ksv = 0.f, vsv = 0.f;
      if (col < s_end) {
        kp = kp_row[col];
        if (has_ks) ksv = a.ks[b * a.ks_sb + h * a.ks_sh + col];
        if (has_vs) vsv = a.vs[b * a.vs_sb + h * a.vs_sh + col];
      }
      kp_s[i] = kp;
      ks_s[i] = ksv;
      vs_s[i] = vsv;
      any |= (kp >= 0) && (!causal || kp <= qpos_max);
    }
    if (!__syncthreads_or(any)) continue;    // every key dead: adds zeros

    for (int i = tid; i < BN * (HD / 8); i += THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int col = s0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (col < s_end) {                     // tail rows stay exact zeros
        kv = load8_bf16(a.k, a.k_type, kbase + col * a.k_ss + c);
        vv = load8_bf16(a.v, a.v_type, vbase + col * a.v_ss + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv;
    }
    __syncthreads();
    if (!warp_live) continue;

    // scores S = Q K^T for the warp's 16 rows x BN keys
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      const __nv_bfloat16* qa = Qs + (wr + g) * LD + kk + 2 * tig;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * LD + kk + 2 * tig;
        mma_bf16(sc[n], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    // scale, q8 K fold, mask; the running max of each row
    float mxA = NEG_INF, mxB = NEG_INF;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + 2 * tig + (e & 1);
        const bool rowB = e >= 2;
        float s = sc[n][e] * a.scale;
        if (has_ks) s = s * ks_s[cl];
        const int kp = kp_s[cl];
        bool live = kp >= 0;
        if (causal) live = live && (rowB ? (kp <= qposB && okB)
                                         : (kp <= qposA && okA));
        s = live ? s : NEG_INF;
        sc[n][e] = s;
        if (rowB) mxB = fmaxf(mxB, s); else mxA = fmaxf(mxA, s);
      }
    }
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
    const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
    const float corrA = __expf(mA - mnA), corrB = __expf(mB - mnB);
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool rowB = e >= 2;
        const float s = sc[n][e];
        float p = s <= NEG_INF ? 0.f : __expf(s - (rowB ? mnB : mnA));
        if (rowB) sumB += p; else sumA += p;
        if (has_vs) p = p * vs_s[n * 8 + 2 * tig + (e & 1)];
        sc[n][e] = p;
      }
    }
    sumA += __shfl_xor_sync(0xffffffffu, sumA, 1);
    sumA += __shfl_xor_sync(0xffffffffu, sumA, 2);
    sumB += __shfl_xor_sync(0xffffffffu, sumB, 1);
    sumB += __shfl_xor_sync(0xffffffffu, sumB, 2);
    lA = lA * corrA + sumA;
    lB = lB * corrB + sumB;
    mA = mnA;
    mB = mnB;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= corrA; o[d][1] *= corrA;
      o[d][2] *= corrB; o[d][3] *= corrB;
    }

    // O += P V: the score fragments of two n-tiles are one A fragment
    const unsigned short* Vu = reinterpret_cast<const unsigned short*>(Vs);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t a0 = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      const uint32_t a1 = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      const uint32_t a2 = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      const int k0 = 16 * j + 2 * tig;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int dc = d * 8 + g;
        const uint32_t b0 = (uint32_t)Vu[k0 * LD + dc]
                            | ((uint32_t)Vu[(k0 + 1) * LD + dc] << 16);
        const uint32_t b1 = (uint32_t)Vu[(k0 + 8) * LD + dc]
                            | ((uint32_t)Vu[(k0 + 9) * LD + dc] << 16);
        mma_bf16(o[d], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // epilogue: rows past TG are not written
  const long long bh = (long long)b * a.Hkv + h;
  if (SPLIT) {
    const long long base = (bh * a.n_chunks + chunk) * TG;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + 2 * tig;
      if (rA < TG)
        *reinterpret_cast<float2*>(a.out + (base + rA) * HD + c) =
            make_float2(o[d][0], o[d][1]);
      if (rB < TG)
        *reinterpret_cast<float2*>(a.out + (base + rB) * HD + c) =
            make_float2(o[d][2], o[d][3]);
    }
    if (tig == 0) {
      if (rA < TG) { a.m_part[base + rA] = mA; a.l_part[base + rA] = lA; }
      if (rB < TG) { a.m_part[base + rB] = mB; a.l_part[base + rB] = lB; }
    }
  } else {
    const float iA = lA > 0.f ? 1.f / lA : 0.f;
    const float iB = lB > 0.f ? 1.f / lB : 0.f;
    float* ob = a.out + bh * TG * HD;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + 2 * tig;
      if (rA < TG)
        *reinterpret_cast<float2*>(ob + (long long)rA * HD + c) =
            lA > 0.f ? make_float2(o[d][0] * iA, o[d][1] * iA)
                     : make_float2(0.f, 0.f);
      if (rB < TG)
        *reinterpret_cast<float2*>(ob + (long long)rB * HD + c) =
            lB > 0.f ? make_float2(o[d][2] * iB, o[d][3] * iB)
                     : make_float2(0.f, 0.f);
    }
  }
}

// out = sum_j exp(m_j - m*) acc_j / sum_j exp(m_j - m*) l_j, or 0 where the
// denominator is 0. One block per (row, b * Hkv + h), one thread per column.
__global__ void fd_combine(const float* __restrict__ acc,
                           const float* __restrict__ m,
                           const float* __restrict__ l,
                           float* __restrict__ out, int ns, int TG, int HD) {
  const int r = blockIdx.x;
  const long long bh = blockIdx.y;
  const int d = threadIdx.x;
  const float* mp = m + bh * ns * TG + r;
  const float* lp = l + bh * ns * TG + r;
  float mg = NEG_INF;
  for (int j = 0; j < ns; ++j) mg = fmaxf(mg, mp[(long long)j * TG]);
  float lg = 0.f, o = 0.f;
  for (int j = 0; j < ns; ++j) {
    const float w = expf(mp[(long long)j * TG] - mg);
    lg += w * lp[(long long)j * TG];
    o += w * acc[((bh * ns + j) * TG + r) * HD + d];
  }
  out[(bh * TG + r) * HD + d] = lg > 0.f ? o / lg : 0.f;
}

template <int HD, int BN, bool SPLIT>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD, BN>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<HD, BN, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int rt = (a.TG + BM - 1) / BM;
  dim3 grid(SPLIT ? rt * a.n_chunks : rt, a.Hkv, B);
  flash_kernel<HD, BN, SPLIT><<<grid, THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

template <bool SPLIT>
cudaError_t dispatch(int hd, const Args& a, int B, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<64, 64, SPLIT>(a, B, st);
    case 128: return launch<128, 64, SPLIT>(a, B, st);
    case 256: return launch<256, 32, SPLIT>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// split = 0: flash_attention, out (B, Hkv, TG, hd) f32.
// split = 1: flash_decode over n_chunks chunks of `chunk` keys; acc_ws
// (B, Hkv, n_chunks, TG, hd), m_ws / l_ws (B, Hkv, n_chunks, TG), then the
// combine into out. Strides are in elements; the last stride of every
// tensor is 1. ks / vs may be null.
extern "C" int tl_flash(int hd, int split, const float* q,
                        const void* k, int k_type, long long k_sb,
                        long long k_sh, long long k_ss,
                        const void* v, int v_type, long long v_sb,
                        long long v_sh, long long v_ss,
                        const int* kpos, long long kp_sb,
                        const int* qbase, const int* qlen,
                        const float* ks, long long ks_sb, long long ks_sh,
                        const float* vs, long long vs_sb, long long vs_sh,
                        int B, int Hkv, int TG, int S, int G, int causal,
                        float scale, int chunk, int n_chunks,
                        float* acc_ws, float* m_ws, float* l_ws, float* out,
                        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Args a;
  a.q = q; a.k = k; a.v = v; a.kpos = kpos; a.qbase = qbase; a.qlen = qlen;
  a.ks = ks; a.vs = vs;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss; a.kp_sb = kp_sb;
  a.ks_sb = ks_sb; a.ks_sh = ks_sh; a.vs_sb = vs_sb; a.vs_sh = vs_sh;
  a.k_type = k_type; a.v_type = v_type;
  a.Hkv = Hkv; a.TG = TG; a.S = S; a.G = G; a.causal = causal;
  a.scale = scale;
  if (TG <= 0 || B <= 0) return 0;
  if (!split) {
    a.chunk = S; a.n_chunks = 1;
    a.out = out; a.m_part = nullptr; a.l_part = nullptr;
    return (int)dispatch<false>(hd, a, B, st);
  }
  a.chunk = chunk; a.n_chunks = n_chunks;
  a.out = acc_ws; a.m_part = m_ws; a.l_part = l_ws;
  cudaError_t e = dispatch<true>(hd, a, B, st);
  if (e != cudaSuccess) return (int)e;
  fd_combine<<<dim3(TG, B * Hkv), hd, 0, st>>>(acc_ws, m_ws, l_ws, out,
                                               n_chunks, TG, hd);
  return (int)cudaGetLastError();
}
