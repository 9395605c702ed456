// mega_decode.cu -- one decode step through every layer in one launch.
//
// Replaces tpulamm/ops/pallas_decode.py::mega_decode_layers (kernel body
// _make_kernel), the TPU's single-launch decode of a llama-family stack:
// per layer, rms norm + fused QKV; rope + attention over the cache and the
// current token; wo + residual; ffn norm + gate|up; act * up, down +
// residual. B0 = 1: the single-stream decode step.
//
// Numerics are the JAX kernel's rounding points: the residual stream and
// the normed activations in bf16 (products take them as f32 against f32
// dequantized weights); q, k, v after rope rounded to bf16 for attention;
// cache scores bf16 x bf16 with f32 sums, times 1/sqrt(hd); the live mask
// kpos >= 0 & kpos <= qpos; the current token merged analytically (its
// score from the bf16 q and k, its bf16 v); p rounded to bf16 for the PV
// product, the denominator from the f32 p; the attention output, mid =
// act(gate) * up and each residual add rounded to bf16. The new K / V rows
// leave as f32 (k_new, v_new) and, rounded to bf16, are written into the
// cache in place at `cell` (whose position is still -1 during the step,
// so no block reads it).
//
// What bounds it on an H100: the bytes of every layer's planes plus the
// live K / V rows, read once a step (LLaMA-7B Q4_0 at span 1024: 4.05 GB
// of planes + 0.54 GB of bf16 K/V, ~1.4 ms at 3.35 TB/s).
//
// Design: one cooperative launch (every block resident, so grid barriers
// cannot deadlock); a grid barrier between the five phases of a layer,
// 5 L in all. The four products are gemv_stage items spread over every
// block (gemv_stage.cuh); the planes are read in place through a table of
// per-layer pointers (no stacked copy). Phase A and D blocks each
// recompute the rms norm for themselves, so no barrier is spent on it.
// Phase B is split over heads x chunks of S (32 heads alone would leave
// most SMs idle): each item scores its chunk (a warp a key), keeps its own
// max, sums p and p V, and the last item of a head merges the chunks and
// the current token in chunk order. Every reduction runs in a fixed order
// without float atomics, so two runs give the same tokens.

#include <cuda_bf16.h>

#include "gemv_stage.cuh"

namespace {

using namespace tlg;

constexpr float NEG_INF = -1e30f;
constexpr int MAX_HD = 256, MAX_CHUNK = 2048;
constexpr int MAX_BLOCKS_PER_SM = 2;

}  // namespace

// Every field is 8 bytes wide (ops/mega_decode.py builds the same struct
// with ctypes).
struct MegaArgs {
  long long L, dim, H, Hkv, hd, ffn, S, cell, qpos, act, rope_kind, n_rot;
  long long qt_qkv, qt_wo, qt_gu, qt_dn;        // formats of the 4 weights
  long long ks_qkv, ks_wo, ks_gu, ks_dn;        // K splits of the products
  long long nch, chunk;                         // attention: chunks of S
  long long kv_hstride, kv_rstride;             // cache strides (elements)
  double eps, scale;
  const long long* planes;  // (L, 4, 4): qa qb sa sb of wqkv, wo, gu, down
  const long long* kcache;  // (L) bf16 K view of the slot: [Hkv][S][hd]
  const long long* vcache;  // (L) bf16 V view
  const float* attn_norm;   // (L, dim)
  const float* ffn_norm;    // (L, dim)
  const int* kpos;          // (S) cell positions, -1 = empty
  const float* x;           // (dim) embedding output
  const float* cosq;        // (H hd) rope lane vectors
  const float* sinq;
  const float* cosk;        // (Hkv hd)
  const float* sink;
  float* x_out;             // (dim)
  float* k_new;             // (L, Hkv hd)
  float* v_new;
  // scratch
  __nv_bfloat16* xres;      // (dim) residual stream
  float* qkv;               // ((H + 2 Hkv) hd)
  __nv_bfloat16* ao;        // (H hd) attention output
  __nv_bfloat16* mid;       // (ffn)
  float* apart;             // (H, nch, hd + 2): chunk max, sum, p V
  float* partial;           // gemv split sums
  unsigned int* counters;   // zeroed, >= max(tiles, H)
  unsigned int* bar;        // 2 zeroed words
};

namespace {

struct AttnSmem {
  float q[MAX_HD], k[MAX_HD], v[MAX_HD];   // this head's q, the token's k, v
  float s[MAX_CHUNK];                      // scores, then p, of the chunk
  float pv[NT];                            // p V partial sums
};

union MegaSmem {
  StageSmem<1, 1> g1;
  StageSmem<1, 2> g2;
  AttnSmem at;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ldbf(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float ldbf_ro(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// block-wide sum / max in a fixed order; every thread gets the result
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float block_reduce(float v, float* buf, bool mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = mx ? fmaxf(v, w) : v + w;
  }
  __syncthreads();                      // buf is free
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = buf[0];
  for (int w = 1; w < WARPS; ++w) r = mx ? fmaxf(r, buf[w]) : r + buf[w];
  return r;
}

// 1 / sqrt(mean(xres^2) + eps), the same in every block
__device__ float rms_inv(const MegaArgs& a, float* buf) {
  const int dim = (int)a.dim;
  float ss = 0.f;
  for (int i = threadIdx.x; i < dim; i += NT) {
    const float v = ldbf(a.xres + i);
    ss += v * v;
  }
  const float var = block_reduce(ss, buf, false) / (float)dim;
  return 1.0f / sqrtf(var + (float)a.eps);
}

// lane d of a head of q (or k) after rope: x * cos + rot(x) * sin, where
// rot swaps pairs (norm) or halves (neox); lanes past n_rot have cos 1,
// sin 0
__device__ __forceinline__ float rope_at(const MegaArgs& a, const float* src,
                                         const float* cs, const float* sn,
                                         int base, int d) {
  const float x = __ldcg(src + base + d);
  if (a.rope_kind == 0) return x;
  const int half = (int)a.n_rot / 2;
  const int pd = a.rope_kind == 1 ? (d ^ 1) : (d < half ? d + half : d - half);
  const float r = __ldcg(src + base + pd);
  return __fadd_rn(__fmul_rn(x, __ldg(cs + base + d)),
                   __fmul_rn(r, __ldg(sn + base + d)));
}

// phase B: attention of every head, items (head, chunk of S)
__device__ void attention(const MegaArgs& a, int l, AttnSmem& sm, float* buf) {
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = (int)a.H, Hkv = (int)a.Hkv, hd = (int)a.hd, S = (int)a.S;
  const int G = H / Hkv, nq = H * hd, nkv = Hkv * hd;
  const int nch = (int)a.nch, chunk = (int)a.chunk, qpos = (int)a.qpos;
  const float scale = (float)a.scale;
  const __nv_bfloat16* Kc = (const __nv_bfloat16*)a.kcache[l];
  const __nv_bfloat16* Vc = (const __nv_bfloat16*)a.vcache[l];
  const long long hs = a.kv_hstride, rs = a.kv_rstride;
  for (int it = blockIdx.x; it < H * nch; it += gridDim.x) {
    const int h = it / nch, c = it - h * nch, j = h / G;
    __syncthreads();                    // sm is free
    for (int d = tid; d < hd; d += NT) {
      sm.q[d] = bf16r(rope_at(a, a.qkv, a.cosq, a.sinq, h * hd, d));
      sm.k[d] = rope_at(a, a.qkv + nq, a.cosk, a.sink, j * hd, d);
      sm.v[d] = __ldcg(a.qkv + nq + nkv + j * hd + d);
    }
    __syncthreads();
    if (c == 0 && h == j * G) {         // one block a KV head: the new row
      __nv_bfloat16* kr = (__nv_bfloat16*)Kc + j * hs + (long long)a.cell * rs;
      __nv_bfloat16* vr = (__nv_bfloat16*)Vc + j * hs + (long long)a.cell * rs;
      for (int d = tid; d < hd; d += NT) {
        a.k_new[((size_t)l * Hkv + j) * hd + d] = sm.k[d];
        a.v_new[((size_t)l * Hkv + j) * hd + d] = sm.v[d];
        kr[d] = __float2bfloat16_rn(sm.k[d]);
        vr[d] = __float2bfloat16_rn(sm.v[d]);
      }
    }
    // the current token's score, from the bf16 q and k
    float part = 0.f;
    for (int d = tid; d < hd; d += NT) part += sm.q[d] * bf16r(sm.k[d]);
    const float sc = block_reduce(part, buf, false) * scale;
    // the chunk's scores: a warp a key
    const int i0 = c * chunk;
    const int n = max(0, min(chunk, S - i0));
    for (int r = warp; r < n; r += WARPS) {
      const int i = i0 + r;
      const int p = __ldg(a.kpos + i);
      float s = NEG_INF;
      if (p >= 0 && p <= qpos) {
        const __nv_bfloat16* kr = Kc + j * hs + (long long)i * rs;
        float acc = 0.f;
        for (int d = lane; d < hd; d += 32) acc = fmaf(sm.q[d], ldbf_ro(kr + d), acc);
        s = warp_sum(acc) * scale;
      }
      if (lane == 0) sm.s[r] = s;
    }
    __syncthreads();
    float mx = NEG_INF;
    for (int r = tid; r < n; r += NT) mx = fmaxf(mx, sm.s[r]);
    const float mc = block_reduce(mx, buf, true);
    float lsum = 0.f;
    for (int r = tid; r < n; r += NT) {
      const float s = sm.s[r];
      const float p = s <= NEG_INF ? 0.f : expf(s - mc);
      sm.s[r] = p;
      lsum += p;
    }
    const float lc = block_reduce(lsum, buf, false);   // syncs: p is visible
    // p V over the chunk: thread (g, d) takes keys g, g + groups, ...
    const int groups = NT / hd, g = tid / hd, d0 = tid - g * hd;
    float acc = 0.f;
    if (g < groups) {
      const __nv_bfloat16* vh = Vc + j * hs + d0;
      for (int r = g; r < n; r += groups) {
        const float p = sm.s[r];
        if (p != 0.f) acc = fmaf(bf16r(p), ldbf_ro(vh + (long long)(i0 + r) * rs), acc);
      }
    }
    sm.pv[tid] = acc;
    __syncthreads();
    float* out = a.apart + ((size_t)h * nch + c) * (hd + 2);
    for (int d = tid; d < hd; d += NT) {
      float v = 0.f;
      for (int q = 0; q < groups; ++q) v += sm.pv[q * hd + d];
      out[2 + d] = v;
    }
    if (tid == 0) {
      out[0] = mc;
      out[1] = lc;
    }
    // the last chunk of this head merges the chunks and the current token
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&a.counters[h], 1u) == (unsigned)(nch - 1);
    __syncthreads();
    if (!last) continue;
    const float* ph = a.apart + (size_t)h * nch * (hd + 2);
    float m = sc;
    for (int q = 0; q < nch; ++q) m = fmaxf(m, __ldcg(ph + q * (hd + 2)));
    const float pc = expf(sc - m);
    float den = 0.f;
    for (int q = 0; q < nch; ++q)
      den += expf(__ldcg(ph + q * (hd + 2)) - m) * __ldcg(ph + q * (hd + 2) + 1);
    den += pc;
    for (int d = tid; d < hd; d += NT) {
      float o = 0.f;
      for (int q = 0; q < nch; ++q)
        o += expf(__ldcg(ph + q * (hd + 2)) - m) * __ldcg(ph + q * (hd + 2) + 2 + d);
      o += pc * bf16r(sm.v[d]);
      a.ao[h * hd + d] = __float2bfloat16_rn(o / den);
    }
    if (tid == 0) a.counters[h] = 0u;
  }
}

__global__ void __launch_bounds__(NT, 2) mega_decode_kernel(MegaArgs a) {
  __shared__ __align__(16) MegaSmem sm;
  __shared__ float buf[WARPS];
  const int L = (int)a.L, dim = (int)a.dim, ffn = (int)a.ffn;
  const int nq = (int)(a.H * a.hd), nqkv = (int)((a.H + 2 * a.Hkv) * a.hd);
  const int tid = threadIdx.x;

  auto planes = [&](int l, int w, int ld, int off) {
    const long long* p = a.planes + (l * 4 + w) * 4;
    return Planes{(const uint8_t*)p[0], (const uint8_t*)p[1],
                  (const void*)p[2], (const void*)p[3], ld, off};
  };
  // the normed residual, xs[i] = bf16(xres * inv * w) of element k0 + i
  auto stage_norm = [&](const float* w, float inv) {
    return [=, &a](float* xs, int k0, int) {
      for (int i = threadIdx.x; i < SLICE; i += NT) {
        const int k = k0 + i;
        xs[i] = k < dim ? bf16r(__fmul_rn(__fmul_rn(ldbf(a.xres + k), inv),
                                          __ldg(w + k)))
                        : 0.f;
      }
    };
  };
  auto stage_bf16 = [&](const __nv_bfloat16* src, int K) {
    return [=](float* xs, int k0, int) {
      for (int i = threadIdx.x; i < SLICE; i += NT) {
        const int k = k0 + i;
        xs[i] = k < K ? ldbf(src + k) : 0.f;
      }
    };
  };

  for (int i = blockIdx.x * NT + tid; i < dim; i += gridDim.x * NT)
    a.xres[i] = __float2bfloat16_rn(a.x[i]);
  grid_sync(a.bar);

  for (int l = 0; l < L; ++l) {
    // A: attention norm + fused QKV
    {
      const float inv = rms_inv(a, buf);
      const Planes w[1] = {planes(l, 0, nqkv, 0)};
      auto epi = [&](int, int n, const float (&v)[1]) { a.qkv[n] = v[0]; };
      TLG_SWITCH_FMT((int)a.qt_qkv,
                     (gemv_stage<QT, 1, 1>(sm.g1, w, nqkv, dim, 1,
                                           (int)a.ks_qkv,
                                           stage_norm(a.attn_norm + (size_t)l * dim, inv),
                                           epi, a.partial, a.counters)))
    }
    grid_sync(a.bar);
    // B: rope + attention, the new K / V row into the cache
    attention(a, l, sm.at, buf);
    grid_sync(a.bar);
    // C: attention output projection + residual
    {
      const Planes w[1] = {planes(l, 1, dim, 0)};
      auto epi = [&](int, int n, const float (&v)[1]) {
        a.xres[n] = __float2bfloat16_rn(ldbf(a.xres + n) + v[0]);
      };
      TLG_SWITCH_FMT((int)a.qt_wo,
                     (gemv_stage<QT, 1, 1>(sm.g1, w, dim, nq, 1, (int)a.ks_wo,
                                           stage_bf16(a.ao, nq), epi,
                                           a.partial, a.counters)))
    }
    grid_sync(a.bar);
    // D: ffn norm + fused gate|up, mid = act(gate) * up
    {
      const float inv = rms_inv(a, buf);
      const Planes w[2] = {planes(l, 2, 2 * ffn, 0), planes(l, 2, 2 * ffn, ffn)};
      auto epi = [&](int, int n, const float (&v)[2]) {
        a.mid[n] = __float2bfloat16_rn(act_fn(v[0], (int)a.act) * v[1]);
      };
      TLG_SWITCH_FMT((int)a.qt_gu,
                     (gemv_stage<QT, 1, 2>(sm.g2, w, ffn, dim, 1, (int)a.ks_gu,
                                           stage_norm(a.ffn_norm + (size_t)l * dim, inv),
                                           epi, a.partial, a.counters)))
    }
    grid_sync(a.bar);
    // E: down projection + residual
    {
      const Planes w[1] = {planes(l, 3, dim, 0)};
      const bool final_layer = l == L - 1;
      auto epi = [&](int, int n, const float (&v)[1]) {
        const float r = bf16r(ldbf(a.xres + n) + v[0]);
        a.xres[n] = __float2bfloat16_rn(r);
        if (final_layer) a.x_out[n] = r;
      };
      TLG_SWITCH_FMT((int)a.qt_dn,
                     (gemv_stage<QT, 1, 1>(sm.g1, w, dim, ffn, 1, (int)a.ks_dn,
                                           stage_bf16(a.mid, ffn), epi,
                                           a.partial, a.counters)))
    }
    if (l < L - 1) grid_sync(a.bar);
  }
}

}  // namespace

// The grid of the launch (*blocks), from the card's SM count and the
// kernel's occupancy; an error code when the card cannot run a cooperative
// launch of it.
extern "C" int tl_mega_blocks(int* blocks) {
  return coop_blocks((const void*)mega_decode_kernel, 0, MAX_BLOCKS_PER_SM,
                     blocks);
}

// One decode step (see MegaArgs for the operands). `blocks` must be what
// tl_mega_blocks gave. Returns the launch's CUDA error code.
extern "C" int tl_mega_decode(const MegaArgs* args, int blocks, void* stream) {
  const MegaArgs& a = *args;
  const int slices_dim = (int)((a.dim + SLICE - 1) / SLICE);
  const int slices_nq = (int)((a.H * a.hd + SLICE - 1) / SLICE);
  const int slices_ffn = (int)((a.ffn + SLICE - 1) / SLICE);
  if (a.L < 1 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv || a.hd < 2 ||
      a.hd > MAX_HD || a.dim % 256 || (a.H * a.hd) % 256 || a.ffn % 256 ||
      ((a.H + 2 * a.Hkv) * a.hd) % TILE_N || a.S < 1 || a.nch < 1 ||
      a.chunk < 1 || a.chunk > MAX_CHUNK || a.nch * a.chunk < a.S ||
      a.cell < 0 || a.cell >= a.S || a.rope_kind < 0 || a.rope_kind > 2 ||
      a.act < 0 || a.act > 2 || !known_format(a.qt_qkv) ||
      !known_format(a.qt_wo) || !known_format(a.qt_gu) ||
      !known_format(a.qt_dn) || a.ks_qkv < 1 || a.ks_qkv > slices_dim ||
      a.ks_wo < 1 || a.ks_wo > slices_nq || a.ks_gu < 1 ||
      a.ks_gu > slices_dim || a.ks_dn < 1 || a.ks_dn > slices_ffn ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  MegaArgs copy = a;
  void* kargs[] = {&copy};
  return (int)cudaLaunchCooperativeKernel((const void*)mega_decode_kernel,
                                          dim3(blocks), dim3(NT), kargs, 0,
                                          (cudaStream_t)stream);
}
