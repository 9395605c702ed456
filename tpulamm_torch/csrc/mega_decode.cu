// mega_decode.cu -- one decode step through every layer in one launch.
//
// Replaces tpulamm/ops/pallas_decode.py::mega_decode_layers (kernel body
// _make_kernel), the TPU's single-launch decode of a llama-family stack:
// per layer, rms norm + fused QKV; rope + attention over the cache and the
// current token; wo + residual; ffn norm + gate|up; act * up, down +
// residual. B0 = 1: the single-stream decode step.
//
// Numerics are the JAX kernel's rounding points: the residual stream and
// the normed activations in bf16 (the products take them against the
// dequantized weights with f32 sums); q, k, v after rope rounded to bf16
// for attention; cache scores bf16 x bf16 with f32 sums, times 1/sqrt(hd);
// the live mask kpos >= 0 & kpos <= qpos; the current token merged
// analytically (its score from the bf16 q and k, its bf16 v); p rounded to
// bf16 for the PV product, the denominator from the f32 p; the attention
// output, mid = act(gate) * up and each residual add rounded to bf16. The
// new K / V rows leave as f32 (k_new, v_new) and, rounded to bf16, are
// written into the cache in place at `cell` (whose position is still -1
// during the step, so no block reads it). The position and the cell are
// read from two int32 device words, as the JAX kernel takes qpos from an
// array (pallas_decode.py:345), so a captured launch reads each step's own;
// a cell outside the span sets the error word and the launch writes
// nothing.
//
// What bounds it on an H100: the bytes of every layer's planes plus the
// live K / V rows, read once a step (LLaMA-7B Q4_0 at span 1024: 4.05 GB
// of planes + 0.54 GB of bf16 K/V, ~1.4 ms at 3.35 TB/s).
//
// Design: one cooperative launch, one block of 8 warps an SM (every block
// resident, so grid barriers cannot deadlock; 255 registers a thread and
// ~140 KB of shared memory for the products' rings); a grid barrier
// between the five phases of a layer, 5 L in all (gemv_stage.cuh's
// grid_sync). The four products run on the tensor cores through
// gemv_tc.cuh::tc_gemv, their work spread over every warp of the grid;
// the planes are read in place through a table of
// per-layer pointers (no stacked copy), copied into shared memory a layer
// ahead. Each block stages a product's x once into shared memory (phases
// A and D recompute the rms norm for themselves, from the norm weight the
// phase before put into L2, so no barrier is spent on it). Phase B is split
// over heads x chunks of S, one item a block: a warp reads 32 / (hd / 8)
// keys with one 16-byte load a lane, NB rows a lane in flight, for the
// scores and again for p V; the last item of a head merges the chunks and
// the current token in chunk order. Every reduction runs in a fixed order
// without float atomics, so two runs give the same tokens. The TL_START /
// TL_MARK points are empty here; tools/mega_ablation.py's timeline build
// stamps them.

#include <cuda_bf16.h>

#include "gemv_tc.cuh"

namespace {

using namespace tlg;

constexpr float NEG_INF = -1e30f;
constexpr int MAX_HD = 256, MAX_CHUNK = 2048;
constexpr int MAX_BLOCKS_PER_SM = 1;
static_assert(NT >= MAX_HD, "phase B's merge gives each thread one element");

}  // namespace

// Every field is 8 bytes wide (ops/mega_decode.py builds the same struct
// with ctypes).
struct MegaArgs {
  long long L, dim, H, Hkv, hd, ffn, S, act, rope_kind, n_rot;
  long long qt_qkv, qt_wo, qt_gu, qt_dn;        // formats of the 4 weights
  long long nch, chunk;                         // attention: chunks of S
  long long kv_hstride, kv_rstride;             // cache strides (elements)
  long long kv_vec;                             // K / V rows in 16-byte words
  double eps, scale;
  const int* qpos;          // the token's position (a device word)
  const int* cell;          // its cache cell, in [0, S) (a device word)
  int* err;                 // set to 1 when *cell is outside [0, S)
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
  float* partial;           // the products' warp sums (gemv_tc.cuh)
  unsigned int* counters;   // zeroed, >= max(tiles, H)
  unsigned int* bar;        // 2 zeroed words
};

namespace {

struct AttnSmem {
  float q[MAX_HD], k[MAX_HD], v[MAX_HD];   // this head's q, the token's k, v
  float s[MAX_CHUNK];                      // scores, then p, of the chunk
  int kp[MAX_CHUNK];                       // the chunk's cell positions
  float pv[WARPS * MAX_HD];                // the warps' p V sums
};

// dynamic shared memory of the kernel: the largest x of a product (a
// window of it past tlt::XCH chunks) or phase B's, then the warps' rings
// from ring_offset on
__host__ __device__ int ring_offset(long long kmax) {
  const int kch = (int)(kmax / 256 < tlt::XCH ? kmax / 256 : tlt::XCH);
  const int xb = tlt::x_smem_bytes(kch);
  const int b = xb > (int)sizeof(AttnSmem) ? xb : (int)sizeof(AttnSmem);
  return (b + 127) / 128 * 128;
}
int mega_smem(long long kmax) { return ring_offset(kmax) + tlt::RING_BYTES; }

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ldbf(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// block-wide sum / max in a fixed order; every thread gets the result
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

// the 8 floats of 8 bf16 in a 16-byte word
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
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

// What a lane holds of one cache row: EPL = 8 elements in one 16-byte
// word (hd % 8 == 0, rows 16-byte aligned) or, otherwise, one element at
// each of up to 8 places.
template <int EPL> struct RowFrag;
template <> struct RowFrag<8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* row, int dl,
                                       int hd, bool on) {
    u = on && 8 * dl < hd ? __ldg(reinterpret_cast<const uint4*>(row + 8 * dl))
                          : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ float at(int e) const {   // element 8 dl + e
    const uint32_t w = e < 2 ? u.x : (e < 4 ? u.y : (e < 6 ? u.z : u.w));
    return __uint_as_float((e & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
};
template <> struct RowFrag<1> {
  unsigned short u[8];
  __device__ __forceinline__ void load(const __nv_bfloat16* row, int dl,
                                       int hd, bool on) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int d = 32 * m + dl;
      u[m] = on && d < hd ? __ldg(reinterpret_cast<const unsigned short*>(row + d))
                          : (unsigned short)0;
    }
  }
  __device__ __forceinline__ float at(int m) const {   // element 32 m + dl
    return __uint_as_float((uint32_t)u[m] << 16);
  }
};

// phase B: attention of every head, items (head, chunk of S). A row of hd
// elements is read by LPR lanes (8 with hd 64, 16 with 128, 32 with 256;
// 32 when EPL = 1), so a warp reads RPI = 32 / LPR rows at once, and each
// lane loads NB rows before it uses them.
template <int EPL>
__device__ __noinline__ void attention(const MegaArgs& a, int l, int qpos,
                                       int cell, const __nv_bfloat16* Kc,
                                       const __nv_bfloat16* Vc, AttnSmem& sm,
                                       float* buf) {
  __shared__ bool last;
  constexpr int NB = EPL == 8 ? 16 : 1, NE = 8;  // rows, elements a lane
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = (int)a.H, Hkv = (int)a.Hkv, hd = (int)a.hd, S = (int)a.S;
  const int G = H / Hkv, nq = H * hd, nkv = Hkv * hd;
  const int nch = (int)a.nch, chunk = (int)a.chunk;
  const float scale = (float)a.scale;
  const long long hs = a.kv_hstride, rs = a.kv_rstride;
  int LPR = 32;
  if (EPL == 8) {
    LPR = 1;
    while (LPR < hd / 8) LPR <<= 1;
  }
  const int RPI = 32 / LPR, sub = lane / LPR, dl = lane % LPR;
  const int rstep = WARPS * RPI;                 // rows of a pass of the block
  // element e of this lane's fragment of a row
  auto dof = [&](int e) { return EPL == 8 ? 8 * dl + e : 32 * e + dl; };
  for (int it = blockIdx.x; it < H * nch; it += gridDim.x) {
    const int h = it / nch, c = it - h * nch, j = h / G;
    __syncthreads();                    // sm is free
    const int i0 = c * chunk;
    const int n = max(0, min(chunk, S - i0));
    for (int d = tid; d < hd; d += NT) {
      sm.q[d] = bf16r(rope_at(a, a.qkv, a.cosq, a.sinq, h * hd, d));
      sm.k[d] = rope_at(a, a.qkv + nq, a.cosk, a.sink, j * hd, d);
      sm.v[d] = __ldcg(a.qkv + nq + nkv + j * hd + d);
    }
    for (int r = tid; r < n; r += NT) sm.kp[r] = __ldg(a.kpos + i0 + r);
    __syncthreads();
    TL_MARK(10);
    if (c == 0 && h == j * G) {         // one block a KV head: the new row
      __nv_bfloat16* kr = (__nv_bfloat16*)Kc + j * hs + (long long)cell * rs;
      __nv_bfloat16* vr = (__nv_bfloat16*)Vc + j * hs + (long long)cell * rs;
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
    TL_MARK(11);
    const __nv_bfloat16* kh = Kc + j * hs + (long long)i0 * rs;
    const __nv_bfloat16* vh = Vc + j * hs + (long long)i0 * rs;
    float qr[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) qr[e] = dof(e) < hd ? sm.q[dof(e)] : 0.f;
    // the chunk's scores: NB rows a lane loaded, then summed over its LPR
    // lanes
    for (int base = warp * RPI; base < n; base += rstep * NB) {
      RowFrag<EPL> f[NB];
      bool live[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int r = base + sub + b * rstep;
        const int p = r < n ? sm.kp[r] : -1;
        live[b] = p >= 0 && p <= qpos;
        f[b].load(kh + (long long)r * rs, dl, hd, live[b]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < NE; ++e) acc = fmaf(qr[e], f[b].at(e), acc);
        for (int o = 1; o < LPR; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const int r = base + sub + b * rstep;
        if (dl == 0 && r < n) sm.s[r] = live[b] ? acc * scale : NEG_INF;
      }
    }
    __syncthreads();
    TL_MARK(12);
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
    TL_MARK(13);
    // p V over the chunk: each lane its rows, then the rows of a warp
    // (lanes of one dl) and the warps, in a fixed order
    float acc[NE] = {};
    for (int base = warp * RPI; base < n; base += rstep * NB) {
      RowFrag<EPL> f[NB];
      float pb[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int r = base + sub + b * rstep;
        pb[b] = r < n ? bf16r(sm.s[r]) : 0.f;
        f[b].load(vh + (long long)r * rs, dl, hd, pb[b] != 0.f);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[e] = fmaf(pb[b], f[b].at(e), acc[e]);
    }
#pragma unroll
    for (int e = 0; e < NE; ++e)
      for (int o = LPR; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    if (sub == 0) {
#pragma unroll
      for (int e = 0; e < NE; ++e)
        if (dof(e) < hd) sm.pv[warp * MAX_HD + dof(e)] = acc[e];
    }
    __syncthreads();
    TL_MARK(14);
    float* out = a.apart + ((size_t)h * nch + c) * (hd + 2);
    for (int d = tid; d < hd; d += NT) {
      float v = 0.f;
      for (int w = 0; w < WARPS; ++w) v += sm.pv[w * MAX_HD + d];
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
    TL_MARK(15);
    if (!last) continue;
    // the chunks' max and sum, then p V weighted by exp(max - m) in
    // tiles of MAX_CHUNK chunks through sm.s (any nch); thread d holds
    // element d of the output (NT >= MAX_HD)
    const float* ph = a.apart + (size_t)h * nch * (hd + 2);
    float m = sc;
    for (int q = tid; q < nch; q += NT) m = fmaxf(m, __ldcg(ph + q * (hd + 2)));
    m = block_reduce(m, buf, true);
    float den = 0.f;
    for (int q = tid; q < nch; q += NT)
      den += expf(__ldcg(ph + q * (hd + 2)) - m) * __ldcg(ph + q * (hd + 2) + 1);
    const float pc = expf(sc - m);
    den = block_reduce(den, buf, false) + pc;
    float o = 0.f;
    for (int q0 = 0; q0 < nch; q0 += MAX_CHUNK) {
      const int nt = min(MAX_CHUNK, nch - q0);
      __syncthreads();                  // sm.s is free
      for (int q = tid; q < nt; q += NT)
        sm.s[q] = expf(__ldcg(ph + (q0 + q) * (hd + 2)) - m);
      __syncthreads();
      if (tid < hd) {
        const float* pv = ph + (size_t)q0 * (hd + 2) + 2 + tid;
#pragma unroll 8
        for (int q = 0; q < nt; ++q) o += sm.s[q] * __ldcg(pv + (size_t)q * (hd + 2));
      }
    }
    if (tid < hd)
      a.ao[h * hd + tid] = __float2bfloat16_rn((o + pc * bf16r(sm.v[tid])) / den);
    if (tid == 0) a.counters[h] = 0u;
    TL_MARK(16);
  }
}

// The products' x and epilogues (gemv_tc.cuh's Ops), by phase: 0 = A
// (x the normed residual, y -> qkv), 1 = C (x = ao, y added to the
// residual), 2 = D (x the normed residual, mid = act(gate) * up), 3 = E
// (x = mid, y added to the residual, and to x_out after the last layer)
struct MegaOps {
  // x[e0 .. e1) into shared memory: bf16(xres * inv * w) or ao / mid as
  // they are; then, for a format with mins, the sums of 16 elements
  static __device__ __noinline__ void stage(const void* ctx, int phase, int l,
                               __nv_bfloat16* xs, float* s16, int e0, int e1,
                               bool sums) {
    const MegaArgs& a = *static_cast<const MegaArgs*>(ctx);
    __shared__ float red[WARPS];
    const int n = e1 - e0;
    uint4* x4 = reinterpret_cast<uint4*>(xs);
    if (phase == 0 || phase == 2) {
      const float* norm = (phase == 0 ? a.attn_norm : a.ffn_norm) + (size_t)l * a.dim;
      const int dim = (int)a.dim;
      // each thread's 8-element pieces of xres and the norm weight, all
      // loaded at once (up to MC pieces a thread; past that, again)
      constexpr int MC = 2;
      uint4 xr[MC];
      float4 w0[MC], w1[MC];
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        const int i = 8 * (threadIdx.x + k * NT);
        if (i < dim) {
          xr[k] = __ldcg(reinterpret_cast<const uint4*>(a.xres + i));
          w0[k] = __ldg(reinterpret_cast<const float4*>(norm + i));
          w1[k] = __ldg(reinterpret_cast<const float4*>(norm + i + 4));
        }
      }
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        if (8 * (threadIdx.x + k * NT) < dim) {
          float v[8];
          unpack8(xr[k], v);
#pragma unroll
          for (int e = 0; e < 8; ++e) ss = fmaf(v[e], v[e], ss);
        }
      }
      for (int i = 8 * (threadIdx.x + MC * NT); i < dim; i += 8 * NT) {
        float v[8];
        unpack8(__ldcg(reinterpret_cast<const uint4*>(a.xres + i)), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss = fmaf(v[e], v[e], ss);
      }
      const float inv =
          1.0f / sqrtf(block_reduce(ss, red, false) / (float)dim + (float)a.eps);
      auto put = [&](int i, const uint4& u, const float4& wa, const float4& wb) {
        float v[8];
        unpack8(u, v);
        const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(
              __fmul_rn(__fmul_rn(v[2 * e], inv), w[2 * e]),
              __fmul_rn(__fmul_rn(v[2 * e + 1], inv), w[2 * e + 1]));
          o[e] = *reinterpret_cast<const uint32_t*>(&b);
        }
        x4[(i - e0) / 8] = make_uint4(o[0], o[1], o[2], o[3]);
      };
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        const int i = 8 * (threadIdx.x + k * NT);
        if (i >= e0 && i < e1) put(i, xr[k], w0[k], w1[k]);
      }
      for (int i = 8 * (threadIdx.x + MC * NT); i < dim; i += 8 * NT)
        if (i >= e0 && i < e1)
          put(i, __ldcg(reinterpret_cast<const uint4*>(a.xres + i)),
              __ldg(reinterpret_cast<const float4*>(norm + i)),
              __ldg(reinterpret_cast<const float4*>(norm + i + 4)));
    } else {
      const uint4* s4 = reinterpret_cast<const uint4*>((phase == 1 ? a.ao : a.mid) + e0);
#pragma unroll 4
      for (int i = threadIdx.x; i < n / 8; i += NT) x4[i] = __ldcg(s4 + i);
    }
    __syncthreads();
    if (!sums) return;
    for (int j = threadIdx.x; j < n / 16; j += NT) {
      float f = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) f += __bfloat162float(xs[16 * j + i]);
      s16[j] = f;
    }
    __syncthreads();
  }
  static __device__ void epi(const void* ctx, int phase, int l, int n,
                             const float* v) {
    const MegaArgs& a = *static_cast<const MegaArgs*>(ctx);
    if (phase == 0) {
      a.qkv[n] = v[0];
    } else if (phase == 1) {
      a.xres[n] = __float2bfloat16_rn(ldbf(a.xres + n) + v[0]);
    } else if (phase == 2) {
      a.mid[n] = __float2bfloat16_rn(act_fn(v[0], (int)a.act) * v[1]);
    } else {
      const float r = bf16r(ldbf(a.xres + n) + v[0]);
      a.xres[n] = __float2bfloat16_rn(r);
      if (l == a.L - 1) a.x_out[n] = r;
    }
  }
};

// a vector of n floats that a coming phase reads, into L2 (one 128-byte
// line a thread)
__device__ __forceinline__ void prefetch_l2(const float* p, int n) {
  for (int i = (blockIdx.x * NT + threadIdx.x) * 32; i < n; i += gridDim.x * NT * 32)
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p + i));
}

// phase B: the 16-byte path where the head dim and the cache rows allow
__device__ __forceinline__ void attend(const MegaArgs& a, int l, int qpos,
                                       int cell, const __nv_bfloat16* Kc,
                                       const __nv_bfloat16* Vc, AttnSmem& sm,
                                       float* buf) {
  if (a.kv_vec) attention<8>(a, l, qpos, cell, Kc, Vc, sm, buf);
  else attention<1>(a, l, qpos, cell, Kc, Vc, sm, buf);
}

__global__ void __launch_bounds__(NT, MAX_BLOCKS_PER_SM)
    mega_decode_kernel(MegaArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float buf[WARPS];
  // the arguments in shared memory: read by every thread, held by none
  __shared__ MegaArgs a;
  __shared__ int qpos, cell;
  if (threadIdx.x == 0) {
    a = args;
    qpos = __ldcg(args.qpos);           // this step's, written before it
    cell = __ldcg(args.cell);
  }
  TL_START();
  __syncthreads();
  if (cell < 0 || cell >= a.S) {        // every block leaves, no write
    if (blockIdx.x == 0 && threadIdx.x == 0) *a.err = 1;
    return;
  }
  const int L = (int)a.L, dim = (int)a.dim, ffn = (int)a.ffn;
  const int nq = (int)(a.H * a.hd), nqkv = (int)((a.H + 2 * a.Hkv) * a.hd);
  const int tid = threadIdx.x;
  AttnSmem& at = *reinterpret_cast<AttnSmem*>(smem);
  long long kmax = a.dim > nq ? a.dim : nq;
  const int roff = ring_offset(kmax > a.ffn ? kmax : a.ffn);
  // the weights of layer l in pl[l & 1]: wqkv, wo, gate, up, down; its K
  // and V views in kv[l & 1]
  __shared__ Planes pl[2][5];
  __shared__ const __nv_bfloat16* kv[2][2];
  auto tables = [&](int l) {
    if (tid < 5) {
      const int w = tid < 3 ? tid : tid - 1;
      const long long* p = a.planes + (l * 4 + w) * 4;
      const int ld[5] = {nqkv, dim, 2 * ffn, 2 * ffn, dim};
      pl[l & 1][tid] = Planes{(const uint8_t*)p[0], (const uint8_t*)p[1],
                              (const void*)p[2], (const void*)p[3], ld[tid],
                              tid == 3 ? ffn : 0};
    } else if (tid < 7) {
      kv[l & 1][tid - 5] =
          (const __nv_bfloat16*)(tid == 5 ? a.kcache : a.vcache)[l];
    }
  };

  for (int i = blockIdx.x * NT + tid; i < dim; i += gridDim.x * NT)
    a.xres[i] = __float2bfloat16_rn(a.x[i]);
  tables(0);
  __syncthreads();
  prefetch_l2(a.attn_norm, dim);
  grid_sync(a.bar);


  for (int l = 0; l < L; ++l) {
    const Planes* w = pl[l & 1];
    // A: attention norm + fused QKV
    TLG_SWITCH_FMT((int)a.qt_qkv,
                   (tlt::tc_gemv<MegaOps, QT, 1>(smem, roff, w, nqkv, dim,
                                                 a.partial, a.counters, &a, 0, l)))
    grid_sync(a.bar);
    // B: rope + attention, the new K / V row into the cache
    attend(a, l, qpos, cell, kv[l & 1][0], kv[l & 1][1], at, buf);
    grid_sync(a.bar);
    // C: attention output projection + residual
    TLG_SWITCH_FMT((int)a.qt_wo,
                   (tlt::tc_gemv<MegaOps, QT, 1>(smem, roff, w + 1, dim, nq,
                                                 a.partial, a.counters, &a, 1, l)))
    prefetch_l2(a.ffn_norm + (size_t)l * dim, dim);
    grid_sync(a.bar);
    // D: ffn norm + fused gate|up, mid = act(gate) * up
    TLG_SWITCH_FMT((int)a.qt_gu,
                   (tlt::tc_gemv<MegaOps, QT, 2>(smem, roff, w + 2, ffn, dim,
                                                 a.partial, a.counters, &a, 2, l)))
    grid_sync(a.bar);
    // E: down projection + residual (the next layer's tables meanwhile)
    if (l + 1 < L) tables(l + 1);
    TLG_SWITCH_FMT((int)a.qt_dn,
                   (tlt::tc_gemv<MegaOps, QT, 1>(smem, roff, w + 4, dim, ffn,
                                                 a.partial, a.counters, &a, 3, l)))
    if (l + 1 < L) {
      prefetch_l2(a.attn_norm + (size_t)(l + 1) * dim, dim);
      grid_sync(a.bar);
    }
  }
}

}  // namespace

// The grid of the launch (*blocks) for a stack whose largest product K is
// kmax (max of dim, H hd, ffn), from the card's SM count and the kernel's
// occupancy at that shared memory; an error code when the card cannot run
// a cooperative launch of it.
extern "C" int tl_mega_blocks(long long kmax, int* blocks) {
  const int smem = mega_smem(kmax);
  cudaError_t e = cudaFuncSetAttribute(
      mega_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)                 // shared memory before L1: the rings
    e = cudaFuncSetAttribute(mega_decode_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return (int)e;
  return coop_blocks((const void*)mega_decode_kernel, smem, MAX_BLOCKS_PER_SM,
                     blocks);
}

// f32 elements of the products' scratch (MegaArgs::partial) for a
// launch of `blocks` blocks: tlt::partial_floats of the largest product.
extern "C" int tl_mega_scratch(const MegaArgs* args, int blocks,
                               long long* floats) {
  const MegaArgs& a = *args;
  const long long nq = a.H * a.hd, nqkv = (a.H + 2 * a.Hkv) * a.hd;
  const long long n[4][3] = {{nqkv, a.dim, 1}, {a.dim, nq, 1},
                             {a.ffn, a.dim, 2}, {a.dim, a.ffn, 1}};
  *floats = 0;
  for (const auto& p : n) {
    const long long f = tlt::partial_floats(p[0], p[1], (int)p[2], blocks);
    *floats = f > *floats ? f : *floats;
  }
  return 0;
}

// One decode step (see MegaArgs for the operands). `blocks` must be what
// tl_mega_blocks gave for max(dim, H hd, ffn). Returns the launch's CUDA
// error code.
extern "C" int tl_mega_decode(const MegaArgs* args, int blocks, void* stream) {
  const MegaArgs& a = *args;
  long long kmax = a.dim > a.H * a.hd ? a.dim : a.H * a.hd;
  kmax = kmax > a.ffn ? kmax : a.ffn;
  if (a.L < 1 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv || a.hd < 2 ||
      a.hd > MAX_HD || a.dim % 256 || (a.H * a.hd) % 256 || a.ffn % 256 ||
      ((a.H + 2 * a.Hkv) * a.hd) % TILE_N || a.S < 1 || a.nch < 1 ||
      a.chunk < 1 || a.chunk > MAX_CHUNK || a.nch * a.chunk < a.S ||
      !a.qpos || !a.cell || !a.err || a.rope_kind < 0 || a.rope_kind > 2 ||
      a.act < 0 || a.act > 2 || !known_format(a.qt_qkv) ||
      !known_format(a.qt_wo) || !known_format(a.qt_gu) ||
      !known_format(a.qt_dn) || (a.kv_vec && a.hd % 8) || blocks < 1 ||
      (kmax / 256 + tlt::XCH - 1) / tlt::XCH > blocks)
    return (int)cudaErrorInvalidValue;
  const int smem = mega_smem(kmax);
  if (smem > 48 * 1024) {               // another stack may have set less
    const cudaError_t e = cudaFuncSetAttribute(
        mega_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  MegaArgs copy = a;
  void* kargs[] = {&copy};
  return (int)cudaLaunchCooperativeKernel((const void*)mega_decode_kernel,
                                          dim3(blocks), dim3(NT), kargs, smem,
                                          (cudaStream_t)stream);
}
