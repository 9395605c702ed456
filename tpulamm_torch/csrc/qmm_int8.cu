// qmm_int8.cu -- int8-activation gemv over the repack "mm" planes.
//
// Replaces tpulamm/ops/pallas_qmm.py::_qmm_int8_call (kernel body
// _make_int8_kernel) and its XLA prologue _quantize_acts: the TPU path
// behind every decode projection (M <= 16); and _qmm_int8_call_inkq (body
// _make_int8_kernel_inkq), the same product with the activation
// quantization inside the one launch (tl_qmm_int8_inkq, below).
//
//   launch 1, quantize_acts: per (row, group) of x (group 32; 16 for Q2_K)
//     s = amax * (1/127) (1 where 0), qx = rint(x / s) clipped to +-127,
//     and the exact f32 group sum gsum.
//   launch 2, gemv:
//     out[m, n] = sum_g sx[m, g] * sw[g, n] * idot[g, m, n]
//               + sum_g gsum[m, g] * (min[g, n] - zero * sw[g, n])
//     idot = int32 dot of the activation codes with the RAW weight codes
//     (Q4_x 0..15, Q5_x 0..31, Q8_0 signed, Q2_K crumbs 0..3), by __dp4a.
//
// What bounds it on an H100: a decode step reads every weight plane once
// (~0.6 B/weight for Q4_0) and does 2*M*K*N operations, so at M <= 16 it
// is bound by the bytes it moves; the floor is plane bytes / 3.35 TB/s.
//
// Design for that bound: a warp owns 128 columns, four per lane, so each
// plane row is read as one coalesced 512-byte line of 32-bit words; the 4
// words of 4 consecutive rows are transposed in registers (__byte_perm) to
// give each column a word of 4 consecutive-k codes for __dp4a. The work
// along K is cut into units of 32 plane rows (one pair of scale groups,
// or four Q2_K groups); the 8 warps of a block take different units of
// the same columns, and `ks` blocks split the units further so that even
// N = 4096 fills the card. The warps' sums meet in shared memory; the ks
// partial sums go to a scratch buffer and the block that finishes last
// adds them in a fixed order (a counter per column tile, reset by that
// block), so the result does not depend on the blocks' timing.
// The prologue divides by s (no reciprocal) and rounds half to even
// (rintf), so its codes equal the plain version's.
//
// In-kernel quantization (tl_qmm_int8_inkq): there is no prologue launch.
// The 8 warps of a block take units 8q .. 8q+7 of K for q = blockIdx.y,
// blockIdx.y + ks, ...: each q is one 512-element slice of K (two chunks).
// Before its warps read slice q, the block quantizes that slice of its
// own rows into shared memory with the prologue's code (quant_group), so
// the codes, scales and sums, and the order of every sum after them, are
// those of the two-launch path: the output is bit-identical to it. Each
// block quantizes only what it reads; the blocks of other column tiles
// repeat that small work (M * 512 values per slice) instead of waiting on
// a launch.

#include "quant_planes.cuh"

namespace {

using namespace tlq;

constexpr int WARPS = 8, NT = 32 * WARPS, TILE_N = 128;
constexpr int SLICE = 512;       // K elements a block quantizes at a time

// ---------------------------------------------------------------- prologue
// one activation group of GA values at xp -> codes at qp, scale, exact sum
template <int GA>
__device__ __forceinline__ void quant_group(const float* __restrict__ xp,
                                            int8_t* __restrict__ qp,
                                            float& s, float& sum) {
  float v[GA];
  float amax = 0.f, acc = 0.f;
#pragma unroll
  for (int i = 0; i < GA; ++i) {
    v[i] = xp[i];
    amax = fmaxf(amax, fabsf(v[i]));
    acc = __fadd_rn(acc, v[i]);
  }
  float sc = __fmul_rn(amax, 1.0f / 127.0f);
  if (!(sc > 0.f)) sc = 1.0f;
#pragma unroll
  for (int i = 0; i < GA; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], sc)), -127.f), 127.f);
    qp[i] = (int8_t)q;
  }
  s = sc;
  sum = acc;
}

template <int GA>
__global__ void quantize_acts_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ qx,
                                     float* __restrict__ sx,
                                     float* __restrict__ gsum, int M, int K) {
  const int G = K / GA;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * G) return;
  const int m = idx / G, g = idx - m * G;
  quant_group<GA>(x + (size_t)m * K + (size_t)g * GA,
                  qx + (size_t)m * K + (size_t)g * GA, sx[idx], gsum[idx]);
}

// ---------------------------------------------------------------- gemv
// Where the gemv reads the activation codes, scales and sums (row m is
// the absolute row, k and g absolute element and group indices): the
// prologue's arrays in device memory, or one block's quantized slice in
// shared memory.
struct GlobalActs {
  const int8_t* __restrict__ qx;
  const float* __restrict__ sx;
  const float* __restrict__ gsum;
  int K, G;
  __device__ int word(int m, int k) const {
    return __ldg(reinterpret_cast<const int*>(qx + (size_t)m * K + k));
  }
  __device__ float scale(int m, int g) const { return sx[(size_t)m * G + g]; }
  __device__ float sum(int m, int g) const { return gsum[(size_t)m * G + g]; }
};

template <int GA>
struct SliceActs {
  static constexpr int GPS = SLICE / GA;         // groups per slice
  const int8_t* q;                               // [MT][SLICE]
  const float* s;                                // [MT][GPS]
  const float* gs;                               // [MT][GPS]
  int m0, k0;                                    // first row, first element
  __device__ int word(int m, int k) const {
    return *reinterpret_cast<const int*>(q + (m - m0) * SLICE + (k - k0));
  }
  __device__ float scale(int m, int g) const {
    return s[(m - m0) * GPS + g - k0 / GA];
  }
  __device__ float sum(int m, int g) const {
    return gs[(m - m0) * GPS + g - k0 / GA];
  }
};

// scale and offset (min - zero * scale) of global group G at columns n..n+3
template <int QT>
__device__ __forceinline__ void group_scales(const void* __restrict__ sa,
                                             const void* __restrict__ sb,
                                             int G, int N, int n, float sw[4],
                                             float off[4]) {
  if constexpr (QT == Q2_K) {
    const uint32_t b4 = ld32((const uint8_t*)sa, (size_t)G, N, n);
    const int c = G >> 4;
    const unsigned short* dm = (const unsigned short*)sb;
    const ushort4 d4 = *reinterpret_cast<const ushort4*>(dm + (size_t)(8 * c) * N + n);
    const ushort4 m4 =
        *reinterpret_cast<const ushort4*>(dm + (size_t)(8 * c + 1) * N + n);
    const unsigned short dv[4] = {d4.x, d4.y, d4.z, d4.w};
    const unsigned short mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int byte = (b4 >> (8 * j)) & 0xFF;
      const float d = __half2float(__ushort_as_half(dv[j]));
      const float dmin = __half2float(__ushort_as_half(mv[j]));
      sw[j] = __fmul_rn((float)(byte & 15), d);
      off[j] = __fmul_rn((float)(byte >> 4), -dmin);
    }
  } else {
    const float4 s4 = *reinterpret_cast<const float4*>(
        (const float*)sa + (size_t)G * N + n);
    sw[0] = s4.x; sw[1] = s4.y; sw[2] = s4.z; sw[3] = s4.w;
    float4 m4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (Fmt<QT>::has_min)
      m4 = *reinterpret_cast<const float4*>((const float*)sb + (size_t)G * N + n);
    const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      off[j] = __fadd_rn(__fmul_rn(-Fmt<QT>::zero, sw[j]), mv[j]);
  }
}

// acc[m][j] += (idot * sw) * sx + gsum * off for one group
template <int QT, int MT, class A>
__device__ __forceinline__ void rescale(float acc[MT][4], const int idot[MT][4],
                                        const A& act,
                                        const void* __restrict__ sa,
                                        const void* __restrict__ sb, int G,
                                        int N, int n, int m0, int M) {
  float sw[4], off[4];
  group_scales<QT>(sa, sb, G, N, n, sw, off);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) break;
    const float s = act.scale(m0 + m, G);
    const float gs = Fmt<QT>::corr ? act.sum(m0 + m, G) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[m][j] += __fmul_rn(__fmul_rn((float)idot[m][j], sw[j]), s);
      if constexpr (Fmt<QT>::corr) acc[m][j] += __fmul_rn(gs, off[j]);
    }
  }
}

// activation word (4 codes at k..k+3) of row m0 + m, zero past M
template <int MT, class A>
__device__ __forceinline__ void act_words(const A& act, int k, int m0, int M,
                                          int out[MT]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) out[m] = (m0 + m < M) ? act.word(m0 + m, k) : 0;
}

// one unit = 32 plane rows of 256-element chunk c, sub-block u in 0..3
template <int QT, int MT, class A>
__device__ __forceinline__ void do_unit(float acc[MT][4], int c, int u,
                                        const A& act,
                                        const uint8_t* __restrict__ qa,
                                        const uint8_t* __restrict__ qb,
                                        const void* __restrict__ sa,
                                        const void* __restrict__ sb,
                                        int M, int N, int n, int m0) {
  const int kc = 256 * c;
  if constexpr (QT == Q2_K) {
    // q2 rows 64c + 16u + 4i + b hold crumb t = element 64t + 16u + 4i + b,
    // which lies in group 16c + 4t + u
    int idot[4][MT][4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t col[4];
      load_cols(qa, (size_t)(64 * c + 16 * u + 4 * i), N, n, col);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int xw[MT];
        act_words<MT>(act, kc + 64 * t + 16 * u + 4 * i, m0, M, xw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int code = (int)((col[j] >> (2 * t)) & 0x03030303u);
#pragma unroll
          for (int m = 0; m < MT; ++m) idot[t][m][j] = __dp4a(code, xw[m], idot[t][m][j]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      rescale<QT, MT>(acc, idot[t], act, sa, sb, 16 * c + 4 * t + u, N, n,
                      m0, M);
  } else {
    // groups u (k in [32u, 32u+32)) and u + 4 (k in [128+32u, 160+32u))
    int lo[MT][4] = {}, hi[MT][4] = {};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = 32 * u + 4 * i;  // element offset of the low group
      uint32_t cl[4], ch[4];
      if constexpr (QT == Q8_0) {
        load_cols(qa, (size_t)(kc + e), N, n, cl);
        load_cols(qa, (size_t)(kc + 128 + e), N, n, ch);
      } else {
        uint32_t col[4];
        load_cols(qa, (size_t)(128 * c + e), N, n, col);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cl[j] = col[j] & 0x0F0F0F0Fu;
          ch[j] = (col[j] >> 4) & 0x0F0F0F0Fu;
        }
        if constexpr (QT == Q5_0 || QT == Q5_1) {
          // qh row 32c + s, bit t = element s + 32t of the chunk
          uint32_t hb[4];
          load_cols(qb, (size_t)(32 * c + 4 * i), N, n, hb);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cl[j] |= ((hb[j] >> u) & 0x01010101u) << 4;
            ch[j] |= ((hb[j] >> (u + 4)) & 0x01010101u) << 4;
          }
        }
      }
      int xl[MT], xh[MT];
      act_words<MT>(act, kc + e, m0, M, xl);
      act_words<MT>(act, kc + 128 + e, m0, M, xh);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[m][j] = __dp4a((int)cl[j], xl[m], lo[m][j]);
          hi[m][j] = __dp4a((int)ch[j], xh[m], hi[m][j]);
        }
    }
    rescale<QT, MT>(acc, lo, act, sa, sb, 8 * c + u, N, n, m0, M);
    rescale<QT, MT>(acc, hi, act, sa, sb, 8 * c + u + 4, N, n, m0, M);
  }
}

// x: the f32 activations when INKQ (quantized here, slice by slice), else
// unused and qx / sx / gsum hold the prologue's output
template <int QT, int MT, bool INKQ>
__global__ void __launch_bounds__(NT)
qmm_int8_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
                const float* __restrict__ gsum, const float* __restrict__ x,
                const uint8_t* __restrict__ qa,
                const uint8_t* __restrict__ qb, const void* __restrict__ sa,
                const void* __restrict__ sb, float* __restrict__ out,
                float* __restrict__ partial, unsigned int* __restrict__ counters,
                int M, int N, int K) {
  __shared__ float red[WARPS][MT][TILE_N];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * TILE_N, n = n0 + 4 * lane;
  const int m0 = blockIdx.z * MT;
  const int ks = gridDim.y;
  const int units = (K / 256) * 4;
  float acc[MT][4] = {};
  if constexpr (!INKQ) {
    const GlobalActs act{qx, sx, gsum, K, K / Fmt<QT>::group};
    for (int s = blockIdx.y * WARPS + warp; s < units; s += ks * WARPS)
      do_unit<QT, MT>(acc, s >> 2, s & 3, act, qa, qb, sa, sb, M, N, n, m0);
  } else {
    // slice q holds units 8q .. 8q+7, so warp w takes unit 8q + w: the
    // same units in the same order as above
    static_assert(SLICE / 64 == WARPS, "one unit of 64 elements a warp");
    constexpr int GA = Fmt<QT>::group, GPS = SLICE / GA;
    __shared__ __align__(16) int8_t sq[MT * SLICE];
    __shared__ float ssx[MT * GPS], sgs[MT * GPS];
    for (int q = blockIdx.y; q * SLICE < K; q += ks) {
      const int k0 = q * SLICE;
      __syncthreads();                       // the last slice is read
      for (int i = threadIdx.x; i < MT * GPS; i += NT) {
        const int m = i / GPS, g = i - m * GPS;
        if (m0 + m < M && k0 + g * GA < K)
          quant_group<GA>(x + (size_t)(m0 + m) * K + k0 + g * GA,
                          sq + m * SLICE + g * GA, ssx[i], sgs[i]);
      }
      __syncthreads();
      const int s = q * WARPS + warp;
      if (s < units)
        do_unit<QT, MT>(acc, s >> 2, s & 3, SliceActs<GA>{sq, ssx, sgs, m0, k0},
                        qa, qb, sa, sb, M, N, n, m0);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][4 * lane + j] = acc[m][j];
  __syncthreads();
  // block sum over warps in a fixed order
  float* dst = ks == 1 ? out : partial + (size_t)blockIdx.y * M * N;
  for (int i = threadIdx.x; i < MT * TILE_N; i += NT) {
    const int m = i / TILE_N, col = i - m * TILE_N;
    if (m0 + m >= M) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][m][col];
    dst[(size_t)(m0 + m) * N + n0 + col] = v;
  }
  if (ks == 1) return;
  // the last of the ks blocks of this column tile adds the partials
  __threadfence();
  __syncthreads();
  const int cidx = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(&counters[cidx], 1u) == (unsigned)(ks - 1);
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < MT * TILE_N; i += NT) {
    const int m = i / TILE_N, col = i - m * TILE_N;
    if (m0 + m >= M) continue;
    const size_t o = (size_t)(m0 + m) * N + n0 + col;
    float v = 0.f;
    for (int b = 0; b < ks; ++b) v += __ldcg(partial + (size_t)b * M * N + o);
    out[o] = v;
  }
  if (threadIdx.x == 0) counters[cidx] = 0u;
}

template <int QT, int MT, bool INKQ>
void launch_gemv(const void* qx, const void* sx, const void* gsum,
                 const void* x, const void* qa, const void* qb, const void* sa,
                 const void* sb, void* out, void* partial, void* counters,
                 int M, int N, int K, int ks, cudaStream_t st) {
  dim3 grid(N / TILE_N, ks, (M + MT - 1) / MT);
  qmm_int8_kernel<QT, MT, INKQ><<<grid, NT, 0, st>>>(
      (const int8_t*)qx, (const float*)sx, (const float*)gsum,
      (const float*)x, (const uint8_t*)qa, (const uint8_t*)qb, sa, sb,
      (float*)out, (float*)partial, (unsigned int*)counters, M, N, K);
}

template <int QT, bool INKQ>
void launch_fmt(const void* qx, const void* sx, const void* gsum,
                const void* x, const void* qa, const void* qb, const void* sa,
                const void* sb, void* out, void* partial, void* counters,
                int M, int N, int K, int ks, cudaStream_t st) {
  if (M == 1)
    launch_gemv<QT, 1, INKQ>(qx, sx, gsum, x, qa, qb, sa, sb, out, partial,
                             counters, M, N, K, ks, st);
  else
    launch_gemv<QT, 4, INKQ>(qx, sx, gsum, x, qa, qb, sa, sb, out, partial,
                             counters, M, N, K, ks, st);
}

template <bool INKQ>
int launch_qtype(int qtype, const void* qx, const void* sx, const void* gsum,
                 const void* x, const void* qa, const void* qb,
                 const void* sa, const void* sb, void* out, void* partial,
                 void* counters, int M, int N, int K, int ks, void* stream) {
  if (M <= 0 || M > 16 || N % TILE_N != 0 || K % 256 != 0 || ks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define TL_FMT(Q)                                                            \
  case Q:                                                                    \
    launch_fmt<Q, INKQ>(qx, sx, gsum, x, qa, qb, sa, sb, out, partial,       \
                        counters, M, N, K, ks, st);                          \
    break;
  switch (qtype) {
    TL_FMT(Q4_0)
    TL_FMT(Q4_1)
    TL_FMT(Q5_0)
    TL_FMT(Q5_1)
    TL_FMT(Q8_0)
    TL_FMT(Q2_K)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TL_FMT
  return (int)cudaGetLastError();
}

}  // namespace

// Launch 1: x (M, K) f32 -> qx (M, K) int8, sx / gsum (M, K / group) f32.
extern "C" int tl_quantize_acts(const void* x, void* qx, void* sx, void* gsum,
                                int M, int K, int group, void* stream) {
  if (M <= 0 || K % group != 0) return (int)cudaErrorInvalidValue;
  const int total = M * (K / group);
  const int threads = 128, blocks = (total + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (group == 32)
    quantize_acts_kernel<32><<<blocks, threads, 0, st>>>(
        (const float*)x, (int8_t*)qx, (float*)sx, (float*)gsum, M, K);
  else if (group == 16)
    quantize_acts_kernel<16><<<blocks, threads, 0, st>>>(
        (const float*)x, (int8_t*)qx, (float*)sx, (float*)gsum, M, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Launch 2: the gemv. Planes as in qmm.cu (qa: qs / q2 / q8; qb: qh or
// null; sa: scales or Q2_K scd; sb: mins or Q2_K dm or null). partial:
// (ks, M, N) f32 scratch, used when ks > 1; counters: one zeroed uint32
// per (N / 128) * ceil(M / mt) column tile, left zeroed on return.
extern "C" int tl_qmm_int8(int qtype, const void* qx, const void* sx,
                           const void* gsum, const void* qa, const void* qb,
                           const void* sa, const void* sb, void* out,
                           void* partial, void* counters, int M, int N, int K,
                           int ks, void* stream) {
  return launch_qtype<false>(qtype, qx, sx, gsum, nullptr, qa, qb, sa, sb,
                             out, partial, counters, M, N, K, ks, stream);
}

// The gemv alone, quantizing x (M, K) f32 inside the launch; the other
// arguments as for tl_qmm_int8. Gives tl_quantize_acts + tl_qmm_int8's
// output bit for bit.
extern "C" int tl_qmm_int8_inkq(int qtype, const void* x, const void* qa,
                                const void* qb, const void* sa, const void* sb,
                                void* out, void* partial, void* counters,
                                int M, int N, int K, int ks, void* stream) {
  return launch_qtype<true>(qtype, nullptr, nullptr, nullptr, x, qa, qb, sa,
                            sb, out, partial, counters, M, N, K, ks, stream);
}
