// gemv_stage.cuh -- the pieces of a kernel that runs several dependent
// decode products in ONE cooperative launch (ffn_fused.cu, mega_decode.cu):
//
//   unit_f32    f32 activations x a 64-element unit of the mm planes
//   gemv_stage  one split-K product y = x @ W as work items spread over the
//               grid, with a caller's staging of x and epilogue of y
//   grid_sync   a barrier of every block of the grid
//
// The activations stay f32 (as the JAX kernels keep them on the TPU) and
// each weight is dequantized exactly as the plain version does
// (quant_planes.cuh::dequant), so a product differs from the plain one
// only in the order of its f32 sums.
//
// What bounds such a product on an H100 at M <= 16: the bytes of the
// planes (about 0.56 B a weight for Q4_0); each is read once. Design for
// that: a warp owns 128 columns, four a lane, and reads each plane row as
// one 512-byte line of 32-bit words (qmm_int8.cu's layout: units of 32
// plane rows, 4x4 byte transposes); K is cut into slices of 512 elements,
// one unit a warp, so a block streams 8 units of one slice at a time.
// Items (column tile, K split, row tile) are spread over the grid so that
// the 32 column tiles of a dim-4096 output still fill 132 SMs. The split
// sums meet in a scratch buffer; the block that finishes an item last adds
// them in a fixed order, so a result never depends on the blocks' timing.

#pragma once

#include "quant_planes.cuh"

namespace tlg {

using namespace tlq;

constexpr int WARPS = 8, NT = 32 * WARPS, TILE_N = 128, SLICE = 512;

// one weight matrix: its planes, the plane row length (the matrix's N) and
// the first column of this view (the up half of a fused gate|up)
struct Planes {
  const uint8_t* qa;    // qs / q2 / q8
  const uint8_t* qb;    // qh (Q5_x) or null
  const void* sa;       // scales (Q2_K: scd)
  const void* sb;       // mins (Q2_K: dm) or null
  int ld, off;
};

// acc[m][j] += x[m][k] * w[k][n + j] for the 4 elements k = kk .. kk + 3
// of the staged slice (w4[b][j] is the weight of element kk + b)
template <int MT>
__device__ __forceinline__ void fma_rows(float acc[MT][4],
                                         const float* __restrict__ xs, int kk,
                                         const float w4[4][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + m * SLICE + kk);
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xa[b], w4[b][j], acc[m][j]);
  }
}

// unit (c, u): the 64 elements of 256-chunk c that 32 plane rows hold
// (Q2_K: 16 rows), at columns n .. n + 3 of the view; xs holds the slice
// starting at element k0
template <int QT, int MT>
__device__ __forceinline__ void unit_f32(float acc[MT][4], int c, int u,
                                         const float* __restrict__ xs, int k0,
                                         const Planes& p, int n) {
  const int kc = 256 * c, N = p.ld, col = p.off + n;
  if constexpr (QT == Q2_K) {
    // q2 rows 64c + 16u + 4i + b hold crumb t = element 64t + 16u + 4i + b
    // of the chunk, in group 16c + 4t + u
    float s[4][4], mn[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        group_scale<QT>(p.sa, p.sb, kc + 64 * t + 16 * u, col + j, N, s[t][j],
                        mn[t][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t cw[4];
      load_cols(p.qa, (size_t)(64 * c + 16 * u + 4 * i), N, col, cw);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float w4[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w4[b][j] = dequant<QT>((int)((cw[j] >> (8 * b + 2 * t)) & 3u),
                                   s[t][j], mn[t][j]);
        fma_rows<MT>(acc, xs, kc + 64 * t + 16 * u + 4 * i - k0, w4);
      }
    }
  } else {
    // groups 8c + u (elements 32u ..) and 8c + u + 4 (128 + 32u ..)
    float slo[4], mlo[4], shi[4], mhi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      group_scale<QT>(p.sa, p.sb, kc + 32 * u, col + j, N, slo[j], mlo[j]);
      group_scale<QT>(p.sa, p.sb, kc + 128 + 32 * u, col + j, N, shi[j],
                      mhi[j]);
    }
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const int e = 32 * u + 4 * i;  // element offset of the low group
      uint32_t cl[4], ch[4];
      if constexpr (QT == Q8_0) {
        load_cols(p.qa, (size_t)(kc + e), N, col, cl);
        load_cols(p.qa, (size_t)(kc + 128 + e), N, col, ch);
      } else {
        uint32_t cw[4];
        load_cols(p.qa, (size_t)(128 * c + e), N, col, cw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cl[j] = cw[j] & 0x0F0F0F0Fu;
          ch[j] = (cw[j] >> 4) & 0x0F0F0F0Fu;
        }
        if constexpr (QT == Q5_0 || QT == Q5_1) {
          // qh row 32c + s, bit t = element s + 32t of the chunk
          uint32_t hb[4];
          load_cols(p.qb, (size_t)(32 * c + 4 * i), N, col, hb);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cl[j] |= ((hb[j] >> u) & 0x01010101u) << 4;
            ch[j] |= ((hb[j] >> (u + 4)) & 0x01010101u) << 4;
          }
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const uint32_t* cq = hi ? ch : cl;
        float w4[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int q = (int)((cq[j] >> (8 * b)) & 0xFFu);
            if constexpr (QT == Q8_0) q = (int)(int8_t)q;
            w4[b][j] = hi ? dequant<QT>(q, shi[j], mhi[j])
                          : dequant<QT>(q, slo[j], mlo[j]);
          }
        fma_rows<MT>(acc, xs, kc + 128 * hi + e - k0, w4);
      }
    }
  }
}

// Shared memory a gemv_stage call needs from its caller.
template <int MT, int NW> struct StageSmem {
  float xs[MT * SLICE];                       // the staged activation slice
  float red[NW * WARPS * MT * TILE_N];        // the warps' sums
};

// y (M, N) = x (M, K) @ W (K, N) for NW matrices W that share K and the
// column range (M <= MT * row tiles; N % 128 == 0; K % 256 == 0).
// Item (t, s, z): columns [128t, 128t + 128) of rows [MT z, MT z + MT),
// over the K slices s, s + ks, s + 2 ks, ... (ks <= ceil(K / 512)).
//   stage(xs, k0, m0): all threads write the slice's activations
//     xs[m * SLICE + i] = x[m0 + m][k0 + i] (0 past M or K)
//   epi(m, n, v): called once for each (row, column) with its NW sums
// partial: (ks, NW, M, N) f32 scratch when ks > 1; counters: one zeroed
// uint32 per (column tile, row tile), left zeroed.
template <int QT, int MT, int NW, class Stage, class Epi>
__device__ void gemv_stage(StageSmem<MT, NW>& sm, const Planes (&w)[NW],
                           int N, int K, int M, int ks, Stage&& stage,
                           Epi&& epi, float* __restrict__ partial,
                           unsigned int* __restrict__ counters) {
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntile = N / TILE_N, mtiles = (M + MT - 1) / MT;
  const int units = (K / 256) * 4;
  const int items = ntile * ks * mtiles;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int t = it % ntile, s = (it / ntile) % ks, z = it / (ntile * ks);
    const int n0 = t * TILE_N, m0 = z * MT;
    float acc[NW][MT][4] = {};
    for (int k0 = s * SLICE; k0 < K; k0 += ks * SLICE) {
      __syncthreads();                    // the last slice is read
      stage(sm.xs, k0, m0);
      __syncthreads();
      const int v = k0 / 64 + warp;       // this warp's unit of the slice
      if (v < units) {
#pragma unroll
        for (int q = 0; q < NW; ++q)
          unit_f32<QT, MT>(acc[q], v >> 2, v & 3, sm.xs, k0, w[q],
                           n0 + 4 * lane);
      }
    }
    __syncthreads();                      // red is free
#pragma unroll
    for (int q = 0; q < NW; ++q)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sm.red[((q * WARPS + warp) * MT + m) * TILE_N + 4 * lane + j] =
              acc[q][m][j];
    __syncthreads();
    // block sum over warps in a fixed order
    for (int i = threadIdx.x; i < MT * TILE_N; i += NT) {
      const int m = i / TILE_N, col = i - m * TILE_N;
      if (m0 + m >= M) continue;
      float v[NW];
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        v[q] = 0.f;
#pragma unroll
        for (int wp = 0; wp < WARPS; ++wp)
          v[q] += sm.red[((q * WARPS + wp) * MT + m) * TILE_N + col];
      }
      if (ks == 1) {
        epi(m0 + m, n0 + col, v);
      } else {
#pragma unroll
        for (int q = 0; q < NW; ++q)
          partial[(((size_t)s * NW + q) * M + m0 + m) * N + n0 + col] = v[q];
      }
    }
    if (ks == 1) continue;
    // the last of the ks blocks of this item adds the partials
    __threadfence();
    __syncthreads();
    const int cidx = z * ntile + t;
    if (threadIdx.x == 0)
      last = atomicAdd(&counters[cidx], 1u) == (unsigned)(ks - 1);
    __syncthreads();
    if (!last) continue;
    for (int i = threadIdx.x; i < MT * TILE_N; i += NT) {
      const int m = i / TILE_N, col = i - m * TILE_N;
      if (m0 + m >= M) continue;
      float v[NW];
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        v[q] = 0.f;
        for (int b = 0; b < ks; ++b)
          v[q] += __ldcg(partial + (((size_t)b * NW + q) * M + m0 + m) * N +
                         n0 + col);
      }
      epi(m0 + m, n0 + col, v);
    }
    if (threadIdx.x == 0) counters[cidx] = 0u;
  }
}

// Every block of the (cooperative, so co-resident) grid waits here until
// all have arrived; what a block wrote before is visible to every block
// after (read it with __ldcg: L1 is not coherent across SMs). bar[0]
// counts arrivals and is back at 0 after each barrier; bar[1] is the
// generation. Both start at 0.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      // a block that never arrives is a fault: stop (~30 s) rather than hang
      unsigned int spins = 0;
      while (*gen == g) {
        __nanosleep(100);
        if (++spins == (1u << 28)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The grid of a cooperative launch of `kernel`: every SM's resident blocks
// (at most max_per_sm each). Returns a CUDA error code; 0 = *blocks set.
inline int coop_blocks(const void* kernel, int smem, int max_per_sm,
                       int* blocks) {
  int dev = 0, coop = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = (per < max_per_sm ? per : max_per_sm) * sms;
  return 0;
}

__device__ __forceinline__ float act_fn(float a, int act) {
  if (act == 0) return a * (1.f / (1.f + expf(-a)));            // silu
  if (act == 1) {                                               // gelu (tanh)
    const float k = 0.7978845608028654f;                        // sqrt(2/pi)
    return 0.5f * a * (1.f + tanhf(k * (a + 0.044715f * a * a * a)));
  }
  return fmaxf(a, 0.f);                                         // relu
}

}  // namespace tlg

// a switch over the six formats: CALL runs with the constant QT set to the
// format of the case (so CALL may use it as a template argument)
#define TLG_SWITCH_FMT(qtype, CALL)                 \
  switch (qtype) {                                  \
    case tlq::Q4_0: { constexpr int QT = tlq::Q4_0; CALL; } break; \
    case tlq::Q4_1: { constexpr int QT = tlq::Q4_1; CALL; } break; \
    case tlq::Q5_0: { constexpr int QT = tlq::Q5_0; CALL; } break; \
    case tlq::Q5_1: { constexpr int QT = tlq::Q5_1; CALL; } break; \
    case tlq::Q8_0: { constexpr int QT = tlq::Q8_0; CALL; } break; \
    case tlq::Q2_K: { constexpr int QT = tlq::Q2_K; CALL; } break; \
    default: break;                                 \
  }
