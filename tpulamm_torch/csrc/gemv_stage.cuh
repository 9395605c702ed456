// gemv_stage.cuh -- the pieces of a kernel that runs several dependent
// decode products in ONE cooperative launch (ffn_fused.cu, mega_decode.cu,
// and gemv_tc.cuh's products):
//
//   Planes       one weight matrix's mm planes, as a product reads them
//   grid_sync    a barrier of every block of the grid
//   coop_blocks  the grid of such a launch: every SM's resident blocks
//   act_fn       the FFN's activation (silu, gelu (tanh), relu)
//   TLG_SWITCH_FMT  a switch over the six formats
//
// A grid barrier needs every block resident: a cooperative launch of at
// most coop_blocks blocks guarantees it, so the spin cannot deadlock.

#pragma once

#include "quant_planes.cuh"

namespace tlg {

using namespace tlq;

constexpr int WARPS = 8, NT = 32 * WARPS, TILE_N = 128;

// one weight matrix: its planes, the plane row length (the matrix's N) and
// the first column of this view (the up half of a fused gate|up)
struct Planes {
  const uint8_t* qa;    // qs / q2 / q8
  const uint8_t* qb;    // qh (Q5_x) or null
  const void* sa;       // scales (Q2_K: scd)
  const void* sb;       // mins (Q2_K: dm) or null
  int ld, off;
};

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
