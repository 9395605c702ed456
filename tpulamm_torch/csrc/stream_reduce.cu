// stream_reduce.cu -- the device's streaming probe: a block-wise column sum
// of a multi-GB f32 buffer,
//
//   out (8, cols) = b + sum_{r < n_tiles * block_rows} x[r, :]
//
// with the 8 rows identical and the rows past the last whole tile skipped.
// Replaces tpulamm/tools/stream_ceiling.py::make_reduce, the TPU kernel
// that measures the chip's practical HBM read rate (one read per byte,
// trivial compute, no writes that matter).
//
// What bounds it on an H100: the bytes of x, read once (2 GiB: 0.641 ms at
// 3.35 TB/s); one f32 add per element is 1/16 of an operation per byte.
//
// Design: on the TPU the grid runs the row tiles in order and carries the
// sum in the output block. Here the tiles run in parallel:
//   tile_sum: one block per row tile of block_rows rows. Each thread owns a
//     float4 column group and a row lane; it keeps UNROLL independent
//     16-byte streaming loads in flight, then the row lanes of the block
//     meet in shared memory in a fixed order -> partial[tile, cols];
//   finish: the per-tile partials added in a fixed order (32 warps a block,
//     warp w takes tiles w, w + 32, ...; then the warps in order), plus b,
//     written to the 8 output rows.
// No float atomics, so two runs give the same bits. Offsets are 64-bit: a
// 2 GiB buffer has byte offsets beyond 2^31.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // tile_sum threads
constexpr int UNROLL = 8;      // 16-byte loads in flight per thread
constexpr int FW = 32;         // finish: warps a block (columns = lanes)

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

__global__ void __launch_bounds__(NT) tile_sum(const float4* __restrict__ x,
                                               float4* __restrict__ partial,
                                               int block_rows, int c4n) {
  __shared__ float4 red[NT];
  const int ct = c4n < NT ? c4n : NT;      // float4 columns a pass
  const int rl = NT / ct;                  // row lanes
  const int lane_c = threadIdx.x % ct, lane_r = threadIdx.x / ct;
  const size_t tile = blockIdx.x;
  const float4* base = x + tile * (size_t)block_rows * c4n;
  for (int c0 = 0; c0 < c4n; c0 += ct) {
    const int c = c0 + lane_c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane_r < rl && c < c4n) {
      int r = lane_r;
      for (; r + (UNROLL - 1) * rl < block_rows; r += UNROLL * rl) {
        float4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          v[u] = __ldcs(base + (size_t)(r + u * rl) * c4n + c);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) add4(acc, v[u]);
      }
      for (; r < block_rows; r += rl) add4(acc, __ldcs(base + (size_t)r * c4n + c));
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (lane_r == 0 && c < c4n) {
      float4 s = red[lane_c];
      for (int j = 1; j < rl; ++j) add4(s, red[j * ct + lane_c]);
      partial[tile * c4n + c] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(FW * 32) finish(const float* __restrict__ partial,
                                                  const float* __restrict__ b,
                                                  float* __restrict__ out,
                                                  long long n_tiles, int cols) {
  __shared__ float red[FW][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < cols) {
    long long t = warp;
    for (; t + (UNROLL - 1) * FW < n_tiles; t += UNROLL * FW) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = partial[(t + u * FW) * cols + c];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc += v[u];
    }
    for (; t < n_tiles; t += FW) acc += partial[t * cols + c];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float s = red[0][lane];
    for (int w = 1; w < FW; ++w) s += red[w][lane];
    s += b[0];
    for (int j = 0; j < 8; ++j) out[(size_t)j * cols + c] = s;
  }
}

}  // namespace

// x (n_tiles * block_rows or more rows, cols) f32, 16-byte aligned; b one
// f32; partial (n_tiles, cols) f32 scratch; out (8, cols) f32. cols % 4 ==
// 0. Returns the launches' CUDA error code.
extern "C" int tl_stream_reduce(const void* x, const void* b, void* partial,
                                void* out, long long n_tiles, int block_rows,
                                int cols, void* stream) {
  if (n_tiles < 0 || n_tiles > 0x7fffffffLL || block_rows < 1 || cols < 4 ||
      cols % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tiles > 0) {
    tile_sum<<<(unsigned)n_tiles, NT, 0, s>>>((const float4*)x, (float4*)partial,
                                             block_rows, cols / 4);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  finish<<<(cols + 31) / 32, FW * 32, 0, s>>>((const float*)partial,
                                              (const float*)b, (float*)out,
                                              n_tiles, cols);
  return (int)cudaGetLastError();
}
