// qmm.cu -- fused dequantize + f32 matmul over the repack "mm" planes.
//
// Replaces tpulamm/ops/pallas_qmm.py::_qmm_call (kernel body _make_kernel),
// the TPU kernel behind every prefill projection (M > 16).
//
//   out (M, N) f32 = x (M, K) f32 @ W (K, N),
//   W[k, n] = (q[k, n] - zero) * scale[g, n] (+ min[g, n]),  g = k / group
//
// The weight never exists dequantized in device memory: each block reads
// the packed planes (quant/repack.py, N on the last axis) and dequantizes
// one tile at a time into shared memory.
//
// What bounds it on an H100: at the prefill shape (M = 512) the product
// does 2*M*K*N operations against ~0.6 bytes of planes per weight, far
// above the card's operations-per-byte ridge, so arithmetic bounds it.
// This first version does that arithmetic in f32 on the CUDA cores (the
// JAX package also computes in f32 for M > 16), far from the tensor-core
// bound; the wgmma/TMA pipeline is later work.
//
// Design: a block owns a 64x64 output tile; each of its 256 threads owns
// a 4x4 sub-tile and reads its operands from shared memory as float4. K
// advances in steps of 32, one scale group (two for Q2_K's groups of 16),
// so a step needs one scale row per column. Every plane packs K in
// 256-element chunks and the wrapper requires K % 256 == 0, so steps
// never straddle a chunk and no step reads past K: K = 11008 is 43 chunks,
// exactly 344 steps. Rows of x past M are zero-filled and never stored.
// The dequantize rounds exactly like the plain version (separate multiply
// and add, no FMA contraction), so both see identical weights and differ
// only in the order of the f32 sums.

#include "quant_planes.cuh"

namespace {

using namespace tlq;

constexpr int BM = 64, BN = 64, BK = 32, NT = 256;
constexpr int XS_STRIDE = BM + 4;  // keeps float4 rows 16-byte aligned

template <int QT>
__global__ void __launch_bounds__(NT)
qmm_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qa,
               const uint8_t* __restrict__ qb, const void* __restrict__ sa,
               const void* __restrict__ sb, float* __restrict__ out,
               int M, int N, int K) {
  __shared__ __align__(16) float xs[BK][XS_STRIDE];
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tx = tid & 15, ty = tid >> 4;       // 4x4 sub-tile owner
  const int wn = tid & 63, wk0 = tid >> 6;      // dequant: column, first row
  const int nw = n0 + wn;                       // N % 64 == 0: always < N
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile (64 rows x 32 k), coalesced along k, stored k-major
#pragma unroll
    for (int i = 0; i < (BM * BK) / NT; ++i) {
      const int idx = tid + NT * i;
      const int r = idx >> 5, c = idx & 31;
      const int m = m0 + r;
      xs[c][r] = m < M ? x[(size_t)m * K + k0 + c] : 0.f;
    }
    // weight tile (32 k x 64 n), dequantized once in f32
    float s, mn, s2 = 0.f, mn2 = 0.f;
    group_scale<QT>(sa, sb, k0, nw, N, s, mn);
    if constexpr (QT == Q2_K) group_scale<QT>(sa, sb, k0 + 16, nw, N, s2, mn2);
#pragma unroll
    for (int i = 0; i < (BK * BN) / NT; ++i) {
      const int kk = wk0 + 4 * i;
      const int q = code_at<QT>(qa, qb, k0 + kk, nw, N);
      float ss = s, mm = mn;
      if constexpr (QT == Q2_K) {
        if (kk >= 16) { ss = s2; mm = mn2; }
      }
      ws[kk][wn] = dequant<QT>(q, ss, mm);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < M)
      *reinterpret_cast<float4*>(&out[(size_t)m * N + n0 + tx * 4]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <int QT>
void launch(const float* x, const void* qa, const void* qb, const void* sa,
            const void* sb, float* out, int M, int N, int K,
            cudaStream_t stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  qmm_f32_kernel<QT><<<grid, NT, 0, stream>>>(
      x, (const uint8_t*)qa, (const uint8_t*)qb, sa, sb, out, M, N, K);
}

}  // namespace

// C entry point. qa: qs / q2 / q8 plane; qb: qh (Q5_x) or null;
// sa: scales (Q2_K: scd); sb: mins (Q2_K: dm) or null.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tl_qmm_f32(int qtype, const void* x, const void* qa,
                          const void* qb, const void* sa, const void* sb,
                          void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || N % BN != 0 || K % 256 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float* o = (float*)out;
  switch (qtype) {
    case Q4_0: launch<Q4_0>(xf, qa, qb, sa, sb, o, M, N, K, st); break;
    case Q4_1: launch<Q4_1>(xf, qa, qb, sa, sb, o, M, N, K, st); break;
    case Q5_0: launch<Q5_0>(xf, qa, qb, sa, sb, o, M, N, K, st); break;
    case Q5_1: launch<Q5_1>(xf, qa, qb, sa, sb, o, M, N, K, st); break;
    case Q8_0: launch<Q8_0>(xf, qa, qb, sa, sb, o, M, N, K, st); break;
    case Q2_K: launch<Q2_K>(xf, qa, qb, sa, sb, o, M, N, K, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
