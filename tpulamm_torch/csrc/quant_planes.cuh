// quant_planes.cuh -- reading the repack "mm" planes on the device.
//
// Shared by every kernel that streams quantized weights (qmm.cu,
// qmm_int8.cu, ffn_fused.cu, mega_decode.cu), so that they all decode the
// six formats the same way. The gemv stages dequantize to the same f32
// weights as the plain version (ops/qtensor.py::dequant_mm),
//
//   w[k, n] = (q[k, n] - zero) * scale[g, n] (+ min[g, n]),  g = k / group
//
// with the multiply and the add rounded separately (no FMA contraction);
// qmm.cu multiplies the integer codes and scales after its products.
// Plane layouts: tpulamm_torch/quant/repack.py.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tlq {

enum : int { Q4_0 = 2, Q4_1 = 3, Q5_0 = 6, Q5_1 = 7, Q8_0 = 8, Q2_K = 10 };

// whether a host-side format code is one of the six
inline bool known_format(long long qt) {
  return qt == Q4_0 || qt == Q4_1 || qt == Q5_0 || qt == Q5_1 || qt == Q8_0 ||
         qt == Q2_K;
}

template <int QT> struct Fmt {
  static constexpr float zero = QT == Q4_0 ? 8.f : (QT == Q5_0 ? 16.f : 0.f);
  static constexpr bool has_min = QT == Q4_1 || QT == Q5_1 || QT == Q2_K;
  static constexpr bool corr = zero != 0.f || has_min;
  static constexpr int group = QT == Q2_K ? 16 : 32;
};

// scale and min of the group holding element k, column n
template <int QT>
__device__ __forceinline__ void group_scale(const void* __restrict__ sa,
                                            const void* __restrict__ sb,
                                            int k, int n, int N,
                                            float& s, float& mn) {
  if constexpr (QT == Q2_K) {
    // compact planes: scd byte = sc | (m << 4); dm rows 8c, 8c+1 = d, dmin
    const uint8_t* scd = (const uint8_t*)sa;
    const unsigned short* dm = (const unsigned short*)sb;
    const int b = scd[(size_t)(k >> 4) * N + n];
    const int c = k >> 8;
    const float d = __half2float(__ushort_as_half(dm[(size_t)(8 * c) * N + n]));
    const float dmin =
        __half2float(__ushort_as_half(dm[(size_t)(8 * c + 1) * N + n]));
    s = __fmul_rn((float)(b & 15), d);
    mn = __fmul_rn((float)(b >> 4), -dmin);
  } else {
    s = ((const float*)sa)[(size_t)(k >> 5) * N + n];
    mn = Fmt<QT>::has_min ? ((const float*)sb)[(size_t)(k >> 5) * N + n] : 0.f;
  }
}

// the f32 weight of code q in a group of scale s and min mn
template <int QT>
__device__ __forceinline__ float dequant(int q, float s, float mn) {
  float w = __fmul_rn((float)q - Fmt<QT>::zero, s);
  if constexpr (Fmt<QT>::has_min) w = __fadd_rn(w, mn);
  return w;
}

// -- word access: one 32-bit load gives a byte of 4 neighbouring columns ----
__device__ __forceinline__ uint32_t ld32(const uint8_t* __restrict__ p,
                                         size_t row, int N, int n) {
  return __ldg(reinterpret_cast<const unsigned int*>(p + row * N + n));
}

// w[b] = bytes of columns n..n+3 in row b -> c[j] = bytes of rows 0..3 in
// column j (a 4x4 byte transpose)
__device__ __forceinline__ void transpose4(const uint32_t w[4], uint32_t c[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t b = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t d = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t e = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(a, b, 0x5410);
  c[1] = __byte_perm(a, b, 0x7632);
  c[2] = __byte_perm(d, e, 0x5410);
  c[3] = __byte_perm(d, e, 0x7632);
}

// c[j] = the bytes of plane rows row0..row0+3 in column n + j
__device__ __forceinline__ void load_cols(const uint8_t* __restrict__ p,
                                          size_t row0, int N, int n,
                                          uint32_t c[4]) {
  uint32_t w[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) w[b] = ld32(p, row0 + b, N, n);
  transpose4(w, c);
}

}  // namespace tlq
