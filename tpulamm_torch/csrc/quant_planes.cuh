// quant_planes.cuh -- reading the repack "mm" planes on the device.
//
// Shared by every kernel that streams quantized weights (qmm.cu,
// qmm_int8.cu, ffn_fused.cu, mega_decode.cu), so that they all know the
// six formats the same way. The plain version (ops/qtensor.py::dequant_mm)
// dequantizes
//
//   w[k, n] = (q[k, n] - zero) * scale[g, n] (+ min[g, n]),  g = k / group
//
// and every kernel multiplies the integer codes (minus the zero point) by
// x first and applies the group's scale and min after its products.
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

}  // namespace tlq
