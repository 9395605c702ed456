// The port's host codec: ggml block-quant encode and decode for the
// quantizer (cli/quantize.py) and the model-file tools, over a pool of
// threads that each take a range of rows.
//
// The byte-level contract is tpulamm_torch/quant/formats.py: the numpy
// quantizers there are the plain versions the tests hold this codec to,
// byte for byte (llama.cpp's ggml-quants.c rules: fp16 scales rounded to
// nearest even, nearest() = lrintf, roundf half away from zero, the
// first absmax wins). Build without -ffast-math and without FP
// contraction: the bytes depend on IEEE rounding (quant/native.py).
//
// C ABI (ctypes):
//   tl_quantize(qtype, x, out, nrows, k, nthreads)
//   tl_dequantize(qtype, raw, out, nrows, k, nthreads)
// Both return 0 on success, negative on error.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- fp16 ----
inline uint16_t f32_to_f16(float f) {
  // IEEE binary16, round-to-nearest-even, no fast-math assumptions
  uint32_t x;
  std::memcpy(&x, &f, 4);
  const uint32_t sign = (x >> 16) & 0x8000u;
  uint32_t mant = x & 0x007FFFFFu;
  int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127;

  if (exp == 128) {  // inf / nan
    return (uint16_t)(sign | 0x7C00u | (mant ? 0x0200u | (mant >> 13) : 0));
  }
  if (exp > 15) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  if (exp >= -14) {
    // normal range: round mantissa 23 -> 10 bits (RNE)
    uint32_t m = mant;
    uint32_t half = m & 0x1FFFu;
    uint16_t out = (uint16_t)(sign | ((exp + 15) << 10) | (m >> 13));
    if (half > 0x1000u || (half == 0x1000u && (out & 1))) out++;
    return out;
  }
  if (exp < -25) return (uint16_t)sign;  // underflow -> 0
  // subnormal half
  mant |= 0x00800000u;
  int shift = -14 - exp;  // 1..11
  uint32_t m = mant >> (13 + shift);
  uint32_t rem = mant & ((1u << (13 + shift)) - 1);
  uint32_t halfway = 1u << (12 + shift);
  uint16_t out = (uint16_t)(sign | m);
  if (rem > halfway || (rem == halfway && (out & 1))) out++;
  return out;
}

inline float f16_to_f32(uint16_t h) {
  const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FFu;
  uint32_t x;
  if (exp == 0) {
    if (mant == 0) {
      x = sign;
    } else {
      // subnormal, mant x 2^-24: normalize to 1.m x 2^(e + 1 - 14)
      int e = -1;
      uint32_t m = mant;
      while (!(m & 0x400u)) {
        m <<= 1;
        e--;
      }
      m &= 0x3FFu;
      x = sign | ((uint32_t)(e + 1 - 14 + 127) << 23) | (m << 13);
    }
  } else if (exp == 31) {
    x = sign | 0x7F800000u | (mant << 13);
  } else {
    x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

inline int nearest(float v) { return (int)lrintf(v); }  // RNE (default mode)

// ---------------------------------------------------------------- types ----
enum QType : int {
  F32 = 0,
  F16 = 1,
  Q4_0 = 2,
  Q4_1 = 3,
  Q5_0 = 6,
  Q5_1 = 7,
  Q8_0 = 8,
  Q8_1 = 9,
  Q2_K = 10,
  Q8_K = 15,
};

struct TypeInfo {
  int block;   // elements per block
  int bytes;   // bytes per block
};

inline bool is_block_type(int t) {
  return t == Q4_0 || t == Q4_1 || t == Q5_0 || t == Q5_1 || t == Q8_0 ||
         t == Q8_1 || t == Q2_K || t == Q8_K;
}

inline TypeInfo type_info(int t) {
  switch (t) {
    case Q4_0: return {32, 18};
    case Q4_1: return {32, 20};
    case Q5_0: return {32, 22};
    case Q5_1: return {32, 24};
    case Q8_0: return {32, 34};
    case Q8_1: return {32, 36};
    case Q2_K: return {256, 84};
    case Q8_K: return {256, 292};
    case F16: return {1, 2};
    default: return {1, 4};
  }
}

// ------------------------------------------------------------ thread pool --
template <typename F>
void parallel_rows(int64_t nrows, int nthreads, F&& fn) {
  if (nthreads <= 1 || nrows < 2) {
    fn(0, nrows);
    return;
  }
  int nt = (int)std::min<int64_t>(nthreads, nrows);
  std::vector<std::thread> ts;
  int64_t chunk = (nrows + nt - 1) / nt;
  for (int i = 0; i < nt; i++) {
    int64_t lo = i * chunk, hi = std::min<int64_t>(nrows, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// ----------------------------------------------------------- encoders -----
// semantics contract: see tpulamm_torch/quant/formats.py (and ggml-quants.c)

void enc_q4_0(const float* x, uint8_t* y, int64_t nb) {
  for (int64_t i = 0; i < nb; i++, x += 32, y += 18) {
    float amax = fabsf(x[0]), vmax = x[0];  // the first absmax, as argmax
    for (int j = 1; j < 32; j++) {
      float a = fabsf(x[j]);
      if (a > amax) { amax = a; vmax = x[j]; }
    }
    float d = vmax / -8.0f;
    float id = d != 0.0f ? 1.0f / d : 0.0f;
    uint16_t h = f32_to_f16(d);
    std::memcpy(y, &h, 2);
    for (int j = 0; j < 16; j++) {
      float v0 = x[j] * id + 8.5f, v1 = x[j + 16] * id + 8.5f;
      uint8_t q0 = (uint8_t)std::min(15, std::max(0, (int)v0));
      uint8_t q1 = (uint8_t)std::min(15, std::max(0, (int)v1));
      y[2 + j] = (uint8_t)(q0 | (q1 << 4));
    }
  }
}

void enc_q4_1(const float* x, uint8_t* y, int64_t nb) {
  for (int64_t i = 0; i < nb; i++, x += 32, y += 20) {
    float mn = x[0], mx = x[0];
    for (int j = 1; j < 32; j++) {
      mn = std::min(mn, x[j]);
      mx = std::max(mx, x[j]);
    }
    float d = (mx - mn) / 15.0f;
    float id = d != 0.0f ? 1.0f / d : 0.0f;
    uint16_t hd = f32_to_f16(d), hm = f32_to_f16(mn);
    std::memcpy(y, &hd, 2);
    std::memcpy(y + 2, &hm, 2);
    for (int j = 0; j < 16; j++) {
      float v0 = (x[j] - mn) * id + 0.5f, v1 = (x[j + 16] - mn) * id + 0.5f;
      uint8_t q0 = (uint8_t)std::min(15, std::max(0, (int)v0));
      uint8_t q1 = (uint8_t)std::min(15, std::max(0, (int)v1));
      y[4 + j] = (uint8_t)(q0 | (q1 << 4));
    }
  }
}

void enc_q5_0(const float* x, uint8_t* y, int64_t nb) {
  for (int64_t i = 0; i < nb; i++, x += 32, y += 22) {
    float amax = fabsf(x[0]), vmax = x[0];  // the first absmax, as argmax
    for (int j = 1; j < 32; j++) {
      float a = fabsf(x[j]);
      if (a > amax) { amax = a; vmax = x[j]; }
    }
    float d = vmax / -16.0f;
    float id = d != 0.0f ? 1.0f / d : 0.0f;
    uint16_t h = f32_to_f16(d);
    std::memcpy(y, &h, 2);
    uint32_t qh = 0;
    for (int j = 0; j < 16; j++) {
      float v0 = x[j] * id + 16.5f, v1 = x[j + 16] * id + 16.5f;
      uint8_t q0 = (uint8_t)std::min(31, std::max(0, (int)v0));
      uint8_t q1 = (uint8_t)std::min(31, std::max(0, (int)v1));
      y[6 + j] = (uint8_t)((q0 & 0xF) | ((q1 & 0xF) << 4));
      qh |= ((uint32_t)(q0 >> 4)) << j;
      qh |= ((uint32_t)(q1 >> 4)) << (j + 16);
    }
    std::memcpy(y + 2, &qh, 4);
  }
}

void enc_q5_1(const float* x, uint8_t* y, int64_t nb) {
  for (int64_t i = 0; i < nb; i++, x += 32, y += 24) {
    float mn = x[0], mx = x[0];
    for (int j = 1; j < 32; j++) {
      mn = std::min(mn, x[j]);
      mx = std::max(mx, x[j]);
    }
    float d = (mx - mn) / 31.0f;
    float id = d != 0.0f ? 1.0f / d : 0.0f;
    uint16_t hd = f32_to_f16(d), hm = f32_to_f16(mn);
    std::memcpy(y, &hd, 2);
    std::memcpy(y + 2, &hm, 2);
    uint32_t qh = 0;
    for (int j = 0; j < 16; j++) {
      float v0 = (x[j] - mn) * id + 0.5f, v1 = (x[j + 16] - mn) * id + 0.5f;
      uint8_t q0 = (uint8_t)std::max(0, std::min(31, (int)v0));
      uint8_t q1 = (uint8_t)std::max(0, std::min(31, (int)v1));
      y[8 + j] = (uint8_t)((q0 & 0xF) | ((q1 & 0xF) << 4));
      qh |= ((uint32_t)(q0 >> 4)) << j;
      qh |= ((uint32_t)(q1 >> 4)) << (j + 16);
    }
    std::memcpy(y + 4, &qh, 4);
  }
}

void enc_q8_0(const float* x, uint8_t* y, int64_t nb) {
  for (int64_t i = 0; i < nb; i++, x += 32, y += 34) {
    float amax = 0;
    for (int j = 0; j < 32; j++) amax = std::max(amax, fabsf(x[j]));
    float d = amax / 127.0f;
    float id = d != 0.0f ? 1.0f / d : 0.0f;
    uint16_t h = f32_to_f16(d);
    std::memcpy(y, &h, 2);
    for (int j = 0; j < 32; j++) {
      y[2 + j] = (uint8_t)(int8_t)roundf(x[j] * id);
    }
  }
}

void enc_q8_1(const float* x, uint8_t* y, int64_t nb) {
  for (int64_t i = 0; i < nb; i++, x += 32, y += 36) {
    float amax = 0;
    for (int j = 0; j < 32; j++) amax = std::max(amax, fabsf(x[j]));
    float d = amax / 127.0f;
    float id = d != 0.0f ? 1.0f / d : 0.0f;
    uint16_t h = f32_to_f16(d);
    std::memcpy(y, &h, 2);
    int sum = 0;
    for (int j = 0; j < 32; j++) {
      int8_t q = (int8_t)roundf(x[j] * id);
      y[4 + j] = (uint8_t)q;
      sum += q;
    }
    uint16_t hs = f32_to_f16(sum * d);
    std::memcpy(y + 2, &hs, 2);
  }
}

// A float sum of 16 in numpy's order (pairwise_sum: 8 lanes, then a tree),
// so the search below takes the same scale as formats._make_qkx2_quants
// down to the last bit, ties of its rounding included. ggml's
// make_qkx2_quants sums in sequence: a rare Q2_K scale differs from ggml's
// in the last bit, as the numpy quantizer's does.
inline float sum16(const float* a) {
  float r[8];
  for (int j = 0; j < 8; j++) r[j] = a[j] + a[j + 8];
  return ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
}

// Q2_K: per-16 grid-searched affine quantization over 256-elem superblocks;
// same search parameters as the reference (nmax=3, rmin=-.5, rdelta=.1,
// nstep=15, weighted MAD objective, min clamped <= 0 and updated on accept)
float qkx2_search(const float* x, const float* w, uint8_t* L, float* the_min) {
  float mn = x[0], mx = x[0];
  float t[16];
  for (int i = 1; i < 16; i++) {
    mn = std::min(mn, x[i]);
    mx = std::max(mx, x[i]);
  }
  for (int i = 0; i < 16; i++) t[i] = w[i] * x[i];
  const float sum_w = sum16(w), sum_x = sum16(t);
  if (mn > 0) mn = 0;
  if (mx == mn) {
    for (int i = 0; i < 16; i++) L[i] = 0;
    *the_min = -mn;
    return 0.f;
  }
  float iscale = 3.0f / (mx - mn);
  float scale = 1.0f / iscale;
  for (int i = 0; i < 16; i++) {
    int l = nearest(iscale * (x[i] - mn));
    L[i] = (uint8_t)std::max(0, std::min(3, l));
    t[i] = w[i] * fabsf(scale * L[i] + mn - x[i]);
  }
  float best_mad = sum16(t);
  for (int is = 0; is <= 15; is++) {
    float isc = (-0.5f + 0.1f * is + 3.0f) / (mx - mn);
    uint8_t Laux[16];
    float tl[16], tl2[16], txl[16];
    for (int i = 0; i < 16; i++) {
      int l = std::max(0, std::min(3, nearest(isc * (x[i] - mn))));
      Laux[i] = (uint8_t)l;
      tl[i] = w[i] * l;
      tl2[i] = w[i] * l * l;
      txl[i] = w[i] * l * x[i];
    }
    float sl = sum16(tl), sl2 = sum16(tl2), sxl = sum16(txl);
    float D = sum_w * sl2 - sl * sl;
    if (D > 0) {
      float ts = (sum_w * sxl - sum_x * sl) / D;
      float tm = (sl2 * sum_x - sl * sxl) / D;
      if (tm > 0) {
        tm = 0;
        ts = sxl / sl2;
      }
      for (int i = 0; i < 16; i++)
        t[i] = w[i] * fabsf(ts * Laux[i] + tm - x[i]);
      float mad = sum16(t);
      if (mad < best_mad) {
        std::memcpy(L, Laux, 16);
        best_mad = mad;
        scale = ts;
        mn = tm;
      }
    }
  }
  *the_min = -mn;
  return scale;
}

void enc_q2_k(const float* x, uint8_t* y, int64_t nb) {
  for (int64_t i = 0; i < nb; i++, x += 256, y += 84) {
    uint8_t L[256];
    float scales[16], mins[16], weights[16];
    float max_scale = 0, max_min = 0;
    for (int g = 0; g < 16; g++) {
      for (int l = 0; l < 16; l++) weights[l] = fabsf(x[16 * g + l]);
      scales[g] = qkx2_search(x + 16 * g, weights, L + 16 * g, &mins[g]);
      max_scale = std::max(max_scale, scales[g]);
      max_min = std::max(max_min, mins[g]);
    }
    if (max_scale > 0) {
      float isc = 15.0f / max_scale;
      for (int g = 0; g < 16; g++) y[g] = (uint8_t)nearest(isc * scales[g]);
    } else {
      for (int g = 0; g < 16; g++) y[g] = 0;
    }
    uint16_t hd = f32_to_f16(max_scale > 0 ? max_scale / 15.0f : 0.0f);
    if (max_min > 0) {
      float imn = 15.0f / max_min;
      for (int g = 0; g < 16; g++)
        y[g] |= (uint8_t)(nearest(imn * mins[g]) << 4);
    }
    uint16_t hdm = f32_to_f16(max_min > 0 ? max_min / 15.0f : 0.0f);
    std::memcpy(y + 80, &hd, 2);
    std::memcpy(y + 82, &hdm, 2);
    float df = f16_to_f32(hd), dmf = f16_to_f32(hdm);
    for (int g = 0; g < 16; g++) {
      float dd = df * (y[g] & 0xF);
      if (dd == 0.0f) continue;
      float dm = dmf * (y[g] >> 4);
      for (int l = 0; l < 16; l++) {
        int q = nearest((x[16 * g + l] + dm) / dd);
        L[16 * g + l] = (uint8_t)std::max(0, std::min(3, q));
      }
    }
    for (int half = 0; half < 2; half++) {
      const uint8_t* Lh = L + 128 * half;
      uint8_t* q = y + 16 + 32 * half;
      for (int l = 0; l < 32; l++) {
        q[l] = (uint8_t)(Lh[l] | (Lh[l + 32] << 2) | (Lh[l + 64] << 4) |
                         (Lh[l + 96] << 6));
      }
    }
  }
}

void enc_q8_k(const float* x, uint8_t* y, int64_t nb) {
  for (int64_t i = 0; i < nb; i++, x += 256, y += 292) {
    float amax = 0, vmax = 0;
    for (int j = 0; j < 256; j++) {
      float a = fabsf(x[j]);
      if (a > amax) { amax = a; vmax = x[j]; }
    }
    if (amax == 0) {
      std::memset(y, 0, 292);
      continue;
    }
    float iscale = -127.0f / vmax;
    int8_t* q = (int8_t*)(y + 4);
    for (int j = 0; j < 256; j++)
      q[j] = (int8_t)std::min(127, nearest(iscale * x[j]));
    for (int g = 0; g < 16; g++) {
      int sum = 0;
      for (int l = 0; l < 16; l++) sum += q[16 * g + l];
      int16_t s = (int16_t)sum;
      std::memcpy(y + 260 + 2 * g, &s, 2);
    }
    float d = 1.0f / iscale;
    std::memcpy(y, &d, 4);
  }
}

// ----------------------------------------------------------- decoders -----

void dec_row(int qtype, const uint8_t* y, float* x, int64_t k) {
  TypeInfo ti = type_info(qtype);
  int64_t nb = k / ti.block;
  switch (qtype) {
    case Q4_0:
      for (int64_t i = 0; i < nb; i++, y += 18, x += 32) {
        uint16_t h;
        std::memcpy(&h, y, 2);
        float d = f16_to_f32(h);
        for (int j = 0; j < 16; j++) {
          x[j] = ((int)(y[2 + j] & 0xF) - 8) * d;
          x[j + 16] = ((int)(y[2 + j] >> 4) - 8) * d;
        }
      }
      break;
    case Q4_1:
      for (int64_t i = 0; i < nb; i++, y += 20, x += 32) {
        uint16_t hd, hm;
        std::memcpy(&hd, y, 2);
        std::memcpy(&hm, y + 2, 2);
        float d = f16_to_f32(hd), m = f16_to_f32(hm);
        for (int j = 0; j < 16; j++) {
          x[j] = (y[4 + j] & 0xF) * d + m;
          x[j + 16] = (y[4 + j] >> 4) * d + m;
        }
      }
      break;
    case Q5_0:
      for (int64_t i = 0; i < nb; i++, y += 22, x += 32) {
        uint16_t h;
        std::memcpy(&h, y, 2);
        float d = f16_to_f32(h);
        uint32_t qh;
        std::memcpy(&qh, y + 2, 4);
        for (int j = 0; j < 16; j++) {
          int v0 = (y[6 + j] & 0xF) | (int)(((qh >> j) & 1) << 4);
          int v1 = (y[6 + j] >> 4) | (int)(((qh >> (j + 16)) & 1) << 4);
          x[j] = (v0 - 16) * d;
          x[j + 16] = (v1 - 16) * d;
        }
      }
      break;
    case Q5_1:
      for (int64_t i = 0; i < nb; i++, y += 24, x += 32) {
        uint16_t hd, hm;
        std::memcpy(&hd, y, 2);
        std::memcpy(&hm, y + 2, 2);
        float d = f16_to_f32(hd), m = f16_to_f32(hm);
        uint32_t qh;
        std::memcpy(&qh, y + 4, 4);
        for (int j = 0; j < 16; j++) {
          int v0 = (y[8 + j] & 0xF) | (int)(((qh >> j) & 1) << 4);
          int v1 = (y[8 + j] >> 4) | (int)(((qh >> (j + 16)) & 1) << 4);
          x[j] = v0 * d + m;
          x[j + 16] = v1 * d + m;
        }
      }
      break;
    case Q8_0:
      for (int64_t i = 0; i < nb; i++, y += 34, x += 32) {
        uint16_t h;
        std::memcpy(&h, y, 2);
        float d = f16_to_f32(h);
        const int8_t* q = (const int8_t*)(y + 2);
        for (int j = 0; j < 32; j++) x[j] = q[j] * d;
      }
      break;
    case Q8_1:
      for (int64_t i = 0; i < nb; i++, y += 36, x += 32) {
        uint16_t h;
        std::memcpy(&h, y, 2);
        float d = f16_to_f32(h);
        const int8_t* q = (const int8_t*)(y + 4);
        for (int j = 0; j < 32; j++) x[j] = q[j] * d;
      }
      break;
    case Q2_K:
      for (int64_t i = 0; i < nb; i++, y += 84, x += 256) {
        uint16_t hd, hdm;
        std::memcpy(&hd, y + 80, 2);
        std::memcpy(&hdm, y + 82, 2);
        float d = f16_to_f32(hd), dmin = f16_to_f32(hdm);
        for (int e = 0; e < 256; e++) {
          int half = e / 128, r = e % 128;
          int shift = 2 * (r / 32);
          uint8_t byte = y[16 + 32 * half + (r % 32)];
          uint8_t sc = y[8 * half + 2 * (r / 32) + (r % 32) / 16];
          x[e] = d * (sc & 0xF) * ((byte >> shift) & 3) - dmin * (sc >> 4);
        }
      }
      break;
    case Q8_K:
      for (int64_t i = 0; i < nb; i++, y += 292, x += 256) {
        float d;
        std::memcpy(&d, y, 4);
        const int8_t* q = (const int8_t*)(y + 4);
        for (int j = 0; j < 256; j++) x[j] = q[j] * d;
      }
      break;
    default:
      break;
  }
}

}  // namespace

extern "C" {

int tl_quantize(int qtype, const float* x, uint8_t* out, int64_t nrows,
                int64_t k, int nthreads) {
  if (!is_block_type(qtype)) return -3;
  TypeInfo ti = type_info(qtype);
  if (k % ti.block) return -2;
  int64_t nb = k / ti.block;
  int64_t row_bytes = nb * ti.bytes;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; r++) {
      const float* xr = x + r * k;
      uint8_t* yr = out + r * row_bytes;
      switch (qtype) {
        case Q4_0: enc_q4_0(xr, yr, nb); break;
        case Q4_1: enc_q4_1(xr, yr, nb); break;
        case Q5_0: enc_q5_0(xr, yr, nb); break;
        case Q5_1: enc_q5_1(xr, yr, nb); break;
        case Q8_0: enc_q8_0(xr, yr, nb); break;
        case Q8_1: enc_q8_1(xr, yr, nb); break;
        case Q2_K: enc_q2_k(xr, yr, nb); break;
        case Q8_K: enc_q8_k(xr, yr, nb); break;
        default: break;
      }
    }
  };
  parallel_rows(nrows, nthreads, work);
  return 0;
}

int tl_dequantize(int qtype, const uint8_t* raw, float* out, int64_t nrows,
                  int64_t k, int nthreads) {
  if (!is_block_type(qtype)) return -3;
  TypeInfo ti = type_info(qtype);
  if (k % ti.block) return -2;
  int64_t row_bytes = k / ti.block * ti.bytes;
  parallel_rows(nrows, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; r++)
      dec_row(qtype, raw + r * row_bytes, out + r * k, k);
  });
  return 0;
}

}  // extern "C"
