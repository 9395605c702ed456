// qmm.cu -- fused dequantize + matmul over the repack "mm" planes on the
// H100's tensor cores (wgmma), with an f32-grade result.
//
// Replaces tpulamm/ops/pallas_qmm.py::_qmm_call (:576, kernel body
// _make_kernel), the TPU kernel behind every prefill projection (M > 16),
// which computes in f32:
//
//   out (M, N) f32 = x (M, K) f32 @ W (K, N),
//   W[k, n] = (q[k, n] - zero) * scale[g, n] (+ min[g, n]),  g = k / group
//
// What bounds it on an H100: operations. At M = 512 the product does
// 2 M K N operations against ~0.6 bytes of planes a weight (and 4 bytes an
// activation), ~1,000 operations a byte, far above the ridge of ~295; at
// M = 128 (the reference shape 4096x11008x128) still ~240 a byte against
// the planes alone, so the tensor cores set the pace there too.
//
// Why the tensor cores give an f32-grade result here:
// - The weights stay integer codes: c = q - zero lies in [-16, 15] for
//   Q4_x / Q5_x and [-128, 127] for Q8_0; Q2_K folds its 4-bit sub-scale
//   into the code (c = q * sc <= 45). Every code is exact in bf16.
// - The activations are split, x = x_hi + x_lo, both bf16 (16 significant
//   bits), and two bf16 MMA passes run over the same code tile: what is
//   left is below 2^-17 |x| an element, ~1e-5 of max|out| at the widths of
//   the path, against the contract of 1e-4.
// - The scales come after the MMA, in f32, per group of 32 K:
//   out[m, n] = sum_g s[g, n] P_g[m, n] + sum_g min[g, n] xsum[m, g] with
//   P_g = x[m, g] . c[g, n] summed by the tensor cores in f32; Q2_K's d per
//   256 multiplies each 32-K partial, its mins go per 16. The min term is
//   a tensor-core product too, its operands split to 16 bits (below).
// So the least time is two bf16 passes: 2 x the 1-pass bound of the
// function (0.3485 ms over the five LLaMA-7B shapes at M = 512 on an H100
// SXM at 700 W gives a floor of 0.697 ms); the min term adds 1/8 of a
// stage's MMAs for Q4_1, Q5_1 and Q2_K.
//
// Design. A prologue launch splits x into x_hi / x_lo (bf16, rows padded
// to the tile with zeros) and, for the formats with mins, writes the
// per-group sums of x as the min term's operand. The main kernel: a block of two warpgroups owns a 128 x 128
// output tile (64 rows each) and walks K in stages of 64. A ring of 3
// stages in shared memory, filled by cp.async two stages ahead, holds the
// x_hi / x_lo tiles (K-major, 128-byte swizzle, as wgmma reads them), the
// plane rows that hold the stage's codes, scales, mins and sums. A 64-K
// stage never straddles a 256-element plane chunk: it reads the 64 qs rows
// of its half chunk (one nibble of each byte), all 32 qh rows (two bits),
// or all 64 q2 rows (one crumb). The block expands each stage's codes once
// into a bf16 tile, N rows of 64 K (K-major, 128-byte swizzle: a 4 x 4
// byte transpose turns plane rows into K runs), double-buffered. Per group
// of 32 K a warpgroup issues four wgmma m64n128k16 (x_lo and x_hi, two k16
// steps) into a fresh f32 partial; the two groups of a stage go out
// together, the next stage's codes are expanded while they run, and each
// partial is folded into the accumulator with one f32 FMA by its scale
// once it lands. The min term goes through the tensor cores too, one more
// wgmma a stage straight into the accumulator: the group sums and the mins
// each split into bf16 hi + lo (the mins exactly: 15 bits at most), and
// the products hi.hi + lo.hi + hi.lo. Rows past M are zero and never
// stored. Where the output tiles alone leave SMs idle (M = 128), K
// is split into `splits` ranges whose partials a third launch adds in a
// fixed order: no atomics, the same bits on every run.

#include <cuda_bf16.h>

#include "quant_planes.cuh"

namespace {

using namespace tlq;

constexpr int BM = 128, BN = 128, BK = 64, NT = 256, STAGES = 3;
constexpr int PS = BN + 16;  // byte row stride of the staged Q2_K scd rows

// one ring slot (bytes); the x tiles are 128-byte-swizzled rows of 64 bf16
constexpr int O_XH = 0;
constexpr int O_XL = O_XH + BM * BK * 2;
constexpr int O_PA = O_XL + BM * BK * 2;   // qs / q8 / q2 rows: 64 x BN
constexpr int O_PB = O_PA + 64 * BN;       // qh rows 32 x BN; Q2_K scd + dm
constexpr int O_SC = O_PB + 32 * BN;       // scales: 2 rows x BN f32
constexpr int O_MN = O_SC + 2 * BN * 4;    // mins: 2 rows x BN f32
constexpr int O_GS = O_MN + 2 * BN * 4;    // min term A: BM rows x 16 bf16
constexpr int SLOT = (O_GS + BM * 32 + 1023) / 1024 * 1024;
// one expanded buffer: codes, N rows of 64 bf16 (128-byte swizzle)
constexpr int E_B = 0;
constexpr int E_S = E_B + BN * BK * 2;     // scale of each 32-K group: 2 x BN
constexpr int E_M = E_S + 2 * BN * 4;      // min term B: BN rows x 16 bf16
constexpr int EBUF = (E_M + BN * 32 + 1023) / 1024 * 1024;
// + 1024: the base is rounded up to the swizzle pattern's 1024 bytes
constexpr int SMEM = STAGES * SLOT + 2 * EBUF + 1024;
static_assert(SMEM <= 232448, "over the H100's shared memory per block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte offset of element (row, k) in a K-major tile of 64-bf16 rows with
// the 128-byte swizzle: 16-byte chunk k / 8 lands at chunk (k / 8) ^ (row % 8)
__device__ __forceinline__ int sw128(int row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2;
}

// byte offset of byte n of staged plane row r (rows of BN bytes): the
// 16-byte chunks are XOR-swizzled by r / 4, so that the 16 rows 4 apart
// that a warp reads at once fall in distinct banks
__device__ __forceinline__ int prow(int r, int n) {
  return r * BN + ((((n >> 4) ^ (r >> 2)) & 7) << 4) + (n & 15);
}

// byte offset of 16-byte half h of row r in a K-major tile of 16-bf16 rows
// without swizzle: core matrices of 8 rows x 16 bytes, 128 bytes apart
// along K, 256 along the rows
__device__ __forceinline__ int mn_off(int r, int h) {
  return (r >> 3) * 256 + h * 128 + (r & 7) * 16;
}

// wgmma shared-memory descriptor of a mn_off tile: LBO 128 bytes between
// the two core matrices along K, SBO 256 between 8-row groups, no swizzle
__device__ __forceinline__ uint64_t desc_inter(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile:
// start address, SBO = 1024 bytes between 8-row groups (LBO unused)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching a wgmma accumulator across this point
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, the warpgroup's fragment) (+)= A (64 x 16) . B (16 x
// 128), A and B bf16 K-major in shared memory; scale_d 0 starts a new sum
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// four byte codes 0..127 -> two bf16x2 of (code - bias): the bytes become
// the mantissas of 128 + code (bf16 0x43xx), then an exact bf16 subtract
__device__ __forceinline__ uint2 bytes_to_bf16(uint32_t v, uint32_t bias2) {
  uint32_t lo = __byte_perm(v, 0x43u, 0x4140);
  uint32_t hi = __byte_perm(v, 0x43u, 0x4342);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&bias2);
  __nv_bfloat162 l = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&lo), b);
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&hi), b);
  return make_uint2(*reinterpret_cast<uint32_t*>(&l),
                    *reinterpret_cast<uint32_t*>(&h));
}

// four int8 codes -> two bf16x2, through the exact f32 form 2^23 + (q + 128)
__device__ __forceinline__ uint2 int8_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
           8388736.f;
  __nv_bfloat162 l = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 h = __floats2bfloat162_rn(f[2], f[3]);
  return make_uint2(*reinterpret_cast<uint32_t*>(&l),
                    *reinterpret_cast<uint32_t*>(&h));
}

// -- the prologue: x -> x_hi, x_lo (bf16, Mpad rows) and the group sums ------
// One thread per 16 elements of a row; rows past M are written as zeros.
// A group's sum is the f32 sum of its 16 elements in order (for groups of
// 32, the two halves added). gsA holds, for each row and stage of 64 K, the
// min term's A operand: 16 bf16 [hi(sums), lo(sums), hi(sums), 0 ...],
// against the B rows [hi(mins), hi(mins), lo(mins), 0 ...] (expand_stage),
// so that one k16 wgmma adds sum x min to within 2^-17 of each.
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// one row of a min-term operand, 16 bf16 as two 16-byte halves d0, d1:
// a (the sums): [hi(v), lo(v), hi(v), 0 ...]; else (the mins):
// [hi(v), hi(v), lo(v), 0 ...]
template <int NV>
__device__ __forceinline__ void store_min_row(uint4* d0, uint4* d1,
                                              const float (&v)[NV], bool a) {
  uint32_t r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    __nv_bfloat16 hi, lo;
    split_bf16(v[i], hi, lo);
    const uint32_t h = __bfloat16_as_ushort(hi), l = __bfloat16_as_ushort(lo);
    r[i] = h;
    r[NV + i] = a ? l : h;
    r[2 * NV + i] = a ? h : l;
  }
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = r[2 * j] | (r[2 * j + 1] << 16);
  *d0 = make_uint4(w[0], w[1], w[2], w[3]);
  *d1 = make_uint4(w[4], w[5], w[6], w[7]);
}

__global__ void __launch_bounds__(NT)
split_x_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xh,
               __nv_bfloat16* __restrict__ xl, __nv_bfloat16* __restrict__ gsA,
               int M, int K, int group) {
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  const int sgs = K >> 4;
  const int m = (int)(idx / sgs), sg = (int)(idx % sgs);
  float v[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < M)
      f = *reinterpret_cast<const float4*>(x + (size_t)m * K + sg * 16 + 4 * i);
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
  uint32_t h[8], l[8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat16 hv[2], lv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s += v[2 * i + j];
      split_bf16(v[2 * i + j], hv[j], lv[j]);
    }
    __nv_bfloat162 hp = __halves2bfloat162(hv[0], hv[1]);
    __nv_bfloat162 lp = __halves2bfloat162(lv[0], lv[1]);
    h[i] = *reinterpret_cast<uint32_t*>(&hp);
    l[i] = *reinterpret_cast<uint32_t*>(&lp);
  }
  uint4* ph = reinterpret_cast<uint4*>(xh + (size_t)m * K + sg * 16);
  uint4* pl = reinterpret_cast<uint4*>(xl + (size_t)m * K + sg * 16);
  ph[0] = make_uint4(h[0], h[1], h[2], h[3]);
  ph[1] = make_uint4(h[4], h[5], h[6], h[7]);
  pl[0] = make_uint4(l[0], l[1], l[2], l[3]);
  pl[1] = make_uint4(l[4], l[5], l[6], l[7]);
  if (gsA != nullptr) {
    // the four 16-element sums of a stage sit in lanes 4i .. 4i + 3
    const float s1 = __shfl_down_sync(0xffffffffu, s, 1);
    const float s2 = __shfl_down_sync(0xffffffffu, s, 2);
    const float s3 = __shfl_down_sync(0xffffffffu, s, 3);
    uint4* dst = reinterpret_cast<uint4*>(gsA + ((size_t)m * (K / BK) + sg / 4) * 16);
    if ((sg & 3) == 0) {
      if (group == 32) {
        const float g[2] = {s + s1, s2 + s3};
        store_min_row(dst, dst + 1, g, true);
      } else {
        const float g[4] = {s, s1, s2, s3};
        store_min_row(dst, dst + 1, g, true);
      }
    }
  }
}

// -- the main kernel ---------------------------------------------------------
struct Args {
  const __nv_bfloat16* xh;
  const __nv_bfloat16* xl;
  const __nv_bfloat16* gsA;
  const uint8_t* qa;
  const uint8_t* qb;
  const uint8_t* sa;
  const uint8_t* sb;
  float* out;                  // (M, N), or (splits, M, N) partials
  int M, Mpad, N, K, splits;
};

// issue the copies of the stage of 64 K at k0 into ring slot s
template <int QT>
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* s, int k0,
                                           int m0, int n0, int tid) {
  const int N = a.N;
  // x_hi / x_lo: 128 rows x 8 chunks of 16 B, each to its swizzled place
#pragma unroll
  for (int i = 0; i < (BM * 8) / NT; ++i) {
    const int q = tid + NT * i, r = q >> 3, ch = q & 7;
    const size_t g = (size_t)(m0 + r) * a.K + k0 + ch * 8;
    cp16(s + O_XH + sw128(r, ch * 8), a.xh + g);
    cp16(s + O_XL + sw128(r, ch * 8), a.xl + g);
  }
  const int c = k0 >> 8, e0 = k0 & 255;
  // plane A: 64 rows x 8 chunks
  int row0;
  if constexpr (QT == Q8_0) row0 = k0;
  else if constexpr (QT == Q2_K) row0 = 64 * c;
  else row0 = 128 * c + (e0 & 127);
#pragma unroll
  for (int i = 0; i < (64 * 8) / NT; ++i) {
    const int q = tid + NT * i, r = q >> 3, ch = q & 7;
    cp16(s + O_PA + prow(r, ch * 16), a.qa + (size_t)(row0 + r) * N + n0 + ch * 16);
  }
  if constexpr (QT == Q5_0 || QT == Q5_1) {
    // all 32 qh rows of the chunk: one chunk of 16 B a thread
    const int r = tid >> 3, ch = tid & 7;
    cp16(s + O_PB + prow(r, ch * 16), a.qb + (size_t)(32 * c + r) * N + n0 + ch * 16);
  }
  if constexpr (QT == Q2_K) {
    if (tid < 32) {          // scd rows k0/16 .. +3
      const int r = tid >> 3, ch = tid & 7;
      cp16(s + O_PB + r * PS + ch * 16,
           a.sa + (size_t)((k0 >> 4) + r) * N + n0 + ch * 16);
    } else if (tid < 64) {   // dm rows 8c (d) and 8c + 1 (dmin): 256 B each
      const int r = (tid - 32) >> 4, ch = tid & 15;
      cp16(s + O_PB + 4 * PS + r * 2 * BN + ch * 16,
           a.sb + ((size_t)(8 * c + r) * N + n0) * 2 + ch * 16);
    }
  } else {
    if (tid < 64) {          // scales rows k0/32, +1: 512 B each
      const int r = tid >> 5, ch = tid & 31;
      cp16(s + O_SC + r * BN * 4 + ch * 16,
           a.sa + ((size_t)((k0 >> 5) + r) * N + n0) * 4 + ch * 16);
    } else if (Fmt<QT>::has_min && tid < 128) {
      const int r = (tid - 64) >> 5, ch = tid & 31;
      cp16(s + O_MN + r * BN * 4 + ch * 16,
           a.sb + ((size_t)((k0 >> 5) + r) * N + n0) * 4 + ch * 16);
    }
  }
  if constexpr (Fmt<QT>::has_min) {
    // the min term's A rows (split_x_kernel): 32 bytes a row
    const int r = tid >> 1, h = tid & 1;
    cp16(s + O_GS + mn_off(r, h),
         a.gsA + ((size_t)(m0 + r) * (a.K / BK) + k0 / BK) * 16 + h * 8);
  }
}

// expand the codes, scales and mins of the stage at k0 (ring slot s) into
// the expanded buffer e. A thread takes blocks of 4 K x 4 N: four plane
// words (4 columns of one row each), their codes, a 4 x 4 byte transpose,
// then 4 K of one column as bf16 to each of 4 swizzled rows. A warp covers
// all 64 K of 8 columns, so each store fills whole 128-byte rows.
template <int QT>
__device__ __forceinline__ void expand_stage(const uint8_t* s, uint8_t* e,
                                             int k0, int tid) {
  const int e0 = k0 & 255;
  const int lane = tid & 31, warp = tid >> 5;
  const int kq = lane & 15;                       // K rows 4kq .. 4kq + 3
  constexpr uint32_t bias = 128u + (uint32_t)Fmt<QT>::zero;
  // bf16 bits of 128 + zero (an integer <= 144: 8 significant bits)
  const __nv_bfloat16 bb = __float2bfloat16_rn((float)bias);
  const uint32_t bias2 = (uint32_t)__bfloat16_as_ushort(bb) * 0x10001u;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int n = 4 * (2 * (warp + 8 * p) + (lane >> 4));   // 4 columns
    uint32_t w[4], t[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int kk = 4 * kq + b;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(s + O_PA + prow(kk, n));
      if constexpr (QT == Q8_0) {
        w[b] = v;
      } else if constexpr (QT == Q2_K) {
        const uint32_t cr = (v >> (2 * (e0 >> 6))) & 0x03030303u;
        const uint32_t sc = *reinterpret_cast<const uint32_t*>(
                                s + O_PB + (kk >> 4) * PS + n) & 0x0F0F0F0Fu;
        const uint32_t m1 = (cr & 0x01010101u) * 0xFFu;
        const uint32_t m2 = ((cr >> 1) & 0x01010101u) * 0xFFu;
        w[b] = (sc & m1) + ((sc << 1) & m2);
      } else {
        uint32_t q = (e0 & 128) ? ((v >> 4) & 0x0F0F0F0Fu) : (v & 0x0F0F0F0Fu);
        if constexpr (QT == Q5_0 || QT == Q5_1) {
          const uint32_t h = *reinterpret_cast<const uint32_t*>(
              s + O_PB + prow(kk & 31, n));
          q |= ((h >> ((e0 >> 5) + (kk >> 5))) & 0x01010101u) << 4;
        }
        w[b] = q;
      }
    }
    transpose4(w, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 v = QT == Q8_0 ? int8_to_bf16(t[j]) : bytes_to_bf16(t[j], bias2);
      *reinterpret_cast<uint2*>(e + E_B + sw128(n + j, 4 * kq)) = v;
    }
  }
  if (tid < BN) {
    const int n = tid;
    float* es = reinterpret_cast<float*>(e + E_S);
    uint4* m0 = reinterpret_cast<uint4*>(e + E_M + mn_off(n, 0));
    uint4* m1 = reinterpret_cast<uint4*>(e + E_M + mn_off(n, 1));
    if constexpr (QT == Q2_K) {
      const unsigned short* dm =
          reinterpret_cast<const unsigned short*>(s + O_PB + 4 * PS);
      const float d = __half2float(__ushort_as_half(dm[n]));
      const float dmin = __half2float(__ushort_as_half(dm[BN + n]));
      es[n] = d;
      es[BN + n] = d;
      float mn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mn[j] = __fmul_rn((float)(s[O_PB + j * PS + n] >> 4), -dmin);
      store_min_row(m0, m1, mn, false);
    } else {
      const float* sc = reinterpret_cast<const float*>(s + O_SC);
      es[n] = sc[n];
      es[BN + n] = sc[BN + n];
      if constexpr (Fmt<QT>::has_min) {
        const float* mp = reinterpret_cast<const float*>(s + O_MN);
        const float mn[2] = {mp[n], mp[BN + n]};
        store_min_row(m0, m1, mn, false);
      }
    }
  }
}

// issue the four wgmmas of 32-K group grp of a stage into p
__device__ __forceinline__ void mma_group(float (&p)[64], uint32_t xh,
                                          uint32_t xl, uint32_t cb, int grp) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint32_t off = (grp * 2 + ks) * 32;     // 16 bf16 of K
    const uint64_t db = desc_sw128(cb + off);
    wgmma_128(p, desc_sw128(xl + off), db, ks);
    wgmma_128(p, desc_sw128(xh + off), db, 1);
  }
}

// acc += scale * p for 32-K group grp of a stage; the fragment of thread
// (warp wq, lane): rows 16 wq + lane / 4 and + 8 of the warpgroup's 64,
// columns 8 j + 2 (lane % 4) + {0, 1}
__device__ __forceinline__ void fold_group(float (&acc)[64], const float (&p)[64],
                                           const uint8_t* e, int grp, int lane) {
  const float* es = reinterpret_cast<const float*>(e + E_S) + grp * BN;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 sc = *reinterpret_cast<const float2*>(es + 8 * j + 2 * (lane & 3));
    float* c = acc + 4 * j;
    c[0] = fmaf(sc.x, p[4 * j], c[0]);
    c[1] = fmaf(sc.y, p[4 * j + 1], c[1]);
    c[2] = fmaf(sc.x, p[4 * j + 2], c[2]);
    c[3] = fmaf(sc.y, p[4 * j + 3], c[3]);
  }
}

template <int QT>
__global__ void __launch_bounds__(NT, 1) qmm_tc_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on one
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* ebuf = smem + STAGES * SLOT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                     // rows 64 wg .. 64 wg + 63
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int T = a.K / BK;
  const int t0 = (int)((long long)blockIdx.z * T / a.splits);
  const int t1 = (int)((long long)(blockIdx.z + 1) * T / a.splits);
  const int nt = t1 - t0;

  float acc[64], p0[64], p1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = p0[i] = p1[i] = 0.f;

  // stages 0 and 1 in flight, stage 0 expanded
  load_stage<QT>(a, ring, t0 * BK, m0, n0, tid);
  cp_commit();
  if (nt > 1) load_stage<QT>(a, ring + SLOT, (t0 + 1) * BK, m0, n0, tid);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  expand_stage<QT>(ring, ebuf, t0 * BK, tid);

  for (int t = 0; t < nt; ++t) {
    // stage t + 1 has landed, stage t is expanded, and every wgmma of
    // stage t - 1 is done: its slot and expanded buffer may be refilled.
    // The fence hands this thread's shared-memory writes to wgmma's proxy.
    cp_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + 2 < nt)
      load_stage<QT>(a, ring + ((t + 2) % STAGES) * SLOT, (t0 + t + 2) * BK,
                     m0, n0, tid);
    cp_commit();
    const uint8_t* sl = ring + (t % STAGES) * SLOT;
    const uint8_t* eb = ebuf + (t & 1) * EBUF;
    const uint32_t xh = smem_u32(sl + O_XH) + wg * 64 * 128;
    const uint32_t xl = smem_u32(sl + O_XL) + wg * 64 * 128;
    const uint32_t cb = smem_u32(eb + E_B);
    reg_fence(acc);
    reg_fence(p0);
    reg_fence(p1);
    wg_fence();
    if constexpr (Fmt<QT>::has_min) {
      // the min term, sum x min of the stage's groups, straight into acc
      wgmma_128(acc, desc_inter(smem_u32(sl + O_GS) + wg * 8 * 256),
                desc_inter(smem_u32(eb + E_M)), 1);
      wg_commit();
    }
    mma_group(p0, xh, xl, cb, 0);
    wg_commit();
    mma_group(p1, xh, xl, cb, 1);
    wg_commit();
    if (t + 1 < nt)
      expand_stage<QT>(ring + ((t + 1) % STAGES) * SLOT,
                       ebuf + ((t + 1) & 1) * EBUF, (t0 + t + 1) * BK, tid);
    wg_wait<1>();                  // the min term and group 0 are done
    reg_fence(acc);
    reg_fence(p0);
    fold_group(acc, p0, eb, 0, lane);
    wg_wait<0>();
    reg_fence(p1);
    fold_group(acc, p1, eb, 1, lane);
  }

  float* out = a.out + (size_t)blockIdx.z * a.M * a.N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    if (m < a.M) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + (size_t)m * a.N + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// out[i] = sum over the splits of part[s][i], in split order
__global__ void __launch_bounds__(NT)
sum_splits_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                  long long n4, int splits) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int p = 1; p < splits; ++p) {
    const float4 v = part[(size_t)p * n4 + i];
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  out[i] = s;
}

template <int QT>
int launch(const Args& a, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_tc_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid(a.Mpad / BM, a.N / BN, a.splits);
  qmm_tc_kernel<QT><<<grid, NT, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. x: (M, K) f32; qa: qs / q2 / q8 plane; qb: qh (Q5_x) or
// null; sa: scales (Q2_K: scd); sb: mins (Q2_K: dm) or null; out (M, N)
// f32; ws: the workspace, x_hi and x_lo (Mpad x K bf16 each, Mpad = M
// rounded up to 128), the min term's A rows (Mpad x K / 64 x 16 bf16)
// and, where splits > 1, the partials (splits x M x N f32). Every pointer 16-byte
// aligned, N % 128 == 0, K % 256 == 0, 1 <= splits <= K / 64. Three
// launches (split x, the product, the sum of the splits where splits > 1);
// returns the first CUDA error (0 = launched).
extern "C" int tl_qmm_f32(int qtype, const void* x, const void* qa,
                          const void* qb, const void* sa, const void* sb,
                          void* out, void* ws, int M, int N, int K, int splits,
                          void* stream) {
  if (M <= 0 || N % BN != 0 || K % 256 != 0 || splits < 1 || splits > K / BK ||
      !known_format(qtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int mpad = (M + BM - 1) / BM * BM;
  uint8_t* w = (uint8_t*)ws;
  Args a;
  a.xh = (const __nv_bfloat16*)w;
  a.xl = a.xh + (size_t)mpad * K;
  __nv_bfloat16* gsA = (__nv_bfloat16*)(w + (size_t)mpad * K * 4);
  const bool has_min = qtype == Q4_1 || qtype == Q5_1 || qtype == Q2_K;
  a.gsA = gsA;
  a.qa = (const uint8_t*)qa;
  a.qb = (const uint8_t*)qb;
  a.sa = (const uint8_t*)sa;
  a.sb = (const uint8_t*)sb;
  float* part = (float*)(gsA + (size_t)mpad * (K / BK) * 16);
  a.out = splits > 1 ? part : (float*)out;
  a.M = M; a.Mpad = mpad; a.N = N; a.K = K; a.splits = splits;

  const long long items = (long long)mpad * (K / 16);     // a multiple of NT
  split_x_kernel<<<(unsigned)(items / NT), NT, 0, st>>>(
      (const float*)x, (__nv_bfloat16*)a.xh, (__nv_bfloat16*)a.xl,
      has_min ? gsA : nullptr, M, K, qtype == Q2_K ? 16 : 32);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  switch (qtype) {
    case Q4_0: rc = launch<Q4_0>(a, st); break;
    case Q4_1: rc = launch<Q4_1>(a, st); break;
    case Q5_0: rc = launch<Q5_0>(a, st); break;
    case Q5_1: rc = launch<Q5_1>(a, st); break;
    case Q8_0: rc = launch<Q8_0>(a, st); break;
    default:   rc = launch<Q2_K>(a, st); break;
  }
  if (rc != 0 || splits == 1) return rc;
  const long long n4 = (long long)M * N / 4;
  sum_splits_kernel<<<(unsigned)((n4 + NT - 1) / NT), NT, 0, st>>>(
      (const float4*)part, (float4*)out, n4, splits);
  return (int)cudaGetLastError();
}
