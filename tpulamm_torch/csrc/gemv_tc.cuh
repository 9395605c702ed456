// gemv_tc.cuh -- the products of a single-stream decode step on the tensor
// cores (mega_decode.cu): y (N) = x (K) @ W (K, N) at M = 1, for W in the
// mm planes of any of the six formats and x bf16 in shared memory.
//
//   tc_gemv     one product (or two sharing x: a fused gate|up) spread
//               over every warp of the grid, with a caller's staging of x
//               and epilogue of y
//
// Numerics. x is bf16 (a normed residual rounded to bf16, the attention
// output, act(gate) * up) and the codes minus their zero point are small
// integers, exact in bf16 (Q4 / Q5 within +-16, Q8_0's int8 within +-128,
// Q2_K's crumbs 0..3). So mma.sync m16n8k16 (bf16 in, f32 sums) gives
// sum (q - zero) x over 16 elements of one group exactly as f32 would up
// to the order of its sums; the f32 group scale multiplies each such sum,
// and a format with mins adds min * sum x (sums of x over 16 elements,
// made once when x is staged). The result differs from the plain version
// (f32 dequantized weights, ops/qtensor.py::dequant_mm) only in the order
// of f32 sums.
//
// The tensor core at M = 1, A and B swapped: a warp's 128 columns are the
// 16 rows of eight m16 tiles (tile j, row r <-> column 16 (r % 8) + 2 j +
// r / 8), K is the mma's k16, and x fills B's eight columns alike, so each
// lane of a quad ends up with the same sums and keeps the 4 columns that
// its float4 of scales covers (16 g + 4 t ..). Codes become bf16 without
// a conversion instruction: a byte permute pairs the codes of two plane
// rows, a lop3 ORs them into 0x4300 (bf16 128.0) and one bf16x2 subtract
// of 128 + zero leaves q - zero (Q8_0: 128 + (q & 127) minus 128 or 256 by
// the sign bit).
//
// What bounds it on an H100: the bytes of the planes (Q4_0 0.625 B a
// weight), read once. A step is 16 plane rows x 128 columns (2 KB of
// codes) with their scales; each lane copies its 4 rows x 16 columns and
// its 4 columns of scales as 16-byte cp.async pieces into its warp's ring
// in shared memory (12 KB a warp, 4 Q4_0 steps), so 3 steps are in flight
// while one is read, and no register waits on a load until its step's
// math. A product stages x once into shared memory, so the loop holds no
// block barrier. Work is spread over warps, not blocks: the (column tile,
// matrix, step) positions of a product form one line, cut into equal
// ranges, one a warp of the grid; a warp's sums for a tile go to a slot of
// `partial`, and the warp that completes a tile adds the tile's slots in a
// fixed order and runs the epilogue, so two runs give the same bits. K
// past XCH chunks is cut into windows, each taken by its own group of
// blocks.

#pragma once

#include <cuda_bf16.h>

// points of a step that the timeline build of tools/mega_ablation.py
// stamps (block 0, thread 0; it also stamps gemv_stage.cuh's grid_sync);
// nothing otherwise
#define TL_START()
#define TL_MARK(id)

#include "gemv_stage.cuh"

namespace tlt {

using namespace tlg;

constexpr int XCH = 128;              // 256-element chunks of x a window holds

// shared memory of a product's x: bf16 x, then f32 sums of 16 elements
__host__ __device__ constexpr int x_smem_bytes(int kch) {
  return kch * 256 * 2 + kch * 16 * 4;
}

template <int QT> __host__ __device__ constexpr int steps_per_chunk() {
  return QT == Q8_0 ? 16 : (QT == Q2_K ? 4 : 8);
}

// one step's operands in a lane's registers, read from its ring stage:
// the codes of plane rows 2t, 2t+1, 2t+8, 2t+9 of the step in its 16
// columns, the Q5 qh rows alike, the scales (and mins) of its 4 columns
template <int QT> struct Step {
  uint4 q[4];
  uint4 h[4];            // Q5_x
  float4 s[2], m[2];     // low / high group (Q8_0: s[0]; no Q2_K)
  uint32_t sc[4];        // Q2_K: the scd bytes of the step's 4 groups
  uint2 dm[2];           // Q2_K: d, dmin (fp16) of the chunk
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
template <int B>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "n"(B)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// d = A (16 x 16) B (16 x 8), f32 sums from zero
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// the first plane row of step sub of chunk c (steps of 16 plane rows;
// Q5_x in the order that keeps one set of qh rows for 4 steps running)
template <int QT>
__device__ __forceinline__ int step_row(int c, int sub) {
  if constexpr (QT == Q8_0) return 256 * c + 16 * sub;
  else if constexpr (QT == Q2_K) return 64 * c + 16 * sub;
  else if constexpr (QT == Q5_0 || QT == Q5_1)
    return 128 * c + 16 * (sub >> 2) + 32 * (sub & 3);
  else return 128 * c + 16 * sub;
}

// A ring stage holds one step's operands, 16 bytes a lane in each slot
// (slot k of lane l at 16 (32 k + l)): the codes of rows 2t, 2t+1, 2t+8,
// 2t+9 (slots 0-3), Q5_x's qh rows alike (4-7), then the scales of the
// low and high group and their mins (Q2_K: the 4 scd words, then d and
// dmin).
template <int QT> __host__ __device__ constexpr int slot_s() {
  return QT == Q5_0 || QT == Q5_1 ? 8 : 4;
}
template <int QT> __host__ __device__ constexpr int stage_bytes() {
  return 512 * (slot_s<QT>() + (QT == Q8_0 ? 1 : 2) +
                (Fmt<QT>::has_min && QT != Q2_K ? 2 : 0));
}
// each warp's ring: as many stages as 12 KB holds, at least 2
constexpr int WARP_RING_BYTES = 12288;
constexpr int RING_BYTES = WARPS * WARP_RING_BYTES;      // a block's rings
template <int QT> __host__ __device__ constexpr int ring_stages() {
  return WARP_RING_BYTES / stage_bytes<QT>() < 2
             ? 2 : WARP_RING_BYTES / stage_bytes<QT>();
}

// step (c, sub)'s operands into a ring stage: col16 is the first of the
// lane's 16 code columns, col4 of its 4 scale columns
template <int QT>
__device__ __forceinline__ void copy_step(unsigned char* stage, const Planes& p,
                                          int c, int sub, int col16, int col4,
                                          int lane) {
  const size_t N = p.ld;
  const int t = lane & 3;
  const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
  unsigned char* slot = stage + 16 * lane;          // slot k at 512 k
  const int row0 = step_row<QT>(c, sub);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    cp_async16(slot + 512 * k, p.qa + (size_t)(row0 + rows[k]) * N + col16);
  if constexpr (QT == Q5_0 || QT == Q5_1) {
    const int h0 = 32 * c + 16 * (sub >> 2);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      cp_async16(slot + 512 * (4 + k), p.qb + (size_t)(h0 + rows[k]) * N + col16);
  }
  constexpr int S = slot_s<QT>();
  if constexpr (QT == Q2_K) {
#pragma unroll
    for (int tc = 0; tc < 4; ++tc)
      cp_async_small<4>(slot + 512 * S + 4 * tc,
                        (const uint8_t*)p.sa + (size_t)(16 * c + sub + 4 * tc) * N + col4);
    const unsigned short* dm = (const unsigned short*)p.sb;
    cp_async_small<8>(slot + 512 * (S + 1), dm + (size_t)(8 * c) * N + col4);
    cp_async_small<8>(slot + 512 * (S + 1) + 8, dm + (size_t)(8 * c + 1) * N + col4);
  } else {
    int g[2];
    if constexpr (QT == Q8_0) {
      g[0] = g[1] = 8 * c + (sub >> 1);
    } else if constexpr (QT == Q5_0 || QT == Q5_1) {
      g[0] = 8 * c + (sub & 3);
      g[1] = g[0] + 4;
    } else {
      g[0] = 8 * c + (sub >> 1);
      g[1] = g[0] + 4;
    }
    constexpr int ng = QT == Q8_0 ? 1 : 2;
#pragma unroll
    for (int i = 0; i < ng; ++i) {
      cp_async16(slot + 512 * (S + i), (const float*)p.sa + (size_t)g[i] * N + col4);
      if constexpr (Fmt<QT>::has_min)
        cp_async16(slot + 512 * (S + 2 + i), (const float*)p.sb + (size_t)g[i] * N + col4);
    }
  }
}

// a landed stage's operands into the lane's registers
template <int QT>
__device__ __forceinline__ void read_step(const unsigned char* stage, int lane,
                                          Step<QT>& r) {
  const uint4* s4 = reinterpret_cast<const uint4*>(stage) + lane;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.q[k] = s4[32 * k];
  if constexpr (QT == Q5_0 || QT == Q5_1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) r.h[k] = s4[32 * (4 + k)];
  }
  constexpr int S = slot_s<QT>();
  if constexpr (QT == Q2_K) {
    const uint4 sc = s4[32 * S], dm = s4[32 * (S + 1)];
    r.sc[0] = sc.x;
    r.sc[1] = sc.y;
    r.sc[2] = sc.z;
    r.sc[3] = sc.w;
    r.dm[0] = make_uint2(dm.x, dm.y);
    r.dm[1] = make_uint2(dm.z, dm.w);
  } else {
    constexpr int ng = QT == Q8_0 ? 1 : 2;
#pragma unroll
    for (int i = 0; i < ng; ++i) {
      r.s[i] = reinterpret_cast<const float4*>(s4)[32 * (S + i)];
      if constexpr (Fmt<QT>::has_min)
        r.m[i] = reinterpret_cast<const float4*>(s4)[32 * (S + 2 + i)];
    }
  }
}

// v = the sums of this lane's 4 columns over one k16 step: frag(j, a)
// builds the A fragment of m16 tile j; b0, b1 are x's B fragment
template <class Frag>
__device__ __forceinline__ void k16(Frag&& frag, uint32_t b0, uint32_t b1,
                                    int t, float (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t a[4];
    frag(j, a);
    float d[4];
    mma16816(d, a, b0, b1);
    if ((j >> 1) == t) {
      v[2 * (j & 1)] = d[0];
      v[2 * (j & 1) + 1] = d[2];
    }
  }
}

// the byte pairs of column pair j: bytes (row a, col 2j), (row a, 2j + 1),
// (row b, 2j), (row b, 2j + 1)
__device__ __forceinline__ uint32_t pair_bytes(const uint4& ra, const uint4& rb,
                                               int j) {
  return __byte_perm(word(ra, j >> 1), word(rb, j >> 1),
                     (j & 1) ? 0x7632 : 0x5410);
}

__device__ __forceinline__ uint32_t xfrag(const __nv_bfloat16* xs, int e) {
  return *reinterpret_cast<const uint32_t*>(xs + e);
}

// tot[i] += this step's contribution to the lane's 4 columns; e0 = the
// step's first element relative to the staged window
template <int QT>
__device__ __forceinline__ void step_math(const uint4 (&q)[4], const Step<QT>& r,
                                          int sub, int e0,
                                          const __nv_bfloat16* __restrict__ xs,
                                          const float* __restrict__ s16, int t,
                                          float (&tot)[4]) {
  constexpr uint32_t M4 = 0x000F000Fu, M2 = 0x00030003u, BF = 0x43004300u;
  if constexpr (QT == Q8_0) {
    float v[4];
    k16([&](int j, uint32_t (&a)[4]) {
          const uint32_t p01 = pair_bytes(q[0], q[1], j);
          const uint32_t p89 = pair_bytes(q[2], q[3], j);
          const uint32_t ps[4] = {p01, p01 >> 8, p89, p89 >> 8};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = bsub2((ps[i] & 0x007F007Fu) | BF, (ps[i] & 0x00800080u) | BF);
        },
        xfrag(xs, e0 + 2 * t), xfrag(xs, e0 + 2 * t + 8), t, v);
    const float s[4] = {r.s[0].x, r.s[0].y, r.s[0].z, r.s[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[i] = fmaf(v[i], s[i], tot[i]);
  } else if constexpr (QT == Q2_K) {
    const uint32_t bias = 0x43004300u;                  // 128
    float d[4], dmin[4];
    {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(&r.dm[0]);
      const unsigned short* hm = reinterpret_cast<const unsigned short*>(&r.dm[1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[i] = __half2float(__ushort_as_half(h[i]));
        dmin[i] = __half2float(__ushort_as_half(hm[i]));
      }
    }
#pragma unroll
    for (int tc = 0; tc < 4; ++tc) {
      const int e = e0 + 64 * tc;
      float v[4];
      k16([&](int j, uint32_t (&a)[4]) {
            const uint32_t p01 = pair_bytes(q[0], q[1], j);
            const uint32_t p89 = pair_bytes(q[2], q[3], j);
            const uint32_t ps[4] = {p01 >> (2 * tc), p01 >> (8 + 2 * tc),
                                    p89 >> (2 * tc), p89 >> (8 + 2 * tc)};
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = bsub2((ps[i] & M2) | BF, bias);
          },
          xfrag(xs, e + 2 * t), xfrag(xs, e + 2 * t + 8), t, v);
      const float sx = s16[e >> 4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = (int)((r.sc[tc] >> (8 * i)) & 0xFFu);
        const float s = __fmul_rn((float)(b & 15), d[i]);
        const float mn = __fmul_rn((float)(b >> 4), -dmin[i]);
        tot[i] = fmaf(mn, sx, fmaf(v[i], s, tot[i]));
      }
    }
  } else {
    // Q4_x / Q5_x: the low nibbles are elements e0 .. e0 + 15, the high
    // ones e0 + 128 ..; Q5_x's fifth bit is bit m (low) / m + 4 (high) of
    // the qh bytes
    constexpr bool q5 = QT == Q5_0 || QT == Q5_1;
    const int m = sub & 3;
    const uint32_t bias = QT == Q4_0 ? 0x43084308u                // 136
                        : (QT == Q5_0 ? 0x43104310u : 0x43004300u);  // 144, 128
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int e = e0 + 128 * hi;
      float v[4];
      k16([&](int j, uint32_t (&a)[4]) {
            const uint32_t p01 = pair_bytes(q[0], q[1], j);
            const uint32_t p89 = pair_bytes(q[2], q[3], j);
            const uint32_t ps[4] = {p01 >> (4 * hi), p01 >> (8 + 4 * hi),
                                    p89 >> (4 * hi), p89 >> (8 + 4 * hi)};
            uint32_t hb[4] = {0u, 0u, 0u, 0u};
            if constexpr (q5) {
              const uint32_t h01 = pair_bytes(r.h[0], r.h[1], j);
              const uint32_t h89 = pair_bytes(r.h[2], r.h[3], j);
              // bit m (+ 4) of byte 0 / 2 (column 2j) or 1 / 3 (2j + 1)
              // to bit 4 of its bf16 half
              if (hi) {
                hb[0] = h01 >> m;
                hb[1] = h01 >> (8 + m);
                hb[2] = h89 >> m;
                hb[3] = h89 >> (8 + m);
              } else {
                hb[0] = h01 << (4 - m);
                hb[1] = h01 >> (4 + m);
                hb[2] = h89 << (4 - m);
                hb[3] = h89 >> (4 + m);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[i] = bsub2((ps[i] & M4) | (hb[i] & 0x00100010u) | BF, bias);
          },
          xfrag(xs, e + 2 * t), xfrag(xs, e + 2 * t + 8), t, v);
      const float4 s4 = r.s[hi];
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      if constexpr (Fmt<QT>::has_min) {
        const float4 m4 = r.m[hi];
        const float mn[4] = {m4.x, m4.y, m4.z, m4.w};
        const float sx = s16[e >> 4];
#pragma unroll
        for (int i = 0; i < 4; ++i) tot[i] = fmaf(mn[i], sx, fmaf(v[i], s[i], tot[i]));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) tot[i] = fmaf(v[i], s[i], tot[i]);
      }
    }
  }
}

// the first element (relative to chunk c's start) of step sub
template <int QT>
__device__ __forceinline__ int step_elem(int sub) {
  if constexpr (QT == Q5_0 || QT == Q5_1) return 16 * (sub >> 2) + 32 * (sub & 3);
  else return 16 * sub;
}

// A product's line of work: the (column tile, matrix, chunk, step) of
// window w, in that order, cut into equal ranges, one a warp of the
// window's blocks. Windows cut K into nwin near-equal runs of chunks (one
// run when K <= XCH chunks); window w is taken by blocks [b0, b1).
struct Window {
  int nwin, w, c0, c1, b0, b1;
  int line;                // positions of one column tile
  long long len;           // positions on the line
  int nw;                  // warps with work: no more than positions, so
                           // that no range is empty
  __device__ Window(int K, int ntile, int per_chunk, int v = -1) {
    const int kch = K / 256, B = gridDim.x;
    nwin = (kch + XCH - 1) / XCH;
    w = v >= 0 ? v : (((int)blockIdx.x + 1) * nwin - 1) / B;
    c0 = w * kch / nwin;
    c1 = (w + 1) * kch / nwin;
    b0 = w * B / nwin;
    b1 = (w + 1) * B / nwin;
    line = per_chunk * (c1 - c0);
    len = (long long)ntile * line;
    nw = (int)((long long)(b1 - b0) * WARPS < len ? (b1 - b0) * WARPS : len);
  }
  // the first position of the window's warp i (i <= nw)
  __device__ int start(int i) const { return (int)(len * i / nw); }
  // the warp that holds position pos
  __device__ int warp_at(long long pos) const {
    return (int)(((pos + 1) * nw + len - 1) / len) - 1;
  }
  // the slot of the sums of the window's warp i for tile `tile`: warps of
  // the grid plus tiles of all windows, so no two (warp, tile) share one
  __device__ int slot(int i, int tile, int ntile) const {
    return b0 * WARPS + i + w * ntile + tile;
  }
};

// f32 elements of `partial` for a product of NW matrices of N columns and
// K rows over `blocks` blocks: a slot of NW x 128 sums for each warp of
// the grid and each column tile of each window (Window::slot)
inline long long partial_floats(long long N, long long K, int NW, int blocks) {
  const long long nwin = (K / 256 + XCH - 1) / XCH;
  return ((long long)blocks * WARPS + nwin * (N / TILE_N)) * NW * TILE_N;
}

// a position on a product's line as (tile, matrix, chunk, step)
struct Cursor {
  int tile, q, c, sub;
  template <int NW, int SPC>
  __device__ __forceinline__ void seek(const Window& win, int pos) {
    tile = pos / win.line;
    const int r = pos - tile * win.line, nsw = win.line / NW;
    q = r / nsw;
    c = win.c0 + (r - q * nsw) / SPC;
    sub = (r - q * nsw) % SPC;
  }
  template <int NW, int SPC>
  __device__ __forceinline__ void next(const Window& win) {
    if (++sub < SPC) return;
    sub = 0;
    if (++c < win.c1) return;
    c = win.c0;
    if (++q < NW) return;
    q = 0;
    ++tile;
  }
};

// step u's operands into a ring stage
template <int QT, int NW>
__device__ __forceinline__ void copy_at(unsigned char* stage,
                                        const Planes (&w)[NW], const Cursor& u,
                                        int lane) {
  const int col = u.tile * TILE_N;
#pragma unroll
  for (int q = 0; q < NW; ++q)
    if (q == u.q)
      copy_step<QT>(stage, w[q], u.c, u.sub, w[q].off + col + 16 * (lane >> 2),
                    w[q].off + col + 4 * lane, lane);
}

// What a product's caller supplies (mega_decode.cu): for `phase` of layer
// l and its context ctx,
//   Ops::stage(ctx, phase, l, xs, s16, e0, e1, sums): all threads write
//     x[e0 .. e1) as bf16 into xs and, if sums, the f32 sums of its
//     16-element groups into s16; ends with __syncthreads
//   Ops::epi(ctx, phase, l, n, v): column n's NW sums v[0 .. NW) become
//     the phase's output

// This warp's sums for `tile` go to their slot; the warp that brings the
// tile's count to its number of slots adds them in slot order and runs
// the epilogue. tot is zeroed.
template <class Ops, int NW, int SPC>
__device__ __forceinline__ void flush_tile(float (&tot)[NW][4], const Window& win,
                                           int i, int tile, int K, int ntile,
                                           float* __restrict__ partial,
                                           unsigned int* __restrict__ counters,
                                           const void* ctx, int phase, int l) {
  const int lane = threadIdx.x & 31;
  float* pp = partial + (size_t)win.slot(i, tile, ntile) * NW * TILE_N + 4 * lane;
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    __stcg(reinterpret_cast<float4*>(pp + q * TILE_N),
           make_float4(tot[q][0], tot[q][1], tot[q][2], tot[q][3]));
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[q][j] = 0.f;
  }
  int nseg = 0;
  for (int v = 0; v < win.nwin; ++v) {
    const Window o(K, ntile, NW * SPC, v);
    nseg += o.warp_at((long long)(tile + 1) * o.line - 1) -
            o.warp_at((long long)tile * o.line) + 1;
  }
  __syncwarp();                           // the lanes' sums are stored
  unsigned int old = 0;
  if (lane == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    old = atomicAdd(&counters[tile], 1u);
    if (old == (unsigned int)(nseg - 1)) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  old = __shfl_sync(0xffffffffu, old, 0);
  if (old != (unsigned int)(nseg - 1)) return;
  __syncwarp();
  float y[NW][4] = {};
  for (int v = 0; v < win.nwin; ++v) {
    const Window o(K, ntile, NW * SPC, v);
    const int lo = o.warp_at((long long)tile * o.line);
    const int hi = o.warp_at((long long)(tile + 1) * o.line - 1);
    for (int u = lo; u <= hi; ++u) {
      const float* sp = partial + (size_t)o.slot(u, tile, ntile) * NW * TILE_N + 4 * lane;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(sp + q * TILE_N));
        y[q][0] += a.x;
        y[q][1] += a.y;
        y[q][2] += a.z;
        y[q][3] += a.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[NW];
#pragma unroll
    for (int q = 0; q < NW; ++q) v[q] = y[q][j];
    Ops::epi(ctx, phase, l, tile * TILE_N + 4 * lane + j, v);
  }
  if (lane == 0) counters[tile] = 0u;
}

// A warp's share of a product: its window and its positions [p0, p1)
template <int QT, int NW> struct Share {
  static constexpr int SPC = steps_per_chunk<QT>();
  Window win;
  int i, p0, p1;
  __device__ Share(int N, int K) : win(K, N / TILE_N, NW * SPC) {
    i = ((int)blockIdx.x - win.b0) * WARPS + (int)(threadIdx.x >> 5);
    const bool busy = i < win.nw;
    p0 = busy ? win.start(i) : 0;
    p1 = busy ? win.start(i + 1) : 0;
  }
};

// y = x @ W for NW matrices W (N columns, K rows; NW = 2: a fused gate|up
// whose two views share the column range; w in shared memory), the x and
// the epilogue of `phase` of layer l (see Ops above). Every block calls
// it; after it returns, a grid barrier makes y visible. smem holds x's
// window at 0, the warps' rings at ring_off. partial: (warps of the grid
// + windows x N / 128) x NW x 128 f32 scratch; counters: N / 128 zeroed
// words, left zeroed. The warp's first steps are requested before x is
// staged, so their latency hides the staging's.
template <class Ops, int QT, int NW>
__device__ __noinline__ void tc_gemv(unsigned char* smem, int ring_off,
                                     const Planes* w, int N, int K,
                                     float* __restrict__ partial,
                                     unsigned int* __restrict__ counters,
                                     const void* ctx, int phase, int l) {
  constexpr int SPC = steps_per_chunk<QT>();
  constexpr int R = ring_stages<QT>(), SB = stage_bytes<QT>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  Planes pw[NW];                          // in registers
#pragma unroll
  for (int q = 0; q < NW; ++q) pw[q] = w[q];
  const int ntile = N / TILE_N;
  const Share<QT, NW> sh(N, K);
  const Window& win = sh.win;
  const int i = sh.i, p0 = sh.p0, p1 = sh.p1;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s16 = reinterpret_cast<float*>(smem + (size_t)(win.c1 - win.c0) * 512);
  unsigned char* ring = smem + ring_off + warp * WARP_RING_BYTES;
  Cursor cur{};
  cur.seek<NW, SPC>(win, p0);
  Cursor ahead = cur;
#pragma unroll
  for (int k = 0; k < R - 1; ++k) {       // steps p0 .. p0 + R - 2
    if (p0 + k < p1) copy_at<QT, NW>(ring + k * SB, pw, ahead, lane);
    cp_async_commit();
    ahead.next<NW, SPC>(win);
  }
  TL_MARK(1);
  Ops::stage(ctx, phase, l, xs, s16, 256 * win.c0, 256 * win.c1,
             Fmt<QT>::has_min);
  TL_MARK(2);
  float tot[NW][4] = {};
#pragma unroll 1
  for (int p = p0; p < p1; ++p) {
    const int j = p - p0;
    if (p + R - 1 < p1) copy_at<QT, NW>(ring + ((j + R - 1) % R) * SB, pw, ahead, lane);
    cp_async_commit();
    ahead.next<NW, SPC>(win);
    cp_async_wait<R - 1>();               // step p's operands have landed
    Step<QT> st;
    read_step<QT>(ring + (j % R) * SB, lane, st);
    const int e0 = 256 * (cur.c - win.c0) + step_elem<QT>(cur.sub);
#pragma unroll
    for (int q = 0; q < NW; ++q)
      if (q == cur.q)
        step_math<QT>(st.q, st, cur.sub, e0, xs, s16, t, tot[q]);
    const int tile = cur.tile;
    cur.next<NW, SPC>(win);
    if (p + 1 == p1 || cur.tile != tile)
      flush_tile<Ops, NW, SPC>(tot, win, i, tile, K, ntile, partial, counters,
                               ctx, phase, l);
  }
  TL_MARK(3);
  cp_async_wait<0>();                     // no copy outlives the product
}

}  // namespace tlt
