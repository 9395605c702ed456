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
//     (Q4_x 0..15, Q5_x 0..31, Q8_0 signed, Q2_K crumbs 0..3), exact.
//
// What bounds it on an H100: a decode step reads every weight plane once
// (~0.625 B a weight for Q4_0) and does 2*M*K*N operations, so at M <= 16
// it is bound by the bytes it moves; the floor is plane bytes / 3.35 TB/s.
//
// Design for that bound.
// - The prologue gives each 32-group 8 lanes (4 for a 16-group), a float4
//   each: coalesced loads, a grid that covers the card, amax by shuffles
//   (a max does not depend on order), the group sum in a fixed tree order.
//   quant_lanes is the one device function of the prologue and of the
//   in-kernel quantization, so both give the same codes, scales and sums;
//   its codes and scales equal the plain version's (the same __fdiv_rn,
//   rintf and clip).
// - The gemv on the int8 tensor cores: mma.sync m16n8k32 s8 (m16n8k16
//   for Q2_K's 16-groups). A = the weight codes, 16 columns x the 32 k of
//   one group; B = the activation codes, whose 8 columns hold rows of x
//   (M <= 8 one n8 tile, M <= 16 two), so every plane is read once
//   whatever M is. At M = 1 x fills all 8 columns alike and each lane
//   keeps the 4 columns its float4 of scales covers. Each group's int32
//   dot is exact and is rescaled in f32 at once.
// - A lane's A fragments are the 16 columns 16 g .. 16 g + 15 (g = lane /
//   4) of its tile at the plane rows of its k slots (4 t .. 4 t + 3 and
//   16 + 4 t .. of a group, t = lane % 4), which are the slots of its B
//   fragment; a 4x4 byte transpose (__byte_perm) turns 4 rows into 4
//   columns of 4 consecutive k.
// - Work: a product's units are (column group, K range) pairs: 8
//   neighbouring column tiles, one a warp, over ks K ranges of whole
//   chunks. A grid of at most one block of 8 warps an SM takes units b,
//   b + grid, ...; the block walks every step of its unit's range.
// - The block's warps copy each step together, every copy a run of 512
//   bytes of one plane row (a step's code rows are 1 KB wide: the block's
//   8 tiles), into a ring of 3 steps in shared memory (120 KB for Q4_0)
//   with cp.async, so 2 steps are in flight while one is read; one block
//   barrier a step hands a stage over. On an H100, copies of 128 bytes a
//   row (each warp its own tile) streamed about a fifth slower, and a
//   ring of 4 steps is slower than 3 (tools/int8_ablation.py, ring_4).
// - The activations of a unit's K range (codes, scales, sums of every
//   row) sit in a shared-memory window: copied from the prologue's output
//   by cp.async ahead of the first ring steps (tl_qmm_int8), or quantized
//   there after them (tl_qmm_int8_inkq), so the loads overlap; it is
//   staged again only when the block's next unit has another K range.
// - Split-K without float atomics: a warp's sums for its tile and K range
//   go to `partial`; the warp that brings the tile's count to ks (a counter
//   a tile, reset by that warp) adds the ks partials in K order, so two
//   runs give the same bits. With ks = 1 the sums go straight to out.

#include "quant_planes.cuh"

namespace {

using namespace tlq;

constexpr int WARPS = 8, NT = 32 * WARPS, TILE_N = 128;
constexpr int RING_MAX = 3;                // ring stages at most
constexpr int SMEM_MAX = 232448;           // a block's shared memory

// ---------------------------------------------------------------- quantize
// One activation group of GA values over L = GA / 4 lanes of one warp (an
// aligned run of L lanes, a float4 each, in element order): returns the
// lane's 4 codes in a word; s and sum (in every lane) are the group's
// scale and f32 sum.
template <int GA>
__device__ __forceinline__ uint32_t quant_lanes(float4 v, float& s, float& sum) {
  constexpr int L = GA / 4;
  float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
  float acc = __fadd_rn(__fadd_rn(__fadd_rn(v.x, v.y), v.z), v.w);
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  }
  float sc = __fmul_rn(amax, 1.0f / 127.0f);
  if (!(sc > 0.f)) sc = 1.0f;
  const float e[4] = {v.x, v.y, v.z, v.w};
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(e[i], sc)), -127.f), 127.f);
    w |= ((uint32_t)(int)q & 0xFFu) << (8 * i);
  }
  s = sc;
  sum = acc;
  return w;
}

// x (M, K) f32 -> qx (M, K) int8, sx / gsum (M, K / GA): thread i takes
// elements 4i .. 4i + 3, the L lanes of a group neighbours in one warp
template <int GA>
__global__ void __launch_bounds__(256)
quantize_acts_kernel(const float* __restrict__ x, int8_t* __restrict__ qx,
                     float* __restrict__ sx, float* __restrict__ gsum,
                     int total) {
  constexpr int L = GA / 4;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < total;
  const float4 v = live ? reinterpret_cast<const float4*>(x)[i]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  float s, sum;
  const uint32_t w = quant_lanes<GA>(v, s, sum);
  if (!live) return;
  reinterpret_cast<uint32_t*>(qx)[i] = w;
  if (i % L == 0) {
    sx[i / L] = s;
    gsum[i / L] = sum;
  }
}

// ---------------------------------------------------------------- layout
// A step: 32 plane rows (Q2_K: 16) x the 1024 columns of a unit's 8 tiles,
// with the scales of its groups. SPC steps a 256-element chunk: Q4_x /
// Q5_x sub u = qs rows 128 c + 32 u .. (groups 8c + u from the low
// nibbles, 8c + u + 4 from the high), Q8_0 sub v = q8 rows 256 c + 32 v ..
// (group 8c + v), Q2_K sub u = q2 rows 64 c + 16 u .. (groups 16c + 4 tc
// + u, crumb tc). A ring stage holds one step: RC code rows of 1024 bytes
// (and Q5_x's 32 qh rows), whose 16-byte pieces are swizzled (piece p of
// row r at p ^ 2 ((r / 4) % 4), so that the 8 lanes of a quarter warp
// that read rows 4t + i, t = 0..3, hit 8 different bank groups); then the
// f32 scales (and mins) of the NG groups, 4096 bytes each (tile w at 512
// w); Q2_K: the scd bytes of its 4 groups (1024 each), then d and dmin
// (fp16, 2048 each).
template <int QT> struct Step {
  static constexpr bool q5 = QT == Q5_0 || QT == Q5_1;
  static constexpr bool k16 = QT == Q2_K;
  static constexpr int SPC = QT == Q8_0 ? 8 : 4;
  static constexpr int RC = k16 ? 16 : 32;               // code rows
  static constexpr int NG = QT == Q8_0 ? 1 : (k16 ? 4 : 2);
  static constexpr bool mins = Fmt<QT>::has_min && !k16;
  static constexpr int O_QH = RC * 1024;
  static constexpr int O_S = O_QH + (q5 ? 32 * 1024 : 0);
  static constexpr int O_M = O_S + NG * 4096;
  static constexpr int BYTES = k16 ? O_S + 8192 : O_M + (mins ? NG * 4096 : 0);
  static constexpr int PIECES = BYTES / 512;             // 512-byte copies
};

// The activation window of a unit's nch chunks: MT rows of codes (row
// stride nch * 256 + 16: a lane's B word then falls in bank 4 row + t),
// then f32 scales and sums, [group][MT]. MT = rows a launch carries.
template <int MT> __host__ __device__ constexpr int win_chunks() {
  return MT == 1 ? 64 : (MT == 8 ? 20 : 10);
}
__host__ __device__ constexpr int win_stride(int nch) { return nch * 256 + 16; }
template <int MT, int GA> __host__ __device__ constexpr int win_bytes(int nch) {
  return MT * win_stride(nch) + 2 * 4 * MT * nch * (256 / GA);
}
template <int QT, int MT> __host__ __device__ constexpr int region_bytes() {
  return (win_bytes<MT, Fmt<QT>::group>(win_chunks<MT>()) + 15) / 16 * 16;
}
// ring stages: as many as the shared memory beside the window holds
template <int QT, int MT> __host__ __device__ constexpr int ring_stages() {
  return (SMEM_MAX - region_bytes<QT, MT>()) / Step<QT>::BYTES > RING_MAX
             ? RING_MAX
             : (SMEM_MAX - region_bytes<QT, MT>()) / Step<QT>::BYTES;
}
template <int QT, int MT> __host__ __device__ constexpr int smem_bytes() {
  return region_bytes<QT, MT>() + ring_stages<QT, MT>() * Step<QT>::BYTES;
}

struct Args {
  const int8_t* qx;            // the prologue's output (tl_qmm_int8)
  const float* sx;
  const float* gsum;
  const float* x;              // f32 activations (tl_qmm_int8_inkq)
  const uint8_t* qa;           // qs / q8 / q2
  const uint8_t* qb;           // qh or null
  const void* sa;              // scales, or Q2_K scd
  const void* sb;              // mins, or Q2_K dm, or null
  float* out;
  float* partial;              // (ks, M, N) when ks > 1
  unsigned int* counters;      // one zeroed word a column tile
  int M, N, K, ks;
};

// A product's units: column group p (tiles 8p .. 8p + 7, one a warp) over
// the chunks [c0, c1) of K range r, u = r * groups + p.
struct Geo {
  int tiles, groups, kch, ks, units;
  __device__ Geo(int N, int K, int ks_)
      : tiles(N / TILE_N), groups((N / TILE_N + WARPS - 1) / WARPS),
        kch(K / 256), ks(ks_), units(groups * ks_) {}
};
struct Unit {
  int tile, r, c0, c1;                 // the warp's tile (>= tiles: none)
  __device__ Unit(int u, const Geo& g, int warp) {
    r = u / g.groups;
    tile = (u - r * g.groups) * WARPS + warp;
    c0 = g.kch * r / g.ks;
    c1 = g.kch * (r + 1) / g.ks;
  }
};

// the block's steps in order: every step of unit blockIdx.x, then of unit
// blockIdx.x + gridDim.x, ...
template <int SPC> struct Walk {
  int u, s, hi, grp;
  __device__ void seek(const Geo& g) {
    if (u >= g.units) return;
    const int r = u / g.groups;
    grp = u - r * g.groups;
    s = SPC * (g.kch * r / g.ks);
    hi = SPC * (g.kch * (r + 1) / g.ks);
  }
  __device__ void next(const Geo& g) {
    if (++s < hi) return;
    u += gridDim.x;
    seek(g);
  }
};

// ---------------------------------------------------------------- copies
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

// the step row (0 .. 31) of a lane's code piece i: k slots 4t .. 4t + 3,
// then 16 + 4t ..; Q2_K (16 rows) only the first four
__device__ __forceinline__ int piece_row(int i, int t) {
  return (i < 4 ? 4 * t : 16 + 4 * t) + (i & 3);
}
__device__ __forceinline__ int swz(int row, int piece) {
  return piece ^ (2 * ((row >> 2) & 3));
}

// The block's share of warp `warp` in step s of column group grp: copies
// k = warp, warp + 8, ... of the step's 512-byte pieces, each a run of one
// plane row (columns past N skipped).
template <int QT>
__device__ __forceinline__ void copy_step(unsigned char* stage, const Args& a,
                                          int grp, int s, int warp, int lane) {
  using S = Step<QT>;
  const size_t N = a.N;
  const int c = s / S::SPC, sub = s - c * S::SPC;
  const int row0 = S::k16 ? 64 * c + 16 * sub
                          : (QT == Q8_0 ? 256 * c + 32 * sub : 128 * c + 32 * sub);
  const int tiles = a.N / TILE_N;
#pragma unroll
  for (int i = 0; i < (S::PIECES + WARPS - 1) / WARPS; ++i) {
    const int k = warp + WARPS * i;
    if (k >= S::PIECES) break;
    if (k < 2 * S::RC || (S::q5 && k < 4 * S::RC)) {
      // a half code (or qh) row: 512 bytes = 4 tiles
      const bool h = k >= 2 * S::RC;
      const int kk = h ? k - 2 * S::RC : k, r = kk >> 1, half = kk & 1;
      const int col = grp * 1024 + 512 * half + 16 * lane;
      if (col < a.N)
        cp_async16(stage + (h ? S::O_QH : 0) + r * 1024 + 16 * swz(r, 32 * half + lane),
                   (h ? a.qb + (size_t)(32 * c + r) * N : a.qa + (size_t)(row0 + r) * N) + col);
    } else if constexpr (S::k16) {
      // scd rows of groups 16c + 4tc + sub (2 pieces each), d, dmin (4 each)
      const int kk = k - 2 * S::RC;
      if (kk < 8) {
        const int tc = kk >> 1, col = grp * 1024 + 512 * (kk & 1) + 16 * lane;
        if (col < a.N)
          cp_async16(stage + S::O_S + 1024 * tc + 512 * (kk & 1) + 16 * lane,
                     (const uint8_t*)a.sa + (size_t)(16 * c + 4 * tc + sub) * N + col);
      } else {
        const int which = (kk - 8) >> 2, q = (kk - 8) & 3;
        const int col = grp * 1024 + 256 * q + 8 * lane;          // fp16 columns
        if (col < a.N)
          cp_async16(stage + S::O_S + 4096 + 2048 * which + 512 * q + 16 * lane,
                     (const unsigned short*)a.sb + (size_t)(8 * c + which) * N + col);
      }
    } else {
      // a tile's f32 scales (then mins) of one group: 512 bytes
      const int kk = k - (S::q5 ? 4 : 2) * S::RC;
      const int m = kk / (8 * S::NG), gi = (kk >> 3) % S::NG, w = kk & 7;
      const int tile = 8 * grp + w;
      if (tile < tiles)
        cp_async16(stage + (m ? S::O_M : S::O_S) + 4096 * gi + 512 * w + 16 * lane,
                   (const float*)(m ? a.sb : a.sa) + (size_t)(8 * c + sub + 4 * gi) * N +
                       tile * TILE_N + 4 * lane);
    }
  }
}

// ---------------------------------------------------------------- math
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// d = A (16 x 32) B (32 x 8), int8 in, exact int32 sums from zero
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}
// d = A (16 x 16) B (16 x 8)
__device__ __forceinline__ void mma_k16(int (&d)[4], uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0), "r"(0), "r"(0), "r"(0));
}

// the scales sw and offsets off = min - zero * sw of a step's groups at
// columns col .. col + 3 of tile w
template <int QT>
__device__ __forceinline__ void load_scales(const unsigned char* st, int w, int col,
                                            float (&sw)[Step<QT>::NG][4],
                                            float (&off)[Step<QT>::NG][4]) {
  using S = Step<QT>;
  if constexpr (S::k16) {
    const uint2 d4 = *reinterpret_cast<const uint2*>(st + S::O_S + 4096 + 256 * w + 2 * col);
    const uint2 m4 = *reinterpret_cast<const uint2*>(st + S::O_S + 6144 + 256 * w + 2 * col);
    const unsigned short* dv = reinterpret_cast<const unsigned short*>(&d4);
    const unsigned short* mv = reinterpret_cast<const unsigned short*>(&m4);
#pragma unroll
    for (int tc = 0; tc < 4; ++tc) {
      const uint32_t b4 =
          *reinterpret_cast<const uint32_t*>(st + S::O_S + 1024 * tc + 128 * w + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int byte = (b4 >> (8 * j)) & 0xFF;
        sw[tc][j] = __fmul_rn((float)(byte & 15), __half2float(__ushort_as_half(dv[j])));
        off[tc][j] = __fmul_rn((float)(byte >> 4), -__half2float(__ushort_as_half(mv[j])));
      }
    }
  } else {
#pragma unroll
    for (int gi = 0; gi < S::NG; ++gi) {
      const int o = 4096 * gi + 512 * w + 4 * col;
      const float4 s4 = *reinterpret_cast<const float4*>(st + S::O_S + o);
      float4 m4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (S::mins) m4 = *reinterpret_cast<const float4*>(st + S::O_M + o);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sw[gi][j] = sv[j];
        off[gi][j] = __fadd_rn(__fmul_rn(-Fmt<QT>::zero, sv[j]), mv[j]);
      }
    }
  }
}

// group gi's codes from the transposed rows T (and Q5's qh rows H)
template <int QT>
__device__ __forceinline__ uint32_t codes(uint32_t T, uint32_t H, int gi, int sub) {
  if constexpr (QT == Q8_0) return T;
  else if constexpr (QT == Q2_K) return (T >> (2 * gi)) & 0x03030303u;
  else {
    uint32_t q = (gi ? T >> 4 : T) & 0x0F0F0F0Fu;
    if constexpr (Step<QT>::q5) q |= ((H >> (sub + 4 * gi)) & 0x01010101u) << 4;
    return q;
  }
}

// A unit's activation window in shared memory (see win_bytes)
struct Win {
  const int8_t* q;
  const float* s;
  const float* gs;
  int stride;
};

// a lane's sums: M = 1, the 4 columns 4 lane ..; else 16 columns 16 g ..
// for rows 2t, 2t + 1 (and 8 + 2t, 9 + 2t)
template <int MT> struct Acc {
  static constexpr int C = MT == 1 ? 4 : 16, R = MT == 1 ? 1 : MT / 4;
};

// acc += this step's products: sub of window chunk cw
template <int QT, int MT>
__device__ __forceinline__ void step_math(const unsigned char* __restrict__ st,
                                          const Win& w, int cw, int sub, int warp,
                                          int lane, float (&acc)[Acc<MT>::C][Acc<MT>::R]) {
  using S = Step<QT>;
  constexpr int NB = MT == 16 ? 2 : 1;              // n8 tiles of rows
  constexpr int NR = Acc<MT>::R;
  constexpr int GA = Fmt<QT>::group;
  const int t = lane & 3, g = lane >> 2;
  constexpr int NQ = S::RC / 4;                     // code pieces a lane
  uint4 P[NQ], H[S::q5 ? 8 : 1];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int r = piece_row(i, t), o = r * 1024 + 16 * swz(r, 8 * warp + g);
    P[i] = *reinterpret_cast<const uint4*>(st + o);
    if constexpr (S::q5) H[i] = *reinterpret_cast<const uint4*>(st + S::O_QH + o);
  }
  // the groups' first elements in the window, B fragments, row scales
  uint32_t b[S::NG][NB][2];
  float sx[S::NG][NR], gs[S::NG][NR];
#pragma unroll
  for (int gi = 0; gi < S::NG; ++gi) {
    const int e = 256 * cw + (QT == Q8_0 ? 32 * sub
                              : (S::k16 ? 64 * gi + 16 * sub : 32 * sub + 128 * gi));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int8_t* p = w.q + (MT == 1 ? 0 : 8 * nb + g) * w.stride + e + 4 * t;
      b[gi][nb][0] = *reinterpret_cast<const uint32_t*>(p);
      b[gi][nb][1] = S::k16 ? 0u : *reinterpret_cast<const uint32_t*>(p + 16);
    }
    const int gl = e / GA;
    if constexpr (MT == 1) {
      sx[gi][0] = w.s[gl];
      gs[gi][0] = w.gs[gl];
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float2 a = *reinterpret_cast<const float2*>(w.s + gl * MT + 8 * nb + 2 * t);
        const float2 c = *reinterpret_cast<const float2*>(w.gs + gl * MT + 8 * nb + 2 * t);
        sx[gi][2 * nb] = a.x;
        sx[gi][2 * nb + 1] = a.y;
        gs[gi][2 * nb] = c.x;
        gs[gi][2 * nb + 1] = c.y;
      }
    }
  }
  int id[S::NG][4];                 // M = 1: the dots of the lane's columns
#pragma unroll
  for (int gi = 0; gi < S::NG; ++gi)
#pragma unroll
    for (int i = 0; i < 4; ++i) id[gi][i] = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {     // word q: columns 4q .. 4q + 3 of 16 g ..
    uint32_t T[2][4], TH[2][4] = {};
#pragma unroll
    for (int h = 0; h < (S::k16 ? 1 : 2); ++h) {
      const uint32_t r[4] = {word(P[4 * h], q), word(P[4 * h + 1], q),
                             word(P[4 * h + 2], q), word(P[4 * h + 3], q)};
      transpose4(r, T[h]);
      if constexpr (S::q5) {
        const uint32_t rh[4] = {word(H[4 * h], q), word(H[4 * h + 1], q),
                                word(H[4 * h + 2], q), word(H[4 * h + 3], q)};
        transpose4(rh, TH[h]);
      }
    }
    float sw[S::NG][4], off[S::NG][4];
    if constexpr (MT != 1) load_scales<QT>(st, warp, 16 * g + 4 * q, sw, off);
#pragma unroll
    for (int gi = 0; gi < S::NG; ++gi) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        // m16 tile j = 2q + jj: row g is column 4q + 2jj, row g + 8 the next
        const int c0 = 2 * jj, c1 = 2 * jj + 1;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          int d[4];
          if constexpr (S::k16) {
            mma_k16(d, codes<QT>(T[0][c0], 0u, gi, sub), codes<QT>(T[0][c1], 0u, gi, sub),
                    b[gi][nb][0]);
          } else {
            const uint32_t a[4] = {codes<QT>(T[0][c0], TH[0][c0], gi, sub),
                                   codes<QT>(T[0][c1], TH[0][c1], gi, sub),
                                   codes<QT>(T[1][c0], TH[1][c0], gi, sub),
                                   codes<QT>(T[1][c1], TH[1][c1], gi, sub)};
            mma_k32(d, a, b[gi][nb][0], b[gi][nb][1]);
          }
          if constexpr (MT == 1) {
            if (q == t) {
              id[gi][c0] = d[0];
              id[gi][c1] = d[2];
            }
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int cc = k >> 1, mm = k & 1, col = 4 * q + 2 * jj + cc;
              const int rv = 2 * nb + mm;
              float& v = acc[col][rv];
              v = fmaf(__fmul_rn((float)d[k], sw[gi][c0 + cc]), sx[gi][rv], v);
              if constexpr (Fmt<QT>::corr) v = fmaf(gs[gi][rv], off[gi][c0 + cc], v);
            }
          }
        }
      }
    }
  }
  if constexpr (MT == 1) {
    float sw[S::NG][4], off[S::NG][4];
    load_scales<QT>(st, warp, 4 * lane, sw, off);
#pragma unroll
    for (int gi = 0; gi < S::NG; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float& v = acc[i][0];
        v = fmaf(__fmul_rn((float)id[gi][i], sw[gi][i]), sx[gi][0], v);
        if constexpr (Fmt<QT>::corr) v = fmaf(gs[gi][0], off[gi][i], v);
      }
  }
}

// ---------------------------------------------------------------- window
// All threads: x of chunks [c0, c1) of every row quantized by quant_lanes
// into the window (tl_qmm_int8_inkq); rows past M hold zeros. Barriers on
// both sides.
template <int QT, int MT>
__device__ __forceinline__ Win stage_quant(unsigned char* win, const Args& a,
                                           int c0, int c1) {
  constexpr int GA = Fmt<QT>::group, L = GA / 4;
  const int nch = c1 - c0, xs = win_stride(nch), gw = nch * (256 / GA);
  int8_t* q = reinterpret_cast<int8_t*>(win);
  float* s = reinterpret_cast<float*>(win + MT * xs);
  float* gs = s + gw * MT;
  __syncthreads();                     // the window's last readers are done
  const int total = MT * gw * L;
  for (int base = 0; base < total; base += NT) {
    const int i = base + threadIdx.x;
    const int grp = i / L, li = i - grp * L;
    const int m = grp / gw, gl = grp - m * gw;
    const bool live = i < total && m < a.M;
    const float4 v = live
        ? *reinterpret_cast<const float4*>(a.x + (size_t)m * a.K + 256 * c0 + GA * gl + 4 * li)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    float sc, sum;
    const uint32_t code = quant_lanes<GA>(v, sc, sum);
    if (i < total) {
      *reinterpret_cast<uint32_t*>(q + m * xs + GA * gl + 4 * li) = code;
      if (li == 0) {
        s[gl * MT + m] = live ? sc : 0.f;
        gs[gl * MT + m] = live ? sum : 0.f;
      }
    }
  }
  __syncthreads();
  return Win{q, s, gs, xs};
}

// The window of the two-launch path (tl_qmm_int8): the prologue's codes,
// scales and sums of chunks [c0, c1) copied by cp.async as one commit
// group; rows past M stored as zeros. The block's first window is
// requested before the ring's first steps, so these L2 reads do not queue
// behind the planes, and the streaming loop's first barrier publishes it.
template <int QT, int MT>
__device__ __forceinline__ Win stage_async(unsigned char* win, const Args& a,
                                           int c0, int c1) {
  constexpr int GA = Fmt<QT>::group;
  const int nch = c1 - c0, xs = win_stride(nch), gw = nch * (256 / GA);
  int8_t* q = reinterpret_cast<int8_t*>(win);
  float* s = reinterpret_cast<float*>(win + MT * xs);
  float* gs = s + gw * MT;
  const int v16 = nch * 16;
  for (int i = threadIdx.x; i < MT * v16; i += NT) {
    const int m = i / v16, v = i - m * v16;
    uint4* dst = reinterpret_cast<uint4*>(q + m * xs) + v;
    if (m < a.M)
      cp_async16(dst, reinterpret_cast<const uint4*>(a.qx + (size_t)m * a.K + 256 * c0) + v);
    else
      *dst = make_uint4(0u, 0u, 0u, 0u);
  }
  const int G = a.K / GA, g0 = c0 * (256 / GA);
  for (int i = threadIdx.x; i < MT * gw; i += NT) {
    const int m = i / gw, gl = i - m * gw;
    if (m < a.M) {
      cp_async_small<4>(s + gl * MT + m, a.sx + (size_t)m * G + g0 + gl);
      cp_async_small<4>(gs + gl * MT + m, a.gsum + (size_t)m * G + g0 + gl);
    } else {
      s[gl * MT + m] = 0.f;
      gs[gl * MT + m] = 0.f;
    }
  }
  cp_async_commit();
  return Win{q, s, gs, xs};
}

// ---------------------------------------------------------------- sums
// the lane's sums into dst (rows past M skipped); acc zeroed
template <int MT>
__device__ __forceinline__ void put(float (&acc)[Acc<MT>::C][Acc<MT>::R],
                                    float* __restrict__ dst, const Args& a,
                                    int tile, int lane) {
  const int t = lane & 3, g = lane >> 2;
  if constexpr (MT == 1) {
    reinterpret_cast<float4*>(dst + tile * TILE_N)[lane] =
        make_float4(acc[0][0], acc[1][0], acc[2][0], acc[3][0]);
  } else {
#pragma unroll
    for (int rv = 0; rv < Acc<MT>::R; ++rv) {
      const int m = 8 * (rv >> 1) + 2 * t + (rv & 1);
      if (m >= a.M) continue;
      float* p = dst + (size_t)m * a.N + tile * TILE_N + 16 * g;
#pragma unroll
      for (int c = 0; c < 16; c += 4)
        *reinterpret_cast<float4*>(p + c) =
            make_float4(acc[c][rv], acc[c + 1][rv], acc[c + 2][rv], acc[c + 3][rv]);
    }
  }
#pragma unroll
  for (int c = 0; c < Acc<MT>::C; ++c)
#pragma unroll
    for (int rv = 0; rv < Acc<MT>::R; ++rv) acc[c][rv] = 0.f;
}

// The warp that brings a tile's count to ks adds the tile's ks partials
// in K order into out, each lane its own sums, and zeroes the count.
template <int MT>
__device__ __forceinline__ void combine_tile(const Args& a, int tile, int lane) {
  __syncwarp();                        // the lanes' partials are stored
  unsigned int old = 0;
  if (lane == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    old = atomicAdd(&a.counters[tile], 1u);
    if (old == (unsigned int)(a.ks - 1)) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  old = __shfl_sync(0xffffffffu, old, 0);
  if (old != (unsigned int)(a.ks - 1)) return;
  // the lane's NV float4s of each partial: loaded B partials at a time,
  // all in flight together, then added in K order
  constexpr int NV = MT == 1 ? 1 : 4 * Acc<MT>::R, B = MT == 1 ? 16 : (MT == 8 ? 2 : 1);
  const int t = lane & 3, g = lane >> 2;
  const size_t MN = (size_t)a.M * a.N;
  size_t o[NV];
  bool live[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int rv = v >> 2, m = MT == 1 ? 0 : 8 * (rv >> 1) + 2 * t + (rv & 1);
    live[v] = m < a.M;
    o[v] = MT == 1 ? (size_t)tile * TILE_N + 4 * lane
                   : (size_t)m * a.N + tile * TILE_N + 16 * g + 4 * (v & 3);
  }
  float4 sum[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < a.ks; r0 += B) {
    float4 p[B][NV];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        p[b][v] = r0 + b < a.ks && live[v]
            ? __ldcg(reinterpret_cast<const float4*>(a.partial + (r0 + b) * MN + o[v]))
            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (r0 + b < a.ks) {
          sum[v].x += p[b][v].x;
          sum[v].y += p[b][v].y;
          sum[v].z += p[b][v].z;
          sum[v].w += p[b][v].w;
        }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v)
    if (live[v]) *reinterpret_cast<float4*>(a.out + o[v]) = sum[v];
  __syncwarp();
  if (lane == 0) a.counters[tile] = 0u;
}

// ---------------------------------------------------------------- gemv
template <int QT, int MT, bool INKQ>
__global__ void __launch_bounds__(NT, 1) qmm_int8_kernel(const Args a) {
  using S = Step<QT>;
  constexpr int R = ring_stages<QT, MT>();
  static_assert(R >= 2, "a ring of two steps at least");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Geo geo(a.N, a.K, a.ks);
  unsigned char* ring = smem + region_bytes<QT, MT>();
  Win w{};
  int wc0 = -1, wc1 = -1;                       // the window's chunks
  if constexpr (!INKQ) {
    const Unit un(blockIdx.x, geo, warp);       // the block's first unit
    w = stage_async<QT, MT>(smem, a, un.c0, un.c1);
    wc0 = un.c0;
    wc1 = un.c1;
  }
  Walk<S::SPC> ahead{(int)blockIdx.x, 0, 0, 0};
  ahead.seek(geo);
#pragma unroll
  for (int k = 0; k < R - 1; ++k) {          // the first R - 1 steps
    if (ahead.u < geo.units) {
      copy_step<QT>(ring + k * S::BYTES, a, ahead.grp, ahead.s, warp, lane);
      ahead.next(geo);
    }
    cp_async_commit();
  }
  float acc[Acc<MT>::C][Acc<MT>::R] = {};
  int j = 0;                                    // steps so far
  for (int u = blockIdx.x; u < geo.units; u += gridDim.x) {
    const Unit un(u, geo, warp);
    if (un.c0 != wc0 || un.c1 != wc1) {         // a block-wide condition
      if constexpr (INKQ) {
        w = stage_quant<QT, MT>(smem, a, un.c0, un.c1);
      } else {                                  // another K range: rare
        __syncthreads();
        w = stage_async<QT, MT>(smem, a, un.c0, un.c1);
        cp_async_wait<0>();
        __syncthreads();
      }
      wc0 = un.c0;
      wc1 = un.c1;
    }
    const bool mine = un.tile < geo.tiles;      // this warp has a tile
    for (int s = S::SPC * un.c0; s < S::SPC * un.c1; ++s, ++j) {
      cp_async_wait<R - 2>();                // this thread's part of step j
                                                // (and of a first window)
      __syncthreads();                          // all of it; step j - 1 is read
      if (ahead.u < geo.units) {
        copy_step<QT>(ring + ((j + R - 1) % R) * S::BYTES, a, ahead.grp,
                      ahead.s, warp, lane);
        ahead.next(geo);
      }
      cp_async_commit();
      const int c = s / S::SPC;
      if (mine)
        step_math<QT, MT>(ring + (j % R) * S::BYTES, w, c - un.c0, s - c * S::SPC,
                          warp, lane, acc);
    }
    if (!mine) continue;
    put<MT>(acc, a.ks == 1 ? a.out : a.partial + (size_t)un.r * a.M * a.N, a,
            un.tile, lane);
    if (a.ks > 1) combine_tile<MT>(a, un.tile, lane);
  }
  cp_async_wait<0>();                           // no copy outlives the block
}

template <int QT, int MT, bool INKQ>
int launch_gemv(const Args& a, int grid, cudaStream_t st) {
  constexpr int SMEM = smem_bytes<QT, MT>();
  static_assert(SMEM <= SMEM_MAX, "shared memory of one block");
  const cudaError_t e = cudaFuncSetAttribute(
      qmm_int8_kernel<QT, MT, INKQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  qmm_int8_kernel<QT, MT, INKQ><<<grid, NT, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <int QT, bool INKQ>
int launch_fmt(const Args& a, int grid, cudaStream_t st) {
  const int kch = a.K / 256, span = (kch + a.ks - 1) / a.ks;
  if (a.M == 1) {
    if (span > win_chunks<1>()) return (int)cudaErrorInvalidValue;
    return launch_gemv<QT, 1, INKQ>(a, grid, st);
  }
  if (a.M <= 8) {
    if (span > win_chunks<8>()) return (int)cudaErrorInvalidValue;
    return launch_gemv<QT, 8, INKQ>(a, grid, st);
  }
  if (span > win_chunks<16>()) return (int)cudaErrorInvalidValue;
  return launch_gemv<QT, 16, INKQ>(a, grid, st);
}

template <bool INKQ>
int launch_qtype(int qtype, const Args& a, int grid, void* stream) {
  if (a.M <= 0 || a.M > 16 || a.N <= 0 || a.N % TILE_N != 0 || a.K <= 0 ||
      a.K % 256 != 0 || a.ks < 1 || a.ks > a.K / 256 || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (qtype) {
    case Q4_0: return launch_fmt<Q4_0, INKQ>(a, grid, st);
    case Q4_1: return launch_fmt<Q4_1, INKQ>(a, grid, st);
    case Q5_0: return launch_fmt<Q5_0, INKQ>(a, grid, st);
    case Q5_1: return launch_fmt<Q5_1, INKQ>(a, grid, st);
    case Q8_0: return launch_fmt<Q8_0, INKQ>(a, grid, st);
    case Q2_K: return launch_fmt<Q2_K, INKQ>(a, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch 1: x (M, K) f32 -> qx (M, K) int8, sx / gsum (M, K / group) f32.
extern "C" int tl_quantize_acts(const void* x, void* qx, void* sx, void* gsum,
                                int M, int K, int group, void* stream) {
  if (M <= 0 || K <= 0 || K % 256 != 0) return (int)cudaErrorInvalidValue;
  const int total = M * (K / 4);
  const int threads = 256, blocks = (total + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (group == 32)
    quantize_acts_kernel<32><<<blocks, threads, 0, st>>>(
        (const float*)x, (int8_t*)qx, (float*)sx, (float*)gsum, total);
  else if (group == 16)
    quantize_acts_kernel<16><<<blocks, threads, 0, st>>>(
        (const float*)x, (int8_t*)qx, (float*)sx, (float*)gsum, total);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Launch 2: the gemv. Planes as in qmm.cu (qa: qs / q8 / q2; qb: qh or
// null; sa: scales or Q2_K scd; sb: mins or Q2_K dm or null), each
// 16-byte aligned. ks: K ranges a column tile (whole chunks, at most
// win_chunks<MT> each); grid: blocks (<= one an SM). partial: (ks, M, N)
// f32 scratch, used when ks > 1; counters: N / 128 zeroed uint32, left
// zeroed on return.
extern "C" int tl_qmm_int8(int qtype, const void* qx, const void* sx,
                           const void* gsum, const void* qa, const void* qb,
                           const void* sa, const void* sb, void* out,
                           void* partial, void* counters, int M, int N, int K,
                           int ks, int grid, void* stream) {
  const Args a{(const int8_t*)qx, (const float*)sx, (const float*)gsum, nullptr,
               (const uint8_t*)qa, (const uint8_t*)qb, sa, sb, (float*)out,
               (float*)partial, (unsigned int*)counters, M, N, K, ks};
  return launch_qtype<false>(qtype, a, grid, stream);
}

// The gemv alone, quantizing x (M, K) f32 (16-byte aligned) inside the
// launch; the other arguments as for tl_qmm_int8. Gives tl_quantize_acts
// + tl_qmm_int8's output bit for bit.
extern "C" int tl_qmm_int8_inkq(int qtype, const void* x, const void* qa,
                                const void* qb, const void* sa, const void* sb,
                                void* out, void* partial, void* counters,
                                int M, int N, int K, int ks, int grid,
                                void* stream) {
  const Args a{nullptr, nullptr, nullptr, (const float*)x, (const uint8_t*)qa,
               (const uint8_t*)qb, sa, sb, (float*)out, (float*)partial,
               (unsigned int*)counters, M, N, K, ks};
  return launch_qtype<true>(qtype, a, grid, stream);
}
