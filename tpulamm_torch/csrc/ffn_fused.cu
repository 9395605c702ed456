// ffn_fused.cu -- the gated FFN of a few rows in one launch:
//
//   out (M, dim) f32 = (act(x Wg) * (x Wu)) Wd,   M <= 16
//
// Replaces tpulamm/ops/pallas_ffn.py::ffn_fused / _ffn_call, the TPU
// kernel that keeps the (M, ffn) intermediate on chip. Wg | Wu is the
// fused (2 ffn, dim) mm QTensor (gate columns first) and Wd the (dim, ffn)
// one, each in any of the six formats; act is silu, gelu (tanh) or relu.
//
// Numerics: f32-grade, as the JAX kernel keeps x, the sums and `mid` in
// f32. The products run on the bf16 tensor cores (mma.sync m16n8k16, f32
// sums): x, and then mid, go in as two bf16 halves hi = bf16(v) and lo =
// bf16(v - hi), which carry 16 bits of each value; the weights go in as
// their integer codes minus the zero point, exact in bf16 (gemv_tc.cuh's
// byte permute + lop3); each 32-element group's dot (16 for Q2_K) comes
// out in f32 and is multiplied by its f32 group scale, and a format with
// mins adds min * (the f32 sum of x over the group). So the result differs
// from the plain version (f32 dequantized weights) by the ~2^-17 of each
// value that lo drops and by the order of f32 sums: rel ~1e-6.
//
// What bounds it on an H100: the plane bytes of the three matrices, read
// once (LLaMA-7B Q4_0: 84.5 MB, 25 us at 3.35 TB/s); the operations,
// 2 x 6 M dim ffn on the tensor cores, are below that at every M <= 16.
//
// Design for that bound.
// - One cooperative launch, one block of 8 warps an SM (every block
//   resident, so gemv_stage.cuh's grid_sync cannot deadlock): phase A's
//   products (gate
//   | up), a grid barrier, the combine of phase A's split sums into gu, a
//   barrier, phase B's products (down, over mid = act(gate) * up, made
//   from gu as each block stages it), a barrier, the combine into out.
// - The tensor core with A and B swapped, as in gemv_tc.cuh: 16 weight
//   columns fill A's rows, K is the mma's k16, and B's 8 columns hold the
//   hi and lo halves of 4 rows of x (column 2r + h), so M <= 4 rows take
//   one n8 tile, M <= 8 two, M <= 16 four. Every plane byte is read once
//   whatever M is. A lane (g, t) ends with the dots of its 16 columns for
//   row t of each n8 tile; at M = 1 x fills all four row slots and the lane
//   keeps the 4 columns 4t .. of its 16.
// - A block step: 32 plane rows (Q2_K: 16) of a group of 1024
//   neighbouring columns (phase A's are the 2 ffn gate | up columns), with
//   the f32 scales (and mins) of its K groups. The group's part of each
//   plane row is one bulk copy (cp.async.bulk) into a ring of up to 3 steps
//   in shared memory, counted on the stage's mbarrier, so 2 steps are in
//   flight while one is read and no thread tracks a copy. Warp w takes the
//   group's columns 128 w .. 128 w + 127.
// - x (and mid) sit as bf16 hi / lo rows in a shared-memory window of the
//   chunks the block's steps read, staged once a phase, after the ring's
//   first requests.
// - Work: a phase's (column group, chunk, step) positions, group first,
//   cut into equal ranges, one a block, so every block streams the same
//   bytes; K past a window's chunks is cut into windows, each taken by its
//   own blocks (the split, ops/ffn_fused.py::ffn_plan). Phase B's first
//   steps are requested before the grid barrier.
// - Split-K without float atomics: where a block's range leaves a column
//   group, its warps put their sums into the block's slot of `partial`;
//   after the barrier every thread of the grid adds the slots of a few
//   outputs in a fixed order. Two runs give the same bits; the barrier's
//   words are left zeroed.

#include "gemv_tc.cuh"

namespace {

using namespace tlg;
using tlt::bsub2;
using tlt::pair_bytes;

constexpr int GC = 1024;                   // columns of a group
constexpr int RING_MAX = 3;                // ring stages at most
constexpr int SMEM_MAX = 232448;           // a block's shared memory
constexpr int SMEM_DYN = SMEM_MAX - 1024;  // of it, the dynamic part

// ---------------------------------------------------------------- layout
// A step: RC plane rows of a group's 1024 columns (its local columns).
// SPC steps a 256-element chunk: Q4_x / Q5_x sub u = qs rows 128 c + 32 u
// .. (group 8c + u in the low nibbles, 8c + u + 4 in the high ones; Q5_x
// also the chunk's 32 qh rows, bits u and u + 4), Q8_0 sub v = q8 rows
// 256 c + 32 v .. (group 8c + v), Q2_K sub u = q2 rows 64 c + 16 u ..
// (group 16c + 4 tc + u in crumb tc). A ring stage: the code rows, ROWB bytes apart (1024 and 16 of padding, so
// that the 8 lanes of a quarter warp, which read rows 2t + b at 16-byte
// pieces g, hit 8 bank groups), Q5_x's qh rows alike, then the f32 scales
// of the NG groups (4096 bytes each, local column order), then the mins;
// Q2_K: the scd bytes of its 4 groups (1024 each), then d and dmin (fp16,
// 2048 each).
constexpr int ROWB = 1040;
template <int QT> struct Step {
  static constexpr bool q5 = QT == Q5_0 || QT == Q5_1;
  static constexpr bool k16 = QT == Q2_K;
  static constexpr int SPC = QT == Q8_0 ? 8 : 4;
  static constexpr int RC = k16 ? 16 : 32;
  static constexpr int NG = QT == Q8_0 ? 1 : (k16 ? 4 : 2);
  static constexpr bool mins = Fmt<QT>::has_min && !k16;
  static constexpr int O_QH = RC * ROWB;
  static constexpr int O_S = O_QH + (q5 ? 32 * ROWB : 0);
  static constexpr int O_M = O_S + NG * 4096;
  static constexpr int BYTES = k16 ? O_S + 8192 : O_M + (mins ? NG * 4096 : 0);
  static constexpr int ROWS = RC + (q5 ? 32 : 0);   // code and qh rows
};

// The window of a row class MT (1, 4, 8 or 16 rows a launch): the bf16 hi
// and lo rows of x (2 rows at MT = 1, as every row slot of B repeats row
// 0; else hi of row m at 2m, lo at 2m + 1), row stride nch * 512 + 16
// bytes (a lane's B word then falls in bank 4 g + t), then the f32 sums
// of x over each group of a format with mins, [group][MT].
template <int MT> __host__ __device__ constexpr int win_rows() {
  return MT == 1 ? 2 : 2 * MT;
}
__host__ __device__ constexpr int win_stride(int nch) { return nch * 512 + 16; }
template <int MT> __host__ __device__ constexpr int win_bytes_x(int nch) {
  return (win_rows<MT>() * win_stride(nch) + nch * 16 * MT * 4 + 15) / 16 * 16;
}
// the most chunks (at most XCH_MAX) a window holds beside r ring steps
constexpr int XCH_MAX = 64;
template <int QT, int MT> __host__ __device__ constexpr int fit(int r) {
  int x = XCH_MAX;
  while (x > 0 && win_bytes_x<MT>(x) + r * Step<QT>::BYTES > SMEM_DYN) --x;
  return x;
}
// a window's chunks (the split, ffn_plan, keeps every block's range within
// them): beside a ring of 3 steps, or of 2 where 3 leave fewer than 4
template <int QT, int MT> __host__ __device__ constexpr int xch() {
  return fit<QT, MT>(3) >= 4 ? fit<QT, MT>(3) : fit<QT, MT>(2);
}
template <int QT, int MT> __host__ __device__ constexpr int win_bytes() {
  return win_bytes_x<MT>(xch<QT, MT>());
}
template <int QT, int MT> __host__ __device__ constexpr int ring_stages() {
  return (SMEM_DYN - win_bytes<QT, MT>()) / Step<QT>::BYTES > RING_MAX
             ? RING_MAX
             : (SMEM_DYN - win_bytes<QT, MT>()) / Step<QT>::BYTES;
}
template <int QT, int MT> __host__ __device__ constexpr int smem_bytes() {
  return win_bytes<QT, MT>() + ring_stages<QT, MT>() * Step<QT>::BYTES;
}
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// the launch's shared memory: enough for either phase in any format
template <int MT> constexpr int smem_launch() {
  return cmax(cmax(cmax(smem_bytes<Q4_0, MT>(), smem_bytes<Q4_1, MT>()),
                   cmax(smem_bytes<Q5_0, MT>(), smem_bytes<Q5_1, MT>())),
              cmax(smem_bytes<Q8_0, MT>(), smem_bytes<Q2_K, MT>()));
}
static_assert(smem_launch<1>() <= SMEM_DYN && smem_launch<4>() <= SMEM_DYN &&
                  smem_launch<8>() <= SMEM_DYN && smem_launch<16>() <= SMEM_DYN,
              "shared memory of one block");
static_assert(ring_stages<Q5_1, 16>() >= 2 && xch<Q5_1, 16>() >= 3,
              "a ring of two steps and a window of three chunks at least");

// ---------------------------------------------------------------- args
// One product of a phase: its planes, its columns N (the plane row
// length; group p is columns [1024 p, 1024 p + 1024) of them), its
// groups, K chunks and windows.
struct Geo {
  const uint8_t* qa;    // qs / q8 / q2
  const uint8_t* qb;    // qh or null
  const void* sa;       // scales, or Q2_K scd
  const void* sb;       // mins, or Q2_K dm, or null
  int N, groups, kch, nwin;
};

struct FfnArgs {
  Geo ga, gb;            // phase A (gate | up), phase B (down)
  const float* x;        // (M, dim)
  float* gu;             // (M, 2 ffn) scratch: x Wg | x Wu
  float* out;            // (M, dim)
  float* partial;        // (slots, M, 1024) scratch
  unsigned int* bar;     // grid_sync's 2 words, zeroed
  int qt_gu, qt_dn, M, dim, ffn, act;
};

// A phase's window v: chunks [c0, c1) taken by blocks [b0, b1); its
// positions (group, chunk, step), group first, cut into nbk equal ranges
// (nbk <= the positions, so that no range is empty).
struct Win {
  int v, c0, c1, b0, b1, line, len, nbk;
  __device__ Win(const Geo& g, int spc, int v_ = -1) {
    const int B = gridDim.x;
    v = v_ >= 0 ? v_ : (((int)blockIdx.x + 1) * g.nwin - 1) / B;
    c0 = g.kch * v / g.nwin;
    c1 = g.kch * (v + 1) / g.nwin;
    b0 = B * v / g.nwin;
    b1 = B * (v + 1) / g.nwin;
    line = spc * (c1 - c0);
    len = g.groups * line;
    nbk = b1 - b0 < len ? b1 - b0 : len;
  }
  // the first position of the window's block i (i <= nbk)
  __device__ int start(int i) const { return (int)((long long)len * i / nbk); }
  // the block that holds position pos
  __device__ int block_at(int pos) const {
    return (int)(((long long)(pos + 1) * nbk + len - 1) / len) - 1;
  }
  // the slot of the sums of block i for group p: blocks of the grid plus
  // groups of every window, so no two (block, group) share one
  __device__ int slot(int i, int p, int groups) const {
    return b0 + i + v * groups + p;
  }
};

// a position of a window as (group, chunk, step)
struct Cursor {
  int p, c, s;
  __device__ void seek(const Win& w, int spc, int pos) {
    p = pos / w.line;
    const int r = pos - p * w.line;
    c = w.c0 + r / spc;
    s = r - (r / spc) * spc;
  }
  __device__ void next(const Win& w, int spc) {
    if (++s < spc) return;
    s = 0;
    if (++c < w.c1) return;
    c = w.c0;
    ++p;
  }
};

// ---------------------------------------------------------------- copies
// A step reaches shared memory as one bulk copy (cp.async.bulk, the copy
// engine) a run of a plane row, counted on its stage's mbarrier, which
// thread 0 arms with the step's bytes before a block barrier after which
// the copies are issued.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" :: "r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile("{\n .reg .pred P1;\n LAB_WAIT:\n"
               " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
               " @P1 bra DONE;\n bra LAB_WAIT;\n DONE:\n}\n"
               :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// Run k of a step: where it goes in the stage, where it comes from, and
// its bytes (fewer where the group's columns end).
struct Run {
  int dst;              // offset in the stage
  const uint8_t* src;   // first byte
  int bytes;
};

// the runs of a step: the code rows (and qh rows), then the scales' rows
// (Q2_K: scd of 4 groups, d and dmin; else f32 scales and mins), each the
// group's columns of one plane row
template <int QT> __host__ __device__ constexpr int runs() {
  using S = Step<QT>;
  return S::ROWS + (S::k16 ? 6 : S::NG * (S::mins ? 2 : 1));
}

// the columns of group p: 1024, or fewer in the last group
__device__ __forceinline__ int group_cols(const Geo& g, int p) {
  return g.N - GC * p < GC ? g.N - GC * p : GC;
}

template <int QT>
__device__ __forceinline__ Run run_of(const Geo& g, const Cursor& u, int k) {
  using S = Step<QT>;
  const size_t N = g.N;
  const int c = u.c, s = u.s, col = GC * u.p, n = group_cols(g, u.p);
  const int row0 = S::k16 ? 64 * c + 16 * s
                          : (QT == Q8_0 ? 256 * c + 32 * s : 128 * c + 32 * s);
  if (k < S::ROWS) {
    const bool h = k >= S::RC;
    const int r = h ? k - S::RC : k;
    return Run{(h ? S::O_QH : 0) + r * ROWB,
               (h ? g.qb + (size_t)(32 * c + r) * N : g.qa + (size_t)(row0 + r) * N) + col,
               n};
  }
  const int kk = k - S::ROWS;
  if constexpr (S::k16) {
    if (kk < 4)                          // scd of group 16c + 4 kk + s
      return Run{S::O_S + 1024 * kk,
                 (const uint8_t*)g.sa + (size_t)(16 * c + 4 * kk + s) * N + col, n};
    const int which = kk - 4;            // d, dmin
    return Run{S::O_S + 4096 + 2048 * which,
               (const uint8_t*)g.sb + 2 * ((size_t)(8 * c + which) * N + col), 2 * n};
  } else {
    const int m = kk / S::NG, gi = kk % S::NG;
    const int grp = 8 * c + s + 4 * gi;
    return Run{(m ? S::O_M : S::O_S) + 4096 * gi,
               (const uint8_t*)(m ? g.sb : g.sa) + 4 * ((size_t)grp * N + col), 4 * n};
  }
}

// the bytes of step u: each plane's bytes a column, times the group's
// columns
template <int QT>
__device__ __forceinline__ uint32_t step_bytes(const Geo& g, const Cursor& u) {
  using S = Step<QT>;
  constexpr int per_col = S::ROWS + (S::k16 ? 8 : 4 * S::NG * (S::mins ? 2 : 1));
  return per_col * group_cols(g, u.p);
}

// thread 0: arm the stage's mbarrier for step u
template <int QT>
__device__ __forceinline__ void arm_step(uint64_t* bar, const Geo& g, const Cursor& u) {
  if (threadIdx.x == 0) mbar_expect(bar, step_bytes<QT>(g, u));
}

// every thread: its run of step u (run k: warp k % 8, lane k / 8) into a
// ring stage
template <int QT>
__device__ __forceinline__ void copy_step(unsigned char* stage, uint64_t* bar,
                                          const Geo& g, const Cursor& u) {
  static_assert(runs<QT>() <= NT, "a run a thread");
  const int k = WARPS * (threadIdx.x & 31) + (threadIdx.x >> 5);
  if (k < runs<QT>()) {
    const Run r = run_of<QT>(g, u, k);
    if (r.bytes) bulk_copy(stage + r.dst, r.src, r.bytes, bar);
  }
}

// ---------------------------------------------------------------- math
// d += A (16 x 16) B (16 x 8), bf16 in, f32 sums
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of m16 tile j for group gi (Q4_x / Q5_x: the low or high
// nibbles; Q2_K: crumb gi) from the code rows 2t, 2t+1, 2t+8, 2t+9 of a
// k16 half (q) and Q5's qh rows alike (h; bit sub + 4 gi): the codes minus
// the zero point as bf16 (gemv_tc.cuh::step_math)
template <int QT>
__device__ __forceinline__ void frag(const uint4* q, const uint4* h, int j, int gi,
                                     int sub, uint32_t (&a)[4]) {
  constexpr uint32_t M4 = 0x000F000Fu, M2 = 0x00030003u, BF = 0x43004300u;
  const uint32_t p01 = pair_bytes(q[0], q[1], j);
  const uint32_t p89 = pair_bytes(q[2], q[3], j);
  if constexpr (QT == Q8_0) {
    const uint32_t ps[4] = {p01, p01 >> 8, p89, p89 >> 8};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = bsub2((ps[i] & 0x007F007Fu) | BF, (ps[i] & 0x00800080u) | BF);
  } else if constexpr (QT == Q2_K) {
    const uint32_t ps[4] = {p01 >> (2 * gi), p01 >> (8 + 2 * gi), p89 >> (2 * gi),
                            p89 >> (8 + 2 * gi)};
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = bsub2((ps[i] & M2) | BF, BF);
  } else {
    constexpr bool q5 = QT == Q5_0 || QT == Q5_1;
    const uint32_t bias = QT == Q4_0 ? 0x43084308u                   // 136
                        : (QT == Q5_0 ? 0x43104310u : 0x43004300u);  // 144, 128
    const uint32_t ps[4] = {p01 >> (4 * gi), p01 >> (8 + 4 * gi), p89 >> (4 * gi),
                            p89 >> (8 + 4 * gi)};
    uint32_t hb[4] = {0u, 0u, 0u, 0u};
    if constexpr (q5) {
      // bit sub (+ 4) of byte 0 / 2 (column 2j) or 1 / 3 (2j + 1) to bit
      // 4 of its bf16 half
      const uint32_t h01 = pair_bytes(h[0], h[1], j);
      const uint32_t h89 = pair_bytes(h[2], h[3], j);
      if (gi) {
        hb[0] = h01 >> sub;
        hb[1] = h01 >> (8 + sub);
        hb[2] = h89 >> sub;
        hb[3] = h89 >> (8 + sub);
      } else {
        hb[0] = h01 << (4 - sub);
        hb[1] = h01 >> (4 + sub);
        hb[2] = h89 << (4 - sub);
        hb[3] = h89 >> (4 + sub);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = bsub2((ps[i] & M4) | (hb[i] & 0x00100010u) | BF, bias);
  }
}

// the first element of group gi of step sub, relative to its chunk
template <int QT>
__device__ __forceinline__ int group_elem(int gi, int sub) {
  if constexpr (QT == Q8_0) return 32 * sub;
  else if constexpr (QT == Q2_K) return 64 * gi + 16 * sub;
  else return 32 * sub + 128 * gi;
}

// the scales and mins of group gi at local columns col, col + 1
template <int QT>
__device__ __forceinline__ void scales2(const unsigned char* st, int gi, int col,
                                        float (&s)[2], float (&mn)[2]) {
  using S = Step<QT>;
  if constexpr (S::k16) {
    const unsigned short b2 =
        *reinterpret_cast<const unsigned short*>(st + S::O_S + 1024 * gi + col);
    const uint32_t d2 = *reinterpret_cast<const uint32_t*>(st + S::O_S + 4096 + 2 * col);
    const uint32_t m2 = *reinterpret_cast<const uint32_t*>(st + S::O_S + 6144 + 2 * col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = (b2 >> (8 * i)) & 0xFF;
      const float d = __half2float(__ushort_as_half((unsigned short)(d2 >> (16 * i))));
      const float dm = __half2float(__ushort_as_half((unsigned short)(m2 >> (16 * i))));
      s[i] = __fmul_rn((float)(b & 15), d);
      mn[i] = __fmul_rn((float)(b >> 4), -dm);
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(st + S::O_S + 4096 * gi + 4 * col);
    s[0] = v.x;
    s[1] = v.y;
    if constexpr (S::mins) {
      const float2 m = *reinterpret_cast<const float2*>(st + S::O_M + 4096 * gi + 4 * col);
      mn[0] = m.x;
      mn[1] = m.y;
    }
  }
}

// ... at local columns col .. col + 3
template <int QT>
__device__ __forceinline__ void scales4(const unsigned char* st, int gi, int col,
                                        float (&s)[4], float (&mn)[4]) {
  using S = Step<QT>;
  if constexpr (S::k16) {
    const uint32_t b4 = *reinterpret_cast<const uint32_t*>(st + S::O_S + 1024 * gi + col);
    const uint2 d4 = *reinterpret_cast<const uint2*>(st + S::O_S + 4096 + 2 * col);
    const uint2 m4 = *reinterpret_cast<const uint2*>(st + S::O_S + 6144 + 2 * col);
    const unsigned short* dv = reinterpret_cast<const unsigned short*>(&d4);
    const unsigned short* mv = reinterpret_cast<const unsigned short*>(&m4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = (b4 >> (8 * i)) & 0xFF;
      s[i] = __fmul_rn((float)(b & 15), __half2float(__ushort_as_half(dv[i])));
      mn[i] = __fmul_rn((float)(b >> 4), -__half2float(__ushort_as_half(mv[i])));
    }
  } else {
    const float4 v = *reinterpret_cast<const float4*>(st + S::O_S + 4096 * gi + 4 * col);
    s[0] = v.x;
    s[1] = v.y;
    s[2] = v.z;
    s[3] = v.w;
    if constexpr (S::mins) {
      const float4 m = *reinterpret_cast<const float4*>(st + S::O_M + 4096 * gi + 4 * col);
      mn[0] = m.x;
      mn[1] = m.y;
      mn[2] = m.z;
      mn[3] = m.w;
    }
  }
}

// a lane's sums: M = 1, the 4 columns 4t .. of its 16; else its 16
// columns for rows 4 nb + t
template <int MT> struct Acc {
  static constexpr int C = MT == 1 ? 4 : 16, NB = MT == 1 ? 1 : MT / 4;
};

// the staged window: hi / lo rows, their stride, the group sums
struct Xw {
  const unsigned char* x;
  const float* sums;
  int stride;
};

// acc += this step's products: sub of the chunk whose first element is
// window element ec; lcol: the lane's first local column
template <int QT, int MT>
__device__ __forceinline__ void step_math(const unsigned char* __restrict__ st,
                                          const Xw& w, int ec, int sub, int lcol,
                                          int lane,
                                          float (&acc)[Acc<MT>::C][Acc<MT>::NB]) {
  using S = Step<QT>;
  constexpr int NB = Acc<MT>::NB, KH = S::k16 ? 1 : 2, NQ = 4 * KH;
  constexpr bool has_min = Fmt<QT>::has_min;
  const int t = lane & 3, g = lane >> 2, piece = lcol >> 4;
  uint4 P[NQ], H[S::q5 ? NQ : 1];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int r = 16 * (i >> 2) + 8 * ((i >> 1) & 1) + 2 * t + (i & 1);
    const int o = r * ROWB + 16 * piece;
    P[i] = *reinterpret_cast<const uint4*>(st + o);
    if constexpr (S::q5) H[i] = *reinterpret_cast<const uint4*>(st + S::O_QH + o);
  }
  // the groups one at a time: unrolled, their operands spill at 16 rows
#pragma unroll 1
  for (int gi = 0; gi < S::NG; ++gi) {
    const int e = ec + group_elem<QT>(gi, sub);
    uint32_t b[KH][NB][2];
#pragma unroll
    for (int h2 = 0; h2 < KH; ++h2)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int row = MT == 1 ? (g & 1) : 8 * nb + g;
        const unsigned char* bp = w.x + row * w.stride + 2 * (e + 16 * h2 + 2 * t);
        b[h2][nb][0] = *reinterpret_cast<const uint32_t*>(bp);
        b[h2][nb][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
    float gs[NB];
    if constexpr (has_min) {
      const int gl = e / Fmt<QT>::group;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) gs[nb] = w.sums[MT == 1 ? gl : gl * MT + 4 * nb + t];
    }
    float v[4] = {0.f, 0.f, 0.f, 0.f};     // M = 1: the dots of the kept columns
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[nb][i] = 0.f;
#pragma unroll
      for (int h2 = 0; h2 < KH; ++h2) {
        uint32_t a[4];
        frag<QT>(P + 4 * h2, H + (S::q5 ? 4 * h2 : 0), j, gi, sub, a);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_acc(d[nb], a, b[h2][nb][0], b[h2][nb][1]);
      }
      if constexpr (MT == 1) {
        if ((j >> 1) == t) {
          v[2 * (j & 1)] = d[0][0] + d[0][1];
          v[2 * (j & 1) + 1] = d[0][2] + d[0][3];
        }
      } else {
        float s[2], mn[2];
        scales2<QT>(st, gi, lcol + 2 * j, s, mn);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          float& a0 = acc[2 * j][nb];
          float& a1 = acc[2 * j + 1][nb];
          a0 = fmaf(d[nb][0] + d[nb][1], s[0], a0);
          a1 = fmaf(d[nb][2] + d[nb][3], s[1], a1);
          if constexpr (has_min) {
            a0 = fmaf(mn[0], gs[nb], a0);
            a1 = fmaf(mn[1], gs[nb], a1);
          }
        }
      }
    }
    if constexpr (MT == 1) {
      float s[4], mn[4];
      scales4<QT>(st, gi, lcol + 4 * t, s, mn);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(v[i], s[i], acc[i][0]);
        if constexpr (has_min) acc[i][0] = fmaf(mn[i], gs[0], acc[i][0]);
      }
    }
  }
}

// ---------------------------------------------------------------- window
// The chunks a block's range reads, in the order the window holds them:
// [a0, a1), then [c0, b1) (none where b1 = c0) for a range that runs from
// a group's last chunks into the next group's first ones.
struct Span {
  int a0, a1, c0, b1;
  __device__ int n() const { return a1 - a0 + b1 - c0; }
  // the window chunk of chunk c, and the chunk of window chunk w
  __device__ int wc(int c) const { return c >= a0 ? c - a0 : a1 - a0 + c - c0; }
  __device__ int src(int w) const { return w < a1 - a0 ? a0 + w : c0 + w - (a1 - a0); }
};

// All threads: rows of the phase's activations, the chunks of sp, as bf16
// hi / lo rows into the window (rows past M zero), and for a format with
// mins the f32 sum of each group (in a fixed order); U float4 loads of a
// thread in flight at once. Phase A: x (M, dim); phase B: mid = act(gate)
// * up from gu (M, 2 ffn). The caller's next block barrier publishes the
// window.
template <int QT, int MT, bool A>
__device__ __forceinline__ Xw stage_window(unsigned char* win, const FfnArgs& a,
                                           const Span& sp) {
  constexpr bool has_min = Fmt<QT>::has_min;
  constexpr int GA = Fmt<QT>::group, L = GA / 4, U = 4;
  const int M = a.M, nch = sp.n(), stride = win_stride(nch), per_row = nch * 64;
  float* sums = reinterpret_cast<float*>(win + win_rows<MT>() * stride);
  const int total = (MT == 1 ? 1 : MT) * per_row;     // float4s
  for (int base = 0; base < total; base += U * NT) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT + (int)threadIdx.x;
      const int m = i / per_row, q = i - m * per_row;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && m < M) {
        const int c = 256 * sp.src(q >> 6) + 4 * (q & 63);
        if (A) {
          v[u] = __ldcg(reinterpret_cast<const float4*>(a.x + (size_t)m * a.dim + c));
        } else {
          const float* gm = a.gu + (size_t)m * 2 * a.ffn + c;
          const float4 g = __ldcg(reinterpret_cast<const float4*>(gm));
          const float4 up = __ldcg(reinterpret_cast<const float4*>(gm + a.ffn));
          v[u] = make_float4(act_fn(g.x, a.act) * up.x, act_fn(g.y, a.act) * up.y,
                             act_fn(g.z, a.act) * up.z, act_fn(g.w, a.act) * up.w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // a warp's 32 float4s are all in or all out (total is a multiple of
      // 64), and the L lanes of a group are neighbours in it
      const int i = base + u * NT + (int)threadIdx.x;
      if (base + u * NT >= total) break;
      const int m = i / per_row, q = i - m * per_row;
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(v[u].x, v[u].y);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(v[u].z, v[u].w);
      const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
      const __nv_bfloat162 l01 = __floats2bfloat162_rn(v[u].x - f01.x, v[u].y - f01.y);
      const __nv_bfloat162 l23 = __floats2bfloat162_rn(v[u].z - f23.x, v[u].w - f23.y);
      if (i < total) {
        const int rh = MT == 1 ? 0 : 2 * m;
        *reinterpret_cast<uint2*>(win + rh * stride + 8 * q) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                       *reinterpret_cast<const uint32_t*>(&h23));
        *reinterpret_cast<uint2*>(win + (rh + 1) * stride + 8 * q) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&l01),
                       *reinterpret_cast<const uint32_t*>(&l23));
      }
      if constexpr (has_min) {
        float acc = ((v[u].x + v[u].y) + v[u].z) + v[u].w;
#pragma unroll
        for (int o = 1; o < L; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (i < total && q % L == 0)
          sums[MT == 1 ? q / L : (q / L) * MT + m] = acc;
      }
    }
  }
  return Xw{win, sums, stride};
}

// ---------------------------------------------------------------- sums
// the lane's first local column: warp w takes 128 w .., lane g 16 of them
__device__ __forceinline__ int lane_col(int warp, int lane) {
  return 128 * warp + 16 * (lane >> 2);
}

// This warp's sums for group p into slot `slot` of `partial` ((M, 1024)
// f32 a slot, in local columns); acc is zeroed. M = 1: the lane's 4
// columns 4t ..; else its 16 columns of rows 4 nb + t.
template <int MT>
__device__ __forceinline__ void put_slot(const FfnArgs& a, int slot, int warp, int lane,
                                         float (&acc)[Acc<MT>::C][Acc<MT>::NB]) {
  const int t = lane & 3;
  float* dst = a.partial + (size_t)slot * a.M * GC + lane_col(warp, lane);
#pragma unroll
  for (int nb = 0; nb < Acc<MT>::NB; ++nb) {
    const int m = MT == 1 ? 0 : 4 * nb + t;
    if (m < a.M) {
#pragma unroll
      for (int c = 0; c < Acc<MT>::C; c += 4)
        __stcg(reinterpret_cast<float4*>(dst + m * GC + (MT == 1 ? 4 * t : c)),
               make_float4(acc[c][nb], acc[c + 1][nb], acc[c + 2][nb], acc[c + 3][nb]));
    }
#pragma unroll
    for (int c = 0; c < Acc<MT>::C; ++c) acc[c][nb] = 0.f;
  }
}

// ---------------------------------------------------------------- phases
// The first R - 1 steps of this block's range into the ring (the ring
// past the window); a block with no range requests nothing.
template <int QT, int MT, bool A>
__device__ __noinline__ void ffn_prefetch(const FfnArgs* __restrict__ pa,
                                          unsigned char* smem, uint64_t* bars) {
  using S = Step<QT>;
  constexpr int R = ring_stages<QT, MT>();
  const Geo geo = A ? pa->ga : pa->gb;
  const Win win(geo, S::SPC);
  const int i = (int)blockIdx.x - win.b0;
  if (i >= win.nbk) return;
  const int p0 = win.start(i), p1 = win.start(i + 1);
  unsigned char* ring = smem + win_bytes<QT, MT>();
  Cursor u;
  u.seek(win, S::SPC, p0);
  const Cursor u0 = u;
  for (int k = 0; k < R - 1 && p0 + k < p1; ++k, u.next(win, S::SPC))
    arm_step<QT>(bars + k, geo, u);
  __syncthreads();                           // armed before any copy lands
  u = u0;
  for (int k = 0; k < R - 1 && p0 + k < p1; ++k, u.next(win, S::SPC))
    copy_step<QT>(ring + k * S::BYTES, bars + k, geo, u);
}

// A phase's products after its prefetch: stage the window, stream the
// block's range of steps through the ring, and where the range leaves a
// group (and at its end) put each warp's sums into the block's slot.
template <int QT, int MT, bool A>
__device__ __noinline__ void ffn_phase(const FfnArgs* __restrict__ pa,
                                       unsigned char* smem, uint64_t* bars) {
  using S = Step<QT>;
  constexpr int R = ring_stages<QT, MT>(), SPC = S::SPC;
  const FfnArgs& a = *pa;
  const Geo geo = A ? a.ga : a.gb;
  const Win win(geo, SPC);
  const int i = (int)blockIdx.x - win.b0;
  if (i >= win.nbk) return;
  const int p0 = win.start(i), p1 = win.start(i + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* ring = smem + win_bytes<QT, MT>();
  Cursor cur, last, ahead;
  cur.seek(win, SPC, p0);
  last.seek(win, SPC, p1 - 1);
  ahead.seek(win, SPC, p0 + R - 1 < p1 ? p0 + R - 1 : p1 - 1);
  // the chunks the range reads: within one group, or from one group's
  // last chunks into the next one's first, or else the whole window
  Span sp{win.c0, win.c1, win.c0, win.c0};
  if (cur.p == last.p) sp = Span{cur.c, last.c + 1, win.c0, win.c0};
  else if (last.p == cur.p + 1 && last.c < cur.c) sp = Span{cur.c, win.c1, win.c0, last.c + 1};
  const Xw w = stage_window<QT, MT, A>(smem, a, sp);
  const int lcol = lane_col(warp, lane);
  float acc[Acc<MT>::C][Acc<MT>::NB] = {};
#pragma unroll 1
  for (int p = p0; p < p1; ++p) {
    const int j = p - p0, next = (j + R - 1) % R;
    mbar_wait(bars + j % R, (j / R) & 1);    // step j has landed
    if (p + R - 1 < p1) arm_step<QT>(bars + next, geo, ahead);
    __syncthreads();                         // the window is staged; step
                                             // j - 1 is read
    if (p + R - 1 < p1) {
      copy_step<QT>(ring + next * S::BYTES, bars + next, geo, ahead);
      ahead.next(win, SPC);
    }
    const int grp = cur.p;
    const bool mine = GC * grp + 128 * warp < geo.N;   // the warp has columns
    if (mine)
      step_math<QT, MT>(ring + (j % R) * S::BYTES, w, 256 * sp.wc(cur.c), cur.s, lcol,
                        lane, acc);
    cur.next(win, SPC);
    if (mine && (p + 1 == p1 || cur.p != grp))
      put_slot<MT>(a, win.slot(i, grp, geo.groups), warp, lane, acc);
  }
}

// This lane's share of the sum over group p's slots of the float4 at
// offset `off` (row and local column) of each: its slots k = sub, sub + L,
// ... of the group's, in K order (window by window, block by block), U
// loads in flight.
__device__ __forceinline__ float4 slot_sum(const FfnArgs& a, const Geo& geo, int spc,
                                           int p, size_t off, int L, int sub) {
  constexpr int U = 8;
  const size_t MS = (size_t)a.M * GC;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  int k0 = 0;                                          // slots before window v
  for (int v = 0; v < geo.nwin; ++v) {
    const Win o(geo, spc, v);
    const int lo = o.block_at(p * o.line), hi = o.block_at((p + 1) * o.line - 1);
    const int n = hi - lo + 1, first = o.slot(lo, p, geo.groups);
    for (int i = ((sub - k0) % L + L) % L; i < n; i += U * L) {
      float4 q[U];
#pragma unroll
      for (int b = 0; b < U; ++b)
        q[b] = i + b * L < n ? __ldcg(reinterpret_cast<const float4*>(
                                   a.partial + (first + i + b * L) * MS + off))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int b = 0; b < U; ++b) {
        if (i + b * L >= n) break;
        sum.x += q[b].x;
        sum.y += q[b].y;
        sum.z += q[b].z;
        sum.w += q[b].w;
      }
    }
    k0 += n;
  }
  return sum;
}

__device__ __forceinline__ float4 lanes_sum(float4 v, int L) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    if (o >= L) break;
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
  }
  return v;
}

// After a grid barrier: the slots added into the phase's output by the
// whole grid (phase A: gu = x Wg | x Wu, phase B: out). An item is 4
// neighbouring output columns of one row; L lanes take an item, each its
// share of the slots (slot_sum), and a fixed tree over the L lanes adds
// the shares, so two runs give the same bits.
template <bool A>
__device__ __noinline__ void ffn_combine(const FfnArgs* __restrict__ pa, int spc) {
  const FfnArgs& a = *pa;
  const Geo geo = A ? a.ga : a.gb;
  float* out = A ? a.gu : a.out;
  const int M = a.M, Q = geo.N / 4, items = M * Q;
  const int T = gridDim.x * NT, tid = blockIdx.x * NT + threadIdx.x;
  int L = 8;                                           // lanes an item
  while (L > 1 && items * L > T) L >>= 1;
  const int sub = tid & (L - 1), per = T / L;
  for (int base = 0; base < items; base += per) {
    const int item = base + tid / L;
    const bool live = item < items;
    const int m = live ? item / Q : 0, c = live ? 4 * (item - m * Q) : 0;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) v = slot_sum(a, geo, spc, c / GC, (size_t)m * GC + c % GC, L, sub);
    v = lanes_sum(v, L);
    if (live && !sub) *reinterpret_cast<float4*>(out + (size_t)m * geo.N + c) = v;
  }
}

// the ring's mbarriers, fresh (thread 0; a block barrier follows)
__device__ __forceinline__ void init_bars(uint64_t* bars, bool again) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < RING_MAX; ++k) {
      if (again) mbar_inval(bars + k);
      mbar_init(bars + k);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

template <int MT>
__global__ void __launch_bounds__(NT, 1) ffn_fused_kernel(const FfnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ FfnArgs sa;
  __shared__ uint64_t bars[RING_MAX];
  if (threadIdx.x == 0) sa = a;
  init_bars(bars, false);
  __syncthreads();
  // phase A: gate | up into the slots
  TLG_SWITCH_FMT(a.qt_gu, (ffn_prefetch<QT, MT, true>(&sa, smem, bars)))
  TLG_SWITCH_FMT(a.qt_gu, (ffn_phase<QT, MT, true>(&sa, smem, bars)))
  __syncthreads();                           // the ring is read
  init_bars(bars, true);
  __syncthreads();
  // phase B's first steps are requested before the barriers
  TLG_SWITCH_FMT(a.qt_dn, (ffn_prefetch<QT, MT, false>(&sa, smem, bars)))
  grid_sync(a.bar);
  ffn_combine<true>(&sa, a.qt_gu == Q8_0 ? 8 : 4);    // gu = x Wg | x Wu
  grid_sync(a.bar);
  // phase B: down over mid = act(gate) * up into the slots, then out
  TLG_SWITCH_FMT(a.qt_dn, (ffn_phase<QT, MT, false>(&sa, smem, bars)))
  grid_sync(a.bar);
  ffn_combine<false>(&sa, a.qt_dn == Q8_0 ? 8 : 4);
}

int row_class(int M) { return M == 1 ? 1 : (M <= 4 ? 4 : (M <= 8 ? 8 : 16)); }

const void* kernel_for(int M) {
  switch (row_class(M)) {
    case 1: return (const void*)ffn_fused_kernel<1>;
    case 4: return (const void*)ffn_fused_kernel<4>;
    case 8: return (const void*)ffn_fused_kernel<8>;
    default: return (const void*)ffn_fused_kernel<16>;
  }
}

int smem_for(int M) {
  switch (row_class(M)) {
    case 1: return smem_launch<1>();
    case 4: return smem_launch<4>();
    case 8: return smem_launch<8>();
    default: return smem_launch<16>();
  }
}

// a window's chunks for format qt at M rows
template <int MT> int window_chunks(int qt) {
  switch (qt) {
    case Q4_0: return xch<Q4_0, MT>();
    case Q4_1: return xch<Q4_1, MT>();
    case Q5_0: return xch<Q5_0, MT>();
    case Q5_1: return xch<Q5_1, MT>();
    case Q8_0: return xch<Q8_0, MT>();
    default: return xch<Q2_K, MT>();
  }
}
int window_chunks(int M, int qt) {
  switch (row_class(M)) {
    case 1: return window_chunks<1>(qt);
    case 4: return window_chunks<4>(qt);
    case 8: return window_chunks<8>(qt);
    default: return window_chunks<16>(qt);
  }
}

// whether nwin windows keep every block's range of a phase (kch chunks,
// `groups` column groups, spc steps a chunk) within `cap` chunks: a range
// of L positions reads at most min(the window's chunks, (L - 1) / spc + 2)
// (ffn_phase's Span)
bool windows_fit(int kch, int groups, int nwin, int blocks, int spc, int cap) {
  if (nwin < 1 || nwin > blocks || nwin > kch) return false;
  for (int v = 0; v < nwin; ++v) {
    const int nch = kch * (v + 1) / nwin - kch * v / nwin;
    const int nb = blocks * (v + 1) / nwin - blocks * v / nwin;
    const int len = groups * spc * nch, nbk = nb < len ? nb : len;
    const int L = (len + nbk - 1) / nbk, need = (L - 1) / spc + 2;
    if ((nch < need ? nch : need) > cap) return false;
  }
  return true;
}

// the kernel of M rows may use its shared memory (set on the current
// device before the grid is sized)
int allow_smem(int M) {
  return (int)cudaFuncSetAttribute(kernel_for(M),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_for(M));
}

}  // namespace

// The grid of the launch for M rows (blocks, written to *blocks): one
// block an SM, when the card can run a cooperative launch of it; else an
// error code.
extern "C" int tl_ffn_fused_blocks(int M, int* blocks) {
  if (M <= 0 || M > 16) return (int)cudaErrorInvalidValue;
  const int e = allow_smem(M);
  if (e) return e;
  return coop_blocks(kernel_for(M), smem_for(M), 1, blocks);
}

// x (M, dim) f32, 16-byte aligned; gate|up planes (2 ffn columns, K = dim)
// as qa/qb/sa/sb, down planes (dim columns, K = ffn), each 16-byte
// aligned; gu (M, 2 ffn) f32 scratch; out (M, dim) f32; partial (blocks +
// max(nwin_a * ceil(2 ffn / 1024), nwin_b * ceil(dim / 1024))) x M x 1024
// f32 scratch; bar: 2 zeroed uint32, left zeroed; act 0 silu, 1 gelu
// (tanh), 2 relu; nwin_a / nwin_b: K windows of each phase
// (ops/ffn_fused.py::ffn_plan), such that every block's range fits a
// window (windows_fit); `blocks` must be what tl_ffn_fused_blocks gave on
// this device. Returns the launch's CUDA error code.
extern "C" int tl_ffn_fused(int qt_gu, int qt_dn, const void* x,
                            const void* gqa, const void* gqb, const void* gsa,
                            const void* gsb, const void* dqa, const void* dqb,
                            const void* dsa, const void* dsb, void* gu,
                            void* out, void* partial, void* bar, int M,
                            int dim, int ffn, int act, int nwin_a, int nwin_b,
                            int blocks, void* stream) {
  if (M <= 0 || M > 16 || dim <= 0 || ffn <= 0 || dim % 256 || ffn % 256 ||
      !known_format(qt_gu) || !known_format(qt_dn) || act < 0 || act > 2 ||
      blocks < 1 || nwin_a < 1 || nwin_b < 1 || nwin_a > blocks ||
      nwin_b > blocks)
    return (int)cudaErrorInvalidValue;
  const int kch_a = dim / 256, kch_b = ffn / 256;
  const int groups_a = (2 * ffn + GC - 1) / GC, groups_b = (dim + GC - 1) / GC;
  if (!windows_fit(kch_a, groups_a, nwin_a, blocks, qt_gu == Q8_0 ? 8 : 4,
                   window_chunks(M, qt_gu)) ||
      !windows_fit(kch_b, groups_b, nwin_b, blocks, qt_dn == Q8_0 ? 8 : 4,
                   window_chunks(M, qt_dn)))
    return (int)cudaErrorInvalidValue;
  FfnArgs a;
  a.ga = Geo{(const uint8_t*)gqa, (const uint8_t*)gqb, gsa, gsb, 2 * ffn, groups_a,
             kch_a, nwin_a};
  a.gb = Geo{(const uint8_t*)dqa, (const uint8_t*)dqb, dsa, dsb, dim, groups_b, kch_b,
             nwin_b};
  a.x = (const float*)x;
  a.gu = (float*)gu;
  a.out = (float*)out;
  a.partial = (float*)partial;
  a.bar = (unsigned int*)bar;
  a.qt_gu = qt_gu;
  a.qt_dn = qt_dn;
  a.M = M;
  a.dim = dim;
  a.ffn = ffn;
  a.act = act;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(kernel_for(M), dim3(blocks), dim3(NT), args,
                                          smem_for(M), (cudaStream_t)stream);
}
