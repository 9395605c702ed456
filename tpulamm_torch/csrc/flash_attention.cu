// Flash attention over the slot KV cache, two entry points for sm_90a.
//
// Replaces tpulamm/ops/flash_attention.py::flash_attention (Pallas body
// `_kernel`) and ::flash_decode (`_decode_kernel` plus its cross-chunk
// combine). Both compute, for q (B, Hkv, T*G, hd) with the G query heads of
// one KV head folded into the rows, softmax(q k^T * scale) v over the cache
// rows k / v (B, Hkv, S, hd) under the mask the engine's einsum path uses:
//   live = kpos >= 0 (and col < S);
//   causal: kpos <= qbase[b] + row / G and row / G < qlen[b].
// A q8_0 cache passes int8 codes with per-row f32 scales ks / vs (B, Hkv, S):
// ks folds into the score columns, vs into p before the PV product, so the
// cache streams at one byte per element and is never dequantized whole.
// Fully masked rows give exact zeros (the l > 0 guard).
//
// Numerics as on the TPU: q, k, v and p are rounded to bf16 before each
// product (int8 codes convert to bf16 exactly); scores, the softmax and all
// sums are f32. The softmax runs in base 2: log2(e) is folded into the
// scale and exp2 (ex2.approx, results below 2^-126 flushed to 0) replaces
// exp: the same function, rounded differently.
//
// What bounds each kernel on an H100, and what the design does about it:
//
// - flash_attention (prefill; prefill_kernel) is bound by operations: a
//   512-token ubatch over a long span does 4 * T * G * S * hd operations per
//   head on ~S * hd * 2 bytes of K/V, ~1,000 operations a byte. A block of
//   two warpgroups owns 128 query rows (64 each; a head at T = 512 is 4
//   blocks, the 16k shape 128 blocks on 132 SMs) and walks the key tiles of
//   128 keys that are live for any of its rows. Q is staged once, bf16,
//   K-major with the 128-byte swizzle. QK^T runs as wgmma m64n128k16 from
//   shared memory; the S accumulator, scaled, masked and exponentiated in
//   registers, rounded to bf16 with vs folded in, is PV's A operand from
//   registers (wgmma m64n{hd}k16, V read MN-major through tnspB), so p never
//   goes to shared memory. K/V tiles come through a cp.async ring (3 slots
//   when K is int8, else 2), loaded one or two tiles ahead of the MMAs
//   (cp.async rather than TMA: no libcuda and no tensor map built
//   on the host per call for the strided span views, and the int8 tiles
//   pass through the threads for their conversion anyway). int8
//   tiles are converted to bf16 once per block, packed (8 elements a
//   thread-step), into operand tiles; the conversion of V(j) runs while
//   QK^T(j) is in flight and that of K(j+1) while PV(j) is (in practice
//   the conversions, the exponentials and the rest of the softmax share
//   the CUDA cores and take more time than the MMAs; PERF.md). Per-element
//   masking runs only on tiles that need it (a dead or shifted key, the
//   causal diagonal, the ragged tail), found with the live tiles by a
//   prepass over kpos.
// - flash_decode (decode_kernel) is bound by bytes: a step reads the whole
//   K/V span once for a few rows. A block of 4 warps takes one chunk of
//   keys for up to 64 rows, padded to m16 tiles (one on the path, T*G = 1);
//   its warps split the rows' m16 tiles and each stage's 16-key sub-tiles
//   among themselves, each warp keeping its own (acc, m, l) in registers,
//   and the block folds them in shared memory in a fixed order before it
//   writes the chunk's partial. K/V stream through a 3-slot cp.async ring
//   of 64-key tiles (two in flight while one is used). The products are
//   mma.sync m16n8k16 with q in registers; head-dim and key orders are
//   permuted (the same way on both operands) so that each thread reads its
//   B fragments as whole 16-byte runs of the staged rows and converts int8
//   codes to bf16 in registers: there is no second bf16 copy. The wrapper
//   sizes the chunks so that the grid is one wave of resident blocks
//   (ops/flash_attention.py::decode_chunking); `fd_combine` folds the
//   partials in chunk order (no atomics: a run gives the same bits every
//   time).
// - Head dim 256, and f32 / f16 K/V (not on the serving path: its caches
//   are bf16 or q8_0), keep the older body (legacy::flash_kernel,
//   mma.sync with 64-row blocks): a 64 x 256 f32 accumulator a warpgroup
//   does not fit beside the scores, and neither do its operand tiles. The
//   choice is by head dim and type at compile time; each (head dim, K/V
//   type) has exactly one kernel.
// K, V, kpos, ks and vs are read through their strides: the span view of a
// (B, Hkv, n_ctx + 1, hd) cache buffer is never copied.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_MAX = 232448;           // H100: dynamic shared memory a block

enum { T_F32 = 0, T_BF16 = 1, T_F16 = 2, T_I8 = 3 };

struct Args {
  const float* q;                  // (B, Hkv, TG, hd) contiguous
  const void* k;                   // strided, last stride 1
  const void* v;
  const int* kpos;                 // (B, S), last stride 1
  const int* qbase;                // (B,)
  const int* qlen;                 // (B,)
  const float* ks;                 // (B, Hkv, S) or null
  const float* vs;
  float* out;                      // (B, Hkv, TG, hd), or the acc partials
  float* m_part;                   // (B, Hkv, ns, TG) for the split kernel
  float* l_part;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, kp_sb;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  int k_type, v_type;
  int Hkv, TG, S, G, causal, chunk, n_chunks;
  float scale;
};

// -- shared pieces (as in qmm.cu) --------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, or zeros where !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// hands this thread's shared-memory writes to wgmma's (async) proxy
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of bf16 element (row, k) in a tile of 64-element rows with
// the 128-byte swizzle: 16-byte chunk k / 8 lands at chunk (k / 8) ^ (row % 8)
__device__ __forceinline__ int sw128(int row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2;
}

// wgmma descriptor of a K-major, 128-byte-swizzled tile: start address,
// SBO = 1024 bytes between 8-row groups (LBO unused)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// wgmma descriptor of an MN-major, 128-byte-swizzled B tile (the same
// storage as sw128 with one row per K index): LBO = bytes between the
// 64-wide panels along N, SBO = 1024 bytes between groups of 8 K rows
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr, int lbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
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
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four int8 codes -> two bf16x2 (bytes 0, 1 and bytes 2, 3), through the
// exact f32 form 2^23 + (q + 128); an integer of 8 bits has no bits in the
// low half of its f32, so its bf16 is the high half, taken by a byte permute
__device__ __forceinline__ uint2 int8_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __float_as_uint(
        __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}

// 2^x; results below 2^-126 flush to 0 (against a row maximum of 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d (64 x 128 f32) (+)= A (64 x 16) . B (16 x 128), both bf16 K-major in
// shared memory (128-byte swizzle); scale_d 0 starts a new sum
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

// d (64 x 64 f32) += A (64 x 16, bf16 in registers: the m64k16 fragment
// a[0..3]) . B (16 x 64, bf16 MN-major in shared memory: tnspB = 1)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16, bf16 in registers: the m64k16 fragment
// a[0..3]) . B (16 x 128, bf16 MN-major in shared memory: tnspB = 1)
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- the live-tile prepass ----------------------------------------------------
// Tiles of BN keys over [kb, ke): a tile is live when some key is live for
// some row of the block (kpos >= 0 and, causal, kpos <= qpos_hi), and needs
// no per-element mask when every key is present and visible to every row
// (kpos <= qpos_lo) and every row is live (rows_ok). Writes the live tiles
// in order to list (bit 15: masked) and returns their count. Every thread
// of the block calls it.
constexpr uint16_t MASKED = 0x8000;

template <int NTH, int BN>
__device__ int live_tiles(const int* kp_row, int kb, int ke, bool causal,
                          int qpos_lo, int qpos_hi, bool rows_ok,
                          uint8_t* flags, uint16_t* list, int* count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (ke - kb + BN - 1) / BN;
  for (int i = warp; i < nt; i += NTH / 32) {
    bool any = false, all = true;
#pragma unroll
    for (int c = lane; c < BN; c += 32) {
      const int col = kb + i * BN + c;
      const int kp = col < ke ? kp_row[col] : -1;
      any |= kp >= 0 && (!causal || kp <= qpos_hi);
      all &= kp >= 0 && (!causal || kp <= qpos_lo);
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) flags[i] = any ? (all && rows_ok ? 2 : 1) : 0;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nt; base += 32) {
      const int i = base + lane;
      const int f = i < nt ? flags[i] : 0;
      const unsigned bal = __ballot_sync(0xffffffffu, f != 0);
      if (f)
        list[n + __popc(bal & ((1u << lane) - 1))] =
            (uint16_t)(i | (f == 1 ? MASKED : 0));
      n += __popc(bal);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// -- flash_attention: the prefill kernel (wgmma) ------------------------------
constexpr int P_BM = 128, P_BN = 128, P_NT = 256;

template <int HD, bool KQ8, bool VQ8>
struct PLayout {
  static constexpr int STAGES = KQ8 ? 3 : 2;
  static constexpr int KB = P_BN * HD * (KQ8 ? 1 : 2);   // staged K tile
  static constexpr int VB = P_BN * HD * (VQ8 ? 1 : 2);
  static constexpr int O_K = 0, O_V = KB, O_KP = KB + VB;
  static constexpr int O_KS = O_KP + P_BN * 4, O_VS = O_KS + P_BN * 4;
  static constexpr int SLOT = (O_VS + P_BN * 4 + 1023) / 1024 * 1024;
  static constexpr int OPB = P_BN * HD * 2;              // a bf16 operand tile
  static constexpr int O_Q = 0;                          // P_BM x HD bf16
  static constexpr int O_RING = P_BM * HD * 2;
  static constexpr int O_KC = O_RING + STAGES * SLOT;    // converted K (int8)
  static constexpr int O_VC = O_KC + (KQ8 ? OPB : 0);    // converted V (int8)
  static constexpr int FIXED = O_VC + (VQ8 ? OPB : 0);   // then count, list
};

// byte offset of 16-byte chunk c of staged key row r: int8 rows of HD
// bytes, chunks XOR-swizzled by the row; bf16 rows are stored as the
// operand (64-element panels of ROWS rows, 128-byte swizzle)
template <bool Q8, int HD, int ROWS>
__device__ __forceinline__ int stage_off(int r, int c) {
  if constexpr (Q8)
    return r * HD + ((c ^ (r & (HD / 16 - 1))) << 4);
  else
    return (c >> 3) * ROWS * 128 + sw128(r, (c & 7) * 8);
}

// start the copies of key tile `tile` (keys tile * P_BN ..) into `slot`
template <int HD, bool KQ8, bool VQ8>
__device__ __forceinline__ void p_load(const Args& a, uint8_t* slot, int tile,
                                       int b, int h, int tid) {
  using L = PLayout<HD, KQ8, VQ8>;
  const int k0 = tile * P_BN;
  {
    constexpr int ES = KQ8 ? 1 : 2, CH = HD * ES / 16;
    const char* base = (const char*)a.k + (b * a.k_sb + h * a.k_sh) * ES;
#pragma unroll
    for (int i = tid; i < P_BN * CH; i += P_NT) {
      const int r = i / CH, c = i % CH, col = k0 + r;
      const bool ok = col < a.S;
      cp16(slot + L::O_K + stage_off<KQ8, HD, P_BN>(r, c),
           base + (ok ? col * a.k_ss * ES : 0) + c * 16, ok);
    }
  }
  {
    constexpr int ES = VQ8 ? 1 : 2, CH = HD * ES / 16;
    const char* base = (const char*)a.v + (b * a.v_sb + h * a.v_sh) * ES;
#pragma unroll
    for (int i = tid; i < P_BN * CH; i += P_NT) {
      const int r = i / CH, c = i % CH, col = k0 + r;
      const bool ok = col < a.S;
      cp16(slot + L::O_V + stage_off<VQ8, HD, P_BN>(r, c),
           base + (ok ? col * a.v_ss * ES : 0) + c * 16, ok);
    }
  }
  // kpos, ks, vs of the tile: 4 bytes each (span views are not 16-byte
  // aligned); columns past S are zeros, which the mask rejects by column
  for (int i = tid; i < 3 * P_BN; i += P_NT) {
    const int w = i / P_BN, r = i % P_BN, col = k0 + r;
    const bool ok = col < a.S;
    const int* src;
    if (w == 0) {
      src = a.kpos + b * a.kp_sb;
    } else {
      const float* sc = w == 1 ? a.ks : a.vs;
      if (sc == nullptr) continue;
      src = reinterpret_cast<const int*>(
          sc + (w == 1 ? b * a.ks_sb + h * a.ks_sh : b * a.vs_sb + h * a.vs_sh));
    }
    cp4(slot + L::O_KP + w * P_BN * 4 + r * 4, src + (ok ? col : 0), ok);
  }
}

// int8 codes of a staged tile -> the bf16 operand tile (K-major panels,
// 128-byte swizzle); a thread-step takes 8 codes to one 16-byte chunk. A
// thread keeps its group of 8 codes and steps RSTEP rows, a multiple of 8,
// so both swizzles keep their phase and the offsets are fixed strides.
template <int HD>
__device__ __forceinline__ void p_convert(const uint8_t* raw, uint8_t* op,
                                          int tid) {
  constexpr int C8 = HD / 8, RSTEP = P_NT / C8;
  static_assert(RSTEP % 8 == 0, "the swizzle phase must stay fixed");
  const int r0 = tid / C8, c8 = tid % C8;
  const uint8_t* src =
      raw + stage_off<true, HD, P_BN>(r0, c8 >> 1) + (c8 & 1) * 8;
  uint8_t* dst = op + (c8 >> 3) * P_BN * 128 + sw128(r0, (c8 & 7) * 8);
#pragma unroll
  for (int it = 0; it < P_BN / RSTEP; ++it) {
    const uint2 w = *reinterpret_cast<const uint2*>(src + it * RSTEP * HD);
    const uint2 lo = int8_to_bf16(w.x), hi = int8_to_bf16(w.y);
    *reinterpret_cast<uint4*>(dst + it * RSTEP * 128) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs128(o, a, db);
}

template <int HD, bool KQ8, bool VQ8>
__global__ void __launch_bounds__(P_NT, 1) prefill_kernel(const Args a) {
  using L = PLayout<HD, KQ8, VQ8>;
  constexpr int ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on one
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sm + L::O_RING;
  const int n_tiles = (a.S + P_BN - 1) / P_BN;
  int* n_live_s = reinterpret_cast<int*>(sm + L::FIXED);
  uint16_t* list = reinterpret_cast<uint16_t*>(sm + L::FIXED + 16);
  uint8_t* flags = reinterpret_cast<uint8_t*>(list + n_tiles);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * P_BM;
  const int qb = a.qbase[b], ql = a.qlen[b], G = a.G, TG = a.TG;
  const bool causal = a.causal != 0;
  const int rend = min(TG, row0 + P_BM);
  const bool block_live = !causal || row0 / G < ql;
  const int t_last = causal ? min((rend - 1) / G, ql - 1) : (rend - 1) / G;
  const bool rows_ok = !causal || (rend - 1) / G < ql;

  // this thread's two rows of the warpgroup's 64
  const int rA = row0 + 64 * wg + 16 * (warp & 3) + g, rB = rA + 8;
  const int qposA = qb + rA / G, qposB = qb + rB / G;
  const bool okA = !causal || rA / G < ql, okB = !causal || rB / G < ql;
  const float sl2 = a.scale * LOG2E;
  const bool has_ks = a.ks != nullptr, has_vs = a.vs != nullptr;

  const int n_live =
      block_live ? live_tiles<P_NT, P_BN>(a.kpos + b * a.kp_sb, 0, a.S,
                                          causal, qb + row0 / G, qb + t_last,
                                          rows_ok, flags, list, n_live_s)
                 : 0;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;

  if (n_live > 0) {
    // Q rows as bf16 (rows past TG zeros), K-major 128-byte-swizzled panels
    const float* qg = a.q + ((long long)(b * a.Hkv + h) * TG + row0) * HD;
    for (int i = tid; i < P_BM * (HD / 4); i += P_NT) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < TG)
        x = *reinterpret_cast<const float4*>(qg + (long long)r * HD + c);
      *reinterpret_cast<uint2*>(sm + L::O_Q + (c >> 6) * P_BM * 128 +
                                sw128(r, c & 63)) =
          make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
    }
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (i < n_live)
        p_load<HD, KQ8, VQ8>(a, ring + i * L::SLOT, list[i] & 0x7FFF, b, h,
                             tid);
      cp_commit();
    }
    if constexpr (KQ8) {
      cp_wait<ST - 2>();
      __syncthreads();
      p_convert<HD>(ring + L::O_K, sm + L::O_KC, tid);
    }
    const uint32_t qop = smem_u32(sm + L::O_Q) + wg * 64 * 128;

    for (int i = 0; i < n_live; ++i) {
      const int ent = list[i];
      const int k0 = (ent & 0x7FFF) * P_BN;
      const bool masked = (ent & MASKED) != 0;
      uint8_t* slot = ring + (i % ST) * L::SLOT;
      // (A) tile i has landed (and K(i) is converted); every MMA of tile
      // i - 1 is done, so its slot may be refilled
      cp_wait<ST - 2>();
      fence_async();
      __syncthreads();
      if (i + ST - 1 < n_live)
        p_load<HD, KQ8, VQ8>(a, ring + ((i + ST - 1) % ST) * L::SLOT,
                             list[i + ST - 1] & 0x7FFF, b, h, tid);
      cp_commit();

      // S = Q K^T: 64 rows x 128 keys a warpgroup
      const uint32_t kop = smem_u32(KQ8 ? sm + L::O_KC : slot + L::O_K);
      float s[64];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk & 3) * 32;      // 16 bf16 of the panel
        wgmma_ss128(s,
                    desc_sw128(qop + (kk >> 2) * P_BM * 128 + off),
                    desc_sw128(kop + (kk >> 2) * P_BN * 128 + off), kk > 0);
      }
      wg_commit();
      if constexpr (VQ8) p_convert<HD>(slot + L::O_V, sm + L::O_VC, tid);
      wg_wait<0>();
      reg_fence(s);

      // scale (log2 e folded in), q8 K fold, mask; the running max
      const int* kp = reinterpret_cast<const int*>(slot + L::O_KP);
      const float* kss = reinterpret_cast<const float*>(slot + L::O_KS);
      const float* vss = reinterpret_cast<const float*>(slot + L::O_VS);
      float mxA = -INFINITY, mxB = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 f = make_float2(sl2, sl2);
        if (has_ks) {
          const float2 k2 = *reinterpret_cast<const float2*>(kss + 8 * j + 2 * t4);
          f = make_float2(sl2 * k2.x, sl2 * k2.y);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * j + 2 * t4 + (e & 1);
          float v = s[4 * j + e] * ((e & 1) ? f.y : f.x);
          if (masked) {
            const int kpv = kp[cl];
            bool live = k0 + cl < a.S && kpv >= 0;
            if (causal)
              live = live && (e < 2 ? (kpv <= qposA && okA)
                                    : (kpv <= qposB && okB));
            v = live ? v : -INFINITY;
          }
          s[4 * j + e] = v;
          if (e < 2) mxA = fmaxf(mxA, v); else mxB = fmaxf(mxB, v);
        }
      }
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
      const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
      const float muA = mnA == -INFINITY ? 0.f : mnA;
      const float muB = mnB == -INFINITY ? 0.f : mnB;
      const float corrA = ex2(mA - muA), corrB = ex2(mB - muB);
      float sumA = 0.f, sumB = 0.f;
      uint32_t pa[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float p[4];
        const float2 v2 = has_vs ? *reinterpret_cast<const float2*>(
                                       vss + 8 * j + 2 * t4)
                                 : make_float2(1.f, 1.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(s[4 * j + e] - (e < 2 ? muA : muB));
          if (e < 2) sumA += p[e]; else sumB += p[e];
          if (has_vs) p[e] *= (e & 1) ? v2.y : v2.x;
        }
        // n8 blocks 2u and 2u + 1 of the scores are PV's k16 step u
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      sumA += __shfl_xor_sync(0xffffffffu, sumA, 1);
      sumA += __shfl_xor_sync(0xffffffffu, sumA, 2);
      sumB += __shfl_xor_sync(0xffffffffu, sumB, 1);
      sumB += __shfl_xor_sync(0xffffffffu, sumB, 2);
      lA = lA * corrA + sumA;
      lB = lB * corrB + sumB;
      // O is rescaled only where a row maximum of the warp moved
      if (__any_sync(0xffffffffu, mnA != mA || mnB != mB)) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= corrA; o[4 * j + 1] *= corrA;
          o[4 * j + 2] *= corrB; o[4 * j + 3] *= corrB;
        }
      }
      mA = mnA;
      mB = mnB;

      if constexpr (KQ8 || VQ8) {
        // (B) V(i) is converted, tile i + 1 has landed (int8 K), and both
        // warpgroups' QK^T(i) are done: Kc may be refilled
        if constexpr (KQ8) cp_wait<ST - 2>();
        fence_async();
        __syncthreads();
      }
      // O += P V, P from registers, V MN-major
      const uint32_t vop = smem_u32(VQ8 ? sm + L::O_VC : slot + L::O_V);
      wg_fence();
#pragma unroll
      for (int u = 0; u < P_BN / 16; ++u)
        wgmma_pv<HD>(o, pa[u], desc_mn_sw128(vop + u * 16 * 128, P_BN * 128));
      wg_commit();
      if constexpr (KQ8) {
        if (i + 1 < n_live)
          p_convert<HD>(ring + ((i + 1) % ST) * L::SLOT + L::O_K,
                        sm + L::O_KC, tid);
      }
      wg_wait<0>();
      reg_fence(o);
    }
  }

  // epilogue: rows past TG are not written; a row with l = 0 gives zeros
  const float iA = lA > 0.f ? 1.f / lA : 0.f;
  const float iB = lB > 0.f ? 1.f / lB : 0.f;
  float* ob = a.out + ((long long)b * a.Hkv + h) * TG * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (rA < TG)
      *reinterpret_cast<float2*>(ob + (long long)rA * HD + c) =
          make_float2(o[4 * j] * iA, o[4 * j + 1] * iA);
    if (rB < TG)
      *reinterpret_cast<float2*>(ob + (long long)rB * HD + c) =
          make_float2(o[4 * j + 2] * iB, o[4 * j + 3] * iB);
  }
}


// -- flash_decode: the split-S kernel (mma.sync, bytes-bound) -----------------
constexpr int D_BN = 64, D_NT = 128, D_STAGES = 3, D_ROWS = 64;
constexpr int D_WARPS = D_NT / 32;

template <int HD, bool KQ8, bool VQ8>
struct DLayout {
  static constexpr int KROW = HD * (KQ8 ? 1 : 2);        // staged row bytes
  static constexpr int VROW = HD * (VQ8 ? 1 : 2);
  static constexpr int O_K = 0, O_V = D_BN * KROW;
  static constexpr int O_KP = O_V + D_BN * VROW;
  static constexpr int O_KS = O_KP + D_BN * 4, O_VS = O_KS + D_BN * 4;
  static constexpr int SLOT = (O_VS + D_BN * 4 + 127) / 128 * 128;
  static constexpr int RING = D_STAGES * SLOT;
  // after the loop: each warp's (acc 16 x HD, m 16, l 16) for the fold
  static constexpr int WSCR = 16 * HD + 32;
  static constexpr int SCR = D_WARPS * WSCR * 4;
  static constexpr int FIXED = RING > SCR ? RING : SCR;  // then count, list
};

// byte offset of 16-byte chunk c of a staged row r of ROW bytes: chunks
// XOR-swizzled by the row, so that the rows a warp reads at once fall in
// distinct banks
template <int ROW>
__device__ __forceinline__ int d_off(int r, int c) {
  constexpr int M = (ROW / 16 < 8 ? ROW / 16 : 8) - 1;
  return r * ROW + ((c ^ (r & M)) << 4);
}

// N 32-bit words of staged row r from byte `byte0` (a multiple of 4 * N,
// at most 16 per chunk)
template <int ROW, int N>
__device__ __forceinline__ void row_words(const uint8_t* tile, int r,
                                          int byte0, uint32_t* w) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          tile + d_off<ROW>(r, byte0 / 16 + i));
      w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(
        tile + d_off<ROW>(r, byte0 / 16) + (byte0 & 15));
    w[0] = x.x; w[1] = x.y;
  }
}

template <int HD, bool KQ8, bool VQ8>
__device__ __forceinline__ void d_load(const Args& a, uint8_t* slot, int k0,
                                       int ke, int b, int h, int tid) {
  using L = DLayout<HD, KQ8, VQ8>;
  {
    constexpr int ES = KQ8 ? 1 : 2, CH = L::KROW / 16;
    const char* base = (const char*)a.k + (b * a.k_sb + h * a.k_sh) * ES;
#pragma unroll
    for (int i = tid; i < D_BN * CH; i += D_NT) {
      const int r = i / CH, c = i % CH, col = k0 + r;
      const bool ok = col < ke;
      cp16(slot + L::O_K + d_off<L::KROW>(r, c),
           base + (ok ? col * a.k_ss * ES : 0) + c * 16, ok);
    }
  }
  {
    constexpr int ES = VQ8 ? 1 : 2, CH = L::VROW / 16;
    const char* base = (const char*)a.v + (b * a.v_sb + h * a.v_sh) * ES;
#pragma unroll
    for (int i = tid; i < D_BN * CH; i += D_NT) {
      const int r = i / CH, c = i % CH, col = k0 + r;
      const bool ok = col < ke;
      cp16(slot + L::O_V + d_off<L::VROW>(r, c),
           base + (ok ? col * a.v_ss * ES : 0) + c * 16, ok);
    }
  }
  for (int i = tid; i < 3 * D_BN; i += D_NT) {
    const int w = i / D_BN, r = i % D_BN, col = k0 + r;
    const bool ok = col < ke;
    const int* src;
    if (w == 0) {
      src = a.kpos + b * a.kp_sb;
    } else {
      const float* sc = w == 1 ? a.ks : a.vs;
      if (sc == nullptr) continue;
      src = reinterpret_cast<const int*>(
          sc + (w == 1 ? b * a.ks_sb + h * a.ks_sh : b * a.vs_sb + h * a.vs_sh));
    }
    cp4(slot + L::O_KP + w * D_BN * 4 + r * 4, src + (ok ? col : 0), ok);
  }
}

// Fragment orders (the same permutation on both operands of each product):
// - QK^T, k16 step s: thread t4 = lane % 4 holds head-dim elements
//   HD/4 * t4 + 4 s + {0, 1} (a0 / b0) and + {2, 3} (a2 / b1), so its B
//   fragments are one 16-byte run of each key row; score column n of n8
//   block jn is key 16 u + 8 jn + n of sub-tile u.
// - PV: the k16 step is sub-tile u's 16 keys in score order; output
//   column n of n8 block d is head-dim element HD/8 * n + d, so a thread
//   (g = lane / 4) reads elements HD/8 * g .. + HD/8 of 4 V rows.
template <int HD, bool KQ8, bool VQ8>
__global__ void __launch_bounds__(D_NT, 3) decode_kernel(const Args a) {
  using L = DLayout<HD, KQ8, VQ8>;
  constexpr int ND = HD / 8;                    // output n8 blocks
  constexpr int KW = L::KROW / 16;              // K words a row a thread
  constexpr int VW = L::VROW / 32;              // V words a row a thread
  extern __shared__ __align__(128) uint8_t sm[];
  const int n_ct = (a.chunk + D_BN - 1) / D_BN;
  int* n_live_s = reinterpret_cast<int*>(sm + L::FIXED);
  uint16_t* list = reinterpret_cast<uint16_t*>(sm + L::FIXED + 16);
  uint8_t* flags = reinterpret_cast<uint8_t*>(list + n_ct);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int rg = blockIdx.x / a.n_chunks, chunk = blockIdx.x % a.n_chunks;
  const int qb = a.qbase[b], ql = a.qlen[b], G = a.G, TG = a.TG;
  const bool causal = a.causal != 0;
  const int rbase = rg * D_ROWS, nrows = min(D_ROWS, TG - rbase);
  const int RT = (nrows + 15) / 16;             // m16 row tiles
  // warp -> (row tile, key split): splits take the 16-key sub-tiles of a
  // stage in turn
  const int rt = warp % RT, split = warp / RT;
  const int nsplit = (D_WARPS - 1 - rt) / RT + 1;
  const int kb = chunk * a.chunk, ke = min(a.S, kb + a.chunk);
  const int rlast = rbase + nrows - 1;
  const bool block_live = !causal || rbase / G < ql;
  const int t_last = causal ? min(rlast / G, ql - 1) : rlast / G;
  const bool rows_ok = !causal || rlast / G < ql;

  const int rA = rbase + 16 * rt + g, rB = rA + 8;
  const int qposA = qb + rA / G, qposB = qb + rB / G;
  const bool okA = !causal || rA / G < ql, okB = !causal || rB / G < ql;
  const float sl2 = a.scale * LOG2E;
  const bool has_ks = a.ks != nullptr, has_vs = a.vs != nullptr;

  const int n_live =
      block_live ? live_tiles<D_NT, D_BN>(a.kpos + b * a.kp_sb, kb, ke,
                                          causal, qb + rbase / G, qb + t_last,
                                          rows_ok, flags, list, n_live_s)
                 : 0;

  // q fragments of the warp's row tile, bf16, in the permuted order
  uint32_t qa[HD / 16][4];
  {
    const float* qg = a.q + (long long)(b * a.Hkv + h) * TG * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rB : rA;
#pragma unroll
      for (int s = 0; s < HD / 16; ++s) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < TG)
          x = *reinterpret_cast<const float4*>(
              qg + (long long)r * HD + (HD / 4) * t4 + 4 * s);
        qa[s][half] = pack_bf16(x.x, x.y);
        qa[s][2 + half] = pack_bf16(x.z, x.w);
      }
    }
  }

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;

#pragma unroll
  for (int i = 0; i < D_STAGES - 1; ++i) {
    if (i < n_live)
      d_load<HD, KQ8, VQ8>(a, sm + i * L::SLOT,
                           kb + (list[i] & 0x7FFF) * D_BN, ke, b, h, tid);
    cp_commit();
  }
  for (int i = 0; i < n_live; ++i) {
    const int ent = list[i];
    const int k0 = kb + (ent & 0x7FFF) * D_BN;
    const bool masked = (ent & MASKED) != 0;
    const uint8_t* slot = sm + (i % D_STAGES) * L::SLOT;
    cp_wait<D_STAGES - 2>();
    __syncthreads();             // tile i landed; tile i - 1 fully read
    if (i + D_STAGES - 1 < n_live)
      d_load<HD, KQ8, VQ8>(a, sm + ((i + D_STAGES - 1) % D_STAGES) * L::SLOT,
                           kb + (list[i + D_STAGES - 1] & 0x7FFF) * D_BN, ke,
                           b, h, tid);
    cp_commit();
    const int* kp = reinterpret_cast<const int*>(slot + L::O_KP);
    const float* kss = reinterpret_cast<const float*>(slot + L::O_KS);
    const float* vss = reinterpret_cast<const float*>(slot + L::O_VS);

    for (int u = split; u < D_BN / 16; u += nsplit) {
      float sc[2][4];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        sc[jn][0] = sc[jn][1] = sc[jn][2] = sc[jn][3] = 0.f;
        uint32_t kw[KW];
        row_words<L::KROW, KW>(slot + L::O_K, 16 * u + 8 * jn + g,
                               (L::KROW / 4) * t4, kw);
#pragma unroll
        for (int s = 0; s < HD / 16; ++s) {
          uint32_t b0, b1;
          if constexpr (KQ8) {
            const uint2 x = int8_to_bf16(kw[s]);
            b0 = x.x; b1 = x.y;
          } else {
            b0 = kw[2 * s]; b1 = kw[2 * s + 1];
          }
          mma_bf16(sc[jn], qa[s][0], qa[s][1], qa[s][2], qa[s][3], b0, b1);
        }
      }
      float mxA = -INFINITY, mxB = -INFINITY;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 16 * u + 8 * jn + 2 * t4 + (e & 1);
          float v = sc[jn][e] * sl2;
          if (has_ks) v *= kss[cl];
          if (masked) {
            const int kpv = kp[cl];
            bool live = k0 + cl < ke && kpv >= 0;
            if (causal)
              live = live && (e < 2 ? (kpv <= qposA && okA)
                                    : (kpv <= qposB && okB));
            v = live ? v : -INFINITY;
          }
          sc[jn][e] = v;
          if (e < 2) mxA = fmaxf(mxA, v); else mxB = fmaxf(mxB, v);
        }
      }
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
      const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
      const float muA = mnA == -INFINITY ? 0.f : mnA;
      const float muB = mnB == -INFINITY ? 0.f : mnB;
      float sumA = 0.f, sumB = 0.f;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(sc[jn][e] - (e < 2 ? muA : muB));
          if (e < 2) sumA += p; else sumB += p;
          if (has_vs) p *= vss[16 * u + 8 * jn + 2 * t4 + (e & 1)];
          sc[jn][e] = p;
        }
      }
      sumA += __shfl_xor_sync(0xffffffffu, sumA, 1);
      sumA += __shfl_xor_sync(0xffffffffu, sumA, 2);
      sumB += __shfl_xor_sync(0xffffffffu, sumB, 1);
      sumB += __shfl_xor_sync(0xffffffffu, sumB, 2);
      if (__any_sync(0xffffffffu, mnA != mA || mnB != mB)) {
        const float corrA = ex2(mA - muA), corrB = ex2(mB - muB);
        lA *= corrA;
        lB *= corrB;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          o[d][0] *= corrA; o[d][1] *= corrA;
          o[d][2] *= corrB; o[d][3] *= corrB;
        }
      }
      lA += sumA;
      lB += sumB;
      mA = mnA;
      mB = mnB;
      const uint32_t a0 = pack_bf16(sc[0][0], sc[0][1]);
      const uint32_t a1 = pack_bf16(sc[0][2], sc[0][3]);
      const uint32_t a2 = pack_bf16(sc[1][0], sc[1][1]);
      const uint32_t a3 = pack_bf16(sc[1][2], sc[1][3]);
      // V rows of score columns 2 t4, + 1 (b0) and 8 + 2 t4, + 1 (b1)
      uint32_t v0[VW], v1[VW], v2[VW], v3[VW];
      const int r0 = 16 * u + 2 * t4, vb = (L::VROW / 8) * g;
      row_words<L::VROW, VW>(slot + L::O_V, r0, vb, v0);
      row_words<L::VROW, VW>(slot + L::O_V, r0 + 1, vb, v1);
      row_words<L::VROW, VW>(slot + L::O_V, r0 + 8, vb, v2);
      row_words<L::VROW, VW>(slot + L::O_V, r0 + 9, vb, v3);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t b0, b1;
        if constexpr (VQ8) {
          // element d is byte d % 4 of word d / 4; pair the two rows
          const uint32_t sel = (d & 2) ? 0x7362 : 0x5140;
          const uint2 x = int8_to_bf16(__byte_perm(v0[d >> 2], v1[d >> 2], sel));
          const uint2 y = int8_to_bf16(__byte_perm(v2[d >> 2], v3[d >> 2], sel));
          b0 = (d & 1) ? x.y : x.x;
          b1 = (d & 1) ? y.y : y.x;
        } else {
          const uint32_t sel = (d & 1) ? 0x7632 : 0x5410;
          b0 = __byte_perm(v0[d >> 1], v1[d >> 1], sel);
          b1 = __byte_perm(v2[d >> 1], v3[d >> 1], sel);
        }
        mma_bf16(o[d], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // fold the warps of each row tile in split order, then write the chunk's
  // partial (acc, m, l); m is in base 2, -1e30 where no key was live
  cp_wait<0>();
  __syncthreads();
  {
    float* w = reinterpret_cast<float*>(sm) + warp * L::WSCR;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int c0 = ND * (2 * t4) + d, c1 = c0 + ND;
      w[g * HD + c0] = o[d][0];
      w[g * HD + c1] = o[d][1];
      w[(g + 8) * HD + c0] = o[d][2];
      w[(g + 8) * HD + c1] = o[d][3];
    }
    if (t4 == 0) {
      w[16 * HD + g] = mA; w[16 * HD + g + 8] = mB;
      w[16 * HD + 16 + g] = lA; w[16 * HD + 24 + g] = lB;
    }
  }
  __syncthreads();
  const float* scr = reinterpret_cast<const float*>(sm);
  const long long bh = (long long)b * a.Hkv + h;
  for (int idx = tid; idx < RT * 16 * HD; idx += D_NT) {
    const int r_t = idx / (16 * HD), rr = (idx / HD) % 16, c = idx % HD;
    const int row = rbase + 16 * r_t + rr;
    if (row >= TG) continue;
    const int ns = (D_WARPS - 1 - r_t) / RT + 1;
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s)
      mx = fmaxf(mx, scr[(r_t + RT * s) * L::WSCR + 16 * HD + rr]);
    float acc = 0.f, l = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < ns; ++s) {
        const float* w = scr + (r_t + RT * s) * L::WSCR;
        const float wt = exp2f(w[16 * HD + rr] - mx);
        acc += wt * w[rr * HD + c];
        l += wt * w[16 * HD + 16 + rr];
      }
    }
    const long long base = (bh * a.n_chunks + chunk) * TG + row;
    a.out[base * HD + c] = acc;
    if (c == 0) {
      a.m_part[base] = mx == -INFINITY ? NEG_INF : mx;
      a.l_part[base] = l;
    }
  }
}

// -- head dim 256, f32 / f16 K/V: the older body ---------------------------------
// One block of 4 warps per (b, h, 64-row tile), mma.sync m16n8k16 from
// padded shared-memory tiles converted to bf16 on load, synchronous tile
// loads; SPLIT: one chunk of keys per block, partials as decode_kernel's.
namespace legacy {

constexpr int BM = 64;          // query rows per block (4 warps x 16)
constexpr int THREADS = 128;

// 8 consecutive elements of a K / V row as bf16, 16 bytes
__device__ __forceinline__ uint4 load8_bf16(const void* base, int type,
                                            long long off) {
  uint4 r;
  if (type == T_BF16) {
    r = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(base) + off);
  } else if (type == T_F32) {
    const float4* p = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(base) + off);
    float4 a = p[0], b = p[1];
    r.x = pack_bf16(a.x, a.y);
    r.y = pack_bf16(a.z, a.w);
    r.z = pack_bf16(b.x, b.y);
    r.w = pack_bf16(b.z, b.w);
  } else if (type == T_F16) {
    uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __half*>(base) + off);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
    float2 f0 = __half22float2(h[0]), f1 = __half22float2(h[1]);
    float2 f2 = __half22float2(h[2]), f3 = __half22float2(h[3]);
    r.x = pack_bf16(f0.x, f0.y);
    r.y = pack_bf16(f1.x, f1.y);
    r.z = pack_bf16(f2.x, f2.y);
    r.w = pack_bf16(f3.x, f3.y);
  } else {                                       // int8 codes: exact in bf16
    uint2 u = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const int8_t*>(base) + off);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
    r.x = pack_bf16((float)c[0], (float)c[1]);
    r.y = pack_bf16((float)c[2], (float)c[3]);
    r.z = pack_bf16((float)c[4], (float)c[5]);
    r.w = pack_bf16((float)c[6], (float)c[7]);
  }
  return r;
}

template <int HD, int BN>
constexpr int smem_bytes() {
  return (BM + 2 * BN) * (HD + 8) * 2 + BN * 12;
}

template <int HD, int BN, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const Args a) {
  constexpr int LD = HD + 8;                     // padded smem row (bf16)
  constexpr int NT = BN / 8;                     // score n-tiles per warp
  constexpr int DT = HD / 8;                     // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;
  int* kp_s = reinterpret_cast<int*>(Vs + BN * LD);
  float* ks_s = reinterpret_cast<float*>(kp_s + BN);
  float* vs_s = ks_s + BN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int rtile = SPLIT ? blockIdx.x / a.n_chunks : blockIdx.x;
  const int chunk = SPLIT ? blockIdx.x % a.n_chunks : 0;
  const int row0 = rtile * BM;
  const int s_begin = chunk * a.chunk;
  const int s_end = SPLIT ? min(a.S, s_begin + a.chunk) : a.S;
  const int qb = a.qbase[b], ql = a.qlen[b];
  const int G = a.G, TG = a.TG;
  const bool causal = a.causal != 0;
  const bool has_ks = a.ks != nullptr, has_vs = a.vs != nullptr;

  // stage this block's query rows as bf16; rows past TG are zeros
  const float* qg = a.q + (long long)(b * a.Hkv + h) * TG * HD;
  for (int i = tid; i < BM * (HD / 4); i += THREADS) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < TG)
      x = *reinterpret_cast<const float4*>(qg + (long long)(row0 + r) * HD + c);
    uint2 p;
    p.x = pack_bf16(x.x, x.y);
    p.y = pack_bf16(x.z, x.w);
    *reinterpret_cast<uint2*>(Qs + r * LD + c) = p;
  }

  // this thread's two rows (g and g + 8 of the warp's 16)
  const int wr = warp * 16;
  const int rA = row0 + wr + g, rB = rA + 8;
  const int tA = rA / G, tB = rB / G;
  const int qposA = qb + tA, qposB = qb + tB;
  const bool okA = !causal || tA < ql, okB = !causal || tB < ql;
  // the warp has work if its first row is a real, live row
  const int wt0 = (row0 + wr) / G;
  const bool warp_live = (row0 + wr < TG) && (!causal || wt0 < ql);
  // the block's last live query position bounds the keys it can see
  const int rend = min(TG, row0 + BM);
  const int t_last = min((rend - 1) / G, ql - 1);
  const bool block_live = rend > row0 && (!causal || row0 / G < ql);
  const int qpos_max = qb + t_last;

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;

  const long long kbase = b * a.k_sb + h * a.k_sh;
  const long long vbase = b * a.v_sb + h * a.v_sh;
  const int* kp_row = a.kpos + b * a.kp_sb;

  for (int s0 = s_begin; block_live && s0 < s_end; s0 += BN) {
    __syncthreads();                         // previous tile fully consumed
    int any = 0;
    for (int i = tid; i < BN; i += THREADS) {
      const int col = s0 + i;
      int kp = -1;
      float ksv = 0.f, vsv = 0.f;
      if (col < s_end) {
        kp = kp_row[col];
        if (has_ks) ksv = a.ks[b * a.ks_sb + h * a.ks_sh + col];
        if (has_vs) vsv = a.vs[b * a.vs_sb + h * a.vs_sh + col];
      }
      kp_s[i] = kp;
      ks_s[i] = ksv;
      vs_s[i] = vsv;
      any |= (kp >= 0) && (!causal || kp <= qpos_max);
    }
    if (!__syncthreads_or(any)) continue;    // every key dead: adds zeros

    for (int i = tid; i < BN * (HD / 8); i += THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int col = s0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (col < s_end) {                     // tail rows stay exact zeros
        kv = load8_bf16(a.k, a.k_type, kbase + col * a.k_ss + c);
        vv = load8_bf16(a.v, a.v_type, vbase + col * a.v_ss + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv;
    }
    __syncthreads();
    if (!warp_live) continue;

    // scores S = Q K^T for the warp's 16 rows x BN keys
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      const __nv_bfloat16* qa = Qs + (wr + g) * LD + kk + 2 * tig;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * LD + kk + 2 * tig;
        mma_bf16(sc[n], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    // scale, q8 K fold, mask; the running max of each row
    float mxA = NEG_INF, mxB = NEG_INF;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + 2 * tig + (e & 1);
        const bool rowB = e >= 2;
        float s = sc[n][e] * a.scale;
        if (has_ks) s = s * ks_s[cl];
        const int kp = kp_s[cl];
        bool live = kp >= 0;
        if (causal) live = live && (rowB ? (kp <= qposB && okB)
                                         : (kp <= qposA && okA));
        s = live ? s : NEG_INF;
        sc[n][e] = s;
        if (rowB) mxB = fmaxf(mxB, s); else mxA = fmaxf(mxA, s);
      }
    }
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
    const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
    const float corrA = __expf(mA - mnA), corrB = __expf(mB - mnB);
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool rowB = e >= 2;
        const float s = sc[n][e];
        float p = s <= NEG_INF ? 0.f : __expf(s - (rowB ? mnB : mnA));
        if (rowB) sumB += p; else sumA += p;
        if (has_vs) p = p * vs_s[n * 8 + 2 * tig + (e & 1)];
        sc[n][e] = p;
      }
    }
    sumA += __shfl_xor_sync(0xffffffffu, sumA, 1);
    sumA += __shfl_xor_sync(0xffffffffu, sumA, 2);
    sumB += __shfl_xor_sync(0xffffffffu, sumB, 1);
    sumB += __shfl_xor_sync(0xffffffffu, sumB, 2);
    lA = lA * corrA + sumA;
    lB = lB * corrB + sumB;
    mA = mnA;
    mB = mnB;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= corrA; o[d][1] *= corrA;
      o[d][2] *= corrB; o[d][3] *= corrB;
    }

    // O += P V: the score fragments of two n-tiles are one A fragment
    const unsigned short* Vu = reinterpret_cast<const unsigned short*>(Vs);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t a0 = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      const uint32_t a1 = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      const uint32_t a2 = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      const int k0 = 16 * j + 2 * tig;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int dc = d * 8 + g;
        const uint32_t b0 = (uint32_t)Vu[k0 * LD + dc]
                            | ((uint32_t)Vu[(k0 + 1) * LD + dc] << 16);
        const uint32_t b1 = (uint32_t)Vu[(k0 + 8) * LD + dc]
                            | ((uint32_t)Vu[(k0 + 9) * LD + dc] << 16);
        mma_bf16(o[d], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // epilogue: rows past TG are not written
  const long long bh = (long long)b * a.Hkv + h;
  if (SPLIT) {
    // the partials' m in base 2, as the combine reads them
    mA = mA <= NEG_INF ? NEG_INF : mA * LOG2E;
    mB = mB <= NEG_INF ? NEG_INF : mB * LOG2E;
    const long long base = (bh * a.n_chunks + chunk) * TG;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + 2 * tig;
      if (rA < TG)
        *reinterpret_cast<float2*>(a.out + (base + rA) * HD + c) =
            make_float2(o[d][0], o[d][1]);
      if (rB < TG)
        *reinterpret_cast<float2*>(a.out + (base + rB) * HD + c) =
            make_float2(o[d][2], o[d][3]);
    }
    if (tig == 0) {
      if (rA < TG) { a.m_part[base + rA] = mA; a.l_part[base + rA] = lA; }
      if (rB < TG) { a.m_part[base + rB] = mB; a.l_part[base + rB] = lB; }
    }
  } else {
    const float iA = lA > 0.f ? 1.f / lA : 0.f;
    const float iB = lB > 0.f ? 1.f / lB : 0.f;
    float* ob = a.out + bh * TG * HD;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + 2 * tig;
      if (rA < TG)
        *reinterpret_cast<float2*>(ob + (long long)rA * HD + c) =
            lA > 0.f ? make_float2(o[d][0] * iA, o[d][1] * iA)
                     : make_float2(0.f, 0.f);
      if (rB < TG)
        *reinterpret_cast<float2*>(ob + (long long)rB * HD + c) =
            lB > 0.f ? make_float2(o[d][2] * iB, o[d][3] * iB)
                     : make_float2(0.f, 0.f);
    }
  }
}

}  // namespace legacy

// out = sum_j 2^(m_j - m*) acc_j / sum_j 2^(m_j - m*) l_j (m in base 2), or
// 0 where the denominator is 0; chunks in order. One block per (row,
// b * Hkv + h), one thread per column.
__global__ void fd_combine(const float* __restrict__ acc,
                           const float* __restrict__ m,
                           const float* __restrict__ l,
                           float* __restrict__ out, int ns, int TG, int HD) {
  const int r = blockIdx.x;
  const long long bh = blockIdx.y;
  const int d = threadIdx.x;
  const float* mp = m + bh * ns * TG + r;
  const float* lp = l + bh * ns * TG + r;
  float mg = NEG_INF;
  for (int j = 0; j < ns; ++j) mg = fmaxf(mg, mp[(long long)j * TG]);
  float lg = 0.f, o = 0.f;
  for (int j = 0; j < ns; ++j) {
    const float w = exp2f(mp[(long long)j * TG] - mg);
    lg += w * lp[(long long)j * TG];
    o += w * acc[((bh * ns + j) * TG + r) * HD + d];
  }
  out[(bh * TG + r) * HD + d] = lg > 0.f ? o / lg : 0.f;
}

template <typename K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess) done = true;
  return e;
}

template <int HD, bool KQ8, bool VQ8>
cudaError_t launch_prefill(const Args& a, int B, cudaStream_t st) {
  using L = PLayout<HD, KQ8, VQ8>;
  const int n_tiles = (a.S + P_BN - 1) / P_BN;
  const int bytes = L::FIXED + 16 + (3 * n_tiles + 15) / 16 * 16 + 1024;
  if (n_tiles > 0x7FFF || bytes > SMEM_MAX) return cudaErrorInvalidValue;
  static bool done = false;
  cudaError_t e = allow_smem(prefill_kernel<HD, KQ8, VQ8>, done);
  if (e != cudaSuccess) return e;
  dim3 grid((a.TG + P_BM - 1) / P_BM, a.Hkv, B);
  prefill_kernel<HD, KQ8, VQ8><<<grid, P_NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int HD, bool KQ8, bool VQ8>
cudaError_t launch_decode(const Args& a, int B, cudaStream_t st) {
  using L = DLayout<HD, KQ8, VQ8>;
  const int n_ct = (a.chunk + D_BN - 1) / D_BN;
  const int bytes = L::FIXED + 16 + (3 * n_ct + 15) / 16 * 16;
  if (n_ct > 0x7FFF || bytes > SMEM_MAX) return cudaErrorInvalidValue;
  static bool done = false;
  cudaError_t e = allow_smem(decode_kernel<HD, KQ8, VQ8>, done);
  if (e != cudaSuccess) return e;
  dim3 grid((a.TG + D_ROWS - 1) / D_ROWS * a.n_chunks, a.Hkv, B);
  decode_kernel<HD, KQ8, VQ8><<<grid, D_NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int HD, int BN, bool SPLIT>
cudaError_t launch_legacy(const Args& a, int B, cudaStream_t st) {
  constexpr int bytes = legacy::smem_bytes<HD, BN>();
  static bool done = false;
  cudaError_t e = allow_smem(legacy::flash_kernel<HD, BN, SPLIT>, done);
  if (e != cudaSuccess) return e;
  const int rt = (a.TG + legacy::BM - 1) / legacy::BM;
  dim3 grid(SPLIT ? rt * a.n_chunks : rt, a.Hkv, B);
  legacy::flash_kernel<HD, BN, SPLIT><<<grid, legacy::THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int HD, bool SPLIT>
cudaError_t launch_new(const Args& a, int B, cudaStream_t st) {
  const bool kq = a.k_type == T_I8, vq = a.v_type == T_I8;
  if (SPLIT) {
    if (kq && vq) return launch_decode<HD, true, true>(a, B, st);
    if (kq) return launch_decode<HD, true, false>(a, B, st);
    if (vq) return launch_decode<HD, false, true>(a, B, st);
    return launch_decode<HD, false, false>(a, B, st);
  }
  if (kq && vq) return launch_prefill<HD, true, true>(a, B, st);
  if (kq) return launch_prefill<HD, true, false>(a, B, st);
  if (vq) return launch_prefill<HD, false, true>(a, B, st);
  return launch_prefill<HD, false, false>(a, B, st);
}

// head dims 64 and 128 with bf16 or int8 K/V run the kernels above; head
// dim 256 and f32 / f16 K/V the older body
template <bool SPLIT>
cudaError_t dispatch(int hd, const Args& a, int B, cudaStream_t st) {
  auto fits = [](int t) { return t == T_BF16 || t == T_I8; };
  const bool hopper = fits(a.k_type) && fits(a.v_type);
  switch (hd) {
    case 64:
      return hopper ? launch_new<64, SPLIT>(a, B, st)
                    : launch_legacy<64, 64, SPLIT>(a, B, st);
    case 128:
      return hopper ? launch_new<128, SPLIT>(a, B, st)
                    : launch_legacy<128, 64, SPLIT>(a, B, st);
    case 256: return launch_legacy<256, 32, SPLIT>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// split = 0: flash_attention, out (B, Hkv, TG, hd) f32.
// split = 1: flash_decode over n_chunks chunks of `chunk` keys (a multiple
// of 16); acc_ws (B, Hkv, n_chunks, TG, hd), m_ws / l_ws (B, Hkv,
// n_chunks, TG), then the combine into out. Strides are in elements; the
// last stride of every tensor is 1, K / V rows start 16-byte aligned.
// ks / vs may be null. Returns the first CUDA error (0 = launched).
extern "C" int tl_flash(int hd, int split, const float* q,
                        const void* k, int k_type, long long k_sb,
                        long long k_sh, long long k_ss,
                        const void* v, int v_type, long long v_sb,
                        long long v_sh, long long v_ss,
                        const int* kpos, long long kp_sb,
                        const int* qbase, const int* qlen,
                        const float* ks, long long ks_sb, long long ks_sh,
                        const float* vs, long long vs_sb, long long vs_sh,
                        int B, int Hkv, int TG, int S, int G, int causal,
                        float scale, int chunk, int n_chunks,
                        float* acc_ws, float* m_ws, float* l_ws, float* out,
                        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Args a;
  a.q = q; a.k = k; a.v = v; a.kpos = kpos; a.qbase = qbase; a.qlen = qlen;
  a.ks = ks; a.vs = vs;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss; a.kp_sb = kp_sb;
  a.ks_sb = ks_sb; a.ks_sh = ks_sh; a.vs_sb = vs_sb; a.vs_sh = vs_sh;
  a.k_type = k_type; a.v_type = v_type;
  a.Hkv = Hkv; a.TG = TG; a.S = S; a.G = G; a.causal = causal;
  a.scale = scale;
  if (TG <= 0 || B <= 0) return 0;
  if (!split) {
    a.chunk = S; a.n_chunks = 1;
    a.out = out; a.m_part = nullptr; a.l_part = nullptr;
    return (int)dispatch<false>(hd, a, B, st);
  }
  if (chunk <= 0 || chunk % 16 != 0 || n_chunks != (S + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  a.chunk = chunk; a.n_chunks = n_chunks;
  a.out = acc_ws; a.m_part = m_ws; a.l_part = l_ws;
  cudaError_t e = dispatch<true>(hd, a, B, st);
  if (e != cudaSuccess) return (int)e;
  fd_combine<<<dim3(TG, B * Hkv), hd, 0, st>>>(acc_ws, m_ws, l_ws, out,
                                               n_chunks, TG, hd);
  return (int)cudaGetLastError();
}
