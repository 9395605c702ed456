// ffn_fused.cu -- the gated FFN of a few rows in one launch:
//
//   out (M, dim) f32 = (act(x Wg) * (x Wu)) Wd,   M <= 16
//
// Replaces tpulamm/ops/pallas_ffn.py::ffn_fused / _ffn_call, the TPU
// kernel that keeps the (M, ffn) intermediate on chip. x, the gate and up
// sums and `mid` stay f32, as there; Wg | Wu is the fused (2 ffn, dim) mm
// QTensor (gate columns first) and Wd the (dim, ffn) one, each in any of
// the six formats.
//
// What bounds it on an H100: the plane bytes of the three matrices, read
// once (LLaMA-7B Q4_0: 76 MB, ~23 us at 3.35 TB/s); the operations,
// 6 M dim ffn, are far below the f32 rate.
//
// Design: one cooperative launch, a grid of every SM's resident blocks.
//   phase A: the gate|up product as gemv_stage items over the ffn columns
//     (each item computes gate and up of the same 128 columns, so its
//     epilogue writes mid = act(gate) * up) into a device scratch;
//   a grid barrier (grid_sync: every block is resident under a
//     cooperative launch, so the spin cannot deadlock);
//   phase B: the down product over mid, items over the dim columns.
// Both phases cut K into split sums that meet in a fixed order
// (gemv_stage.cuh), so two runs give the same bits.

#include "gemv_stage.cuh"

namespace {

using namespace tlg;

struct FfnArgs {
  const float* x;                // (M, dim)
  Planes gate, up, down;
  float* mid;                    // (M, ffn) scratch
  float* out;                    // (M, dim)
  float* partial;                // (max ks, NW, M, N) scratch
  unsigned int* counters;        // zeroed, one per (column tile, row tile)
  unsigned int* bar;             // 2 zeroed words
  int qt_gu, qt_dn, M, dim, ffn, act, ks_a, ks_b;
};

template <int MT> union FfnSmem {
  StageSmem<MT, 2> a;           // phase A: gate and up
  StageSmem<MT, 1> b;           // phase B: down
};

template <int MT>
__global__ void __launch_bounds__(NT, 2) ffn_fused_kernel(FfnArgs a) {
  __shared__ __align__(16) FfnSmem<MT> sm;
  const int M = a.M, dim = a.dim, ffn = a.ffn;

  // phase A: mid = act(x Wg) * (x Wu)
  const Planes gu[2] = {a.gate, a.up};
  auto stage_x = [&](float* xs, int k0, int m0) {
    for (int i = threadIdx.x; i < MT * SLICE; i += NT) {
      const int m = i / SLICE, k = k0 + i % SLICE;
      xs[i] = (m0 + m < M && k < dim) ? __ldg(a.x + (size_t)(m0 + m) * dim + k)
                                      : 0.f;
    }
  };
  auto epi_a = [&](int m, int n, const float (&v)[2]) {
    a.mid[(size_t)m * ffn + n] = act_fn(v[0], a.act) * v[1];
  };
  TLG_SWITCH_FMT(a.qt_gu, (gemv_stage<QT, MT, 2>(sm.a, gu, ffn, dim, M,
                                                 a.ks_a, stage_x, epi_a,
                                                 a.partial, a.counters)))
  grid_sync(a.bar);

  // phase B: out = mid Wd
  const Planes dn[1] = {a.down};
  auto stage_mid = [&](float* xs, int k0, int m0) {
    for (int i = threadIdx.x; i < MT * SLICE; i += NT) {
      const int m = i / SLICE, k = k0 + i % SLICE;
      xs[i] = (m0 + m < M && k < ffn)
                  ? __ldcg(a.mid + (size_t)(m0 + m) * ffn + k) : 0.f;
    }
  };
  auto epi_b = [&](int m, int n, const float (&v)[1]) {
    a.out[(size_t)m * dim + n] = v[0];
  };
  TLG_SWITCH_FMT(a.qt_dn, (gemv_stage<QT, MT, 1>(sm.b, dn, dim, ffn, M,
                                                 a.ks_b, stage_mid, epi_b,
                                                 a.partial, a.counters)))
}

constexpr int MAX_BLOCKS_PER_SM = 2;

const void* kernel_for(int M) {
  return M == 1 ? (const void*)ffn_fused_kernel<1>
                : (const void*)ffn_fused_kernel<4>;
}

}  // namespace

// The grid of the launch for M rows (blocks, written to *blocks), from the
// card's SM count and the kernel's occupancy; an error code when the card
// cannot run a cooperative launch of it.
extern "C" int tl_ffn_fused_blocks(int M, int* blocks) {
  return coop_blocks(kernel_for(M), 0, MAX_BLOCKS_PER_SM, blocks);
}

// x (M, dim) f32; gate|up planes (2 ffn columns, K = dim) as qa/qb/sa/sb,
// down planes (dim columns, K = ffn); mid (M, ffn) and partial
// (max(ks_a * 2 * M * ffn, ks_b * M * dim)) f32 scratch; counters
// (ffn / 128 * ceil(M / 4) zeroed uint32) and bar (2 zeroed uint32), left
// zeroed; act 0 silu, 1 gelu (tanh), 2 relu. `blocks` must be what
// tl_ffn_fused_blocks gave. Returns the launch's CUDA error code.
extern "C" int tl_ffn_fused(int qt_gu, int qt_dn, const void* x,
                            const void* gqa, const void* gqb, const void* gsa,
                            const void* gsb, const void* dqa, const void* dqb,
                            const void* dsa, const void* dsb, void* mid,
                            void* out, void* partial, void* counters,
                            void* bar, int M, int dim, int ffn, int act,
                            int ks_a, int ks_b, int blocks, void* stream) {
  if (M <= 0 || M > 16 || dim % 256 || ffn % 256 || dim % TILE_N ||
      !known_format(qt_gu) || !known_format(qt_dn) || ks_a < 1 || ks_b < 1 ||
      ks_a > (dim + SLICE - 1) / SLICE || ks_b > (ffn + SLICE - 1) / SLICE ||
      act < 0 || act > 2 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  FfnArgs a;
  a.x = (const float*)x;
  a.gate = Planes{(const uint8_t*)gqa, (const uint8_t*)gqb, gsa, gsb, 2 * ffn, 0};
  a.up = Planes{(const uint8_t*)gqa, (const uint8_t*)gqb, gsa, gsb, 2 * ffn, ffn};
  a.down = Planes{(const uint8_t*)dqa, (const uint8_t*)dqb, dsa, dsb, dim, 0};
  a.mid = (float*)mid;
  a.out = (float*)out;
  a.partial = (float*)partial;
  a.counters = (unsigned int*)counters;
  a.bar = (unsigned int*)bar;
  a.qt_gu = qt_gu;
  a.qt_dn = qt_dn;
  a.M = M;
  a.dim = dim;
  a.ffn = ffn;
  a.act = act;
  a.ks_a = ks_a;
  a.ks_b = ks_b;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(kernel_for(M), dim3(blocks),
                                          dim3(NT), args, 0,
                                          (cudaStream_t)stream);
}
