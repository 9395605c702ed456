"""Where the time of the decode megakernel goes: build copies of
csrc/mega_decode.cu (with the csrc headers it includes) with one part
removed and time them beside the source as it is, on the card, at the
first megakernel case of chip_smoke.py's phase 3c: LLaMA-7B widths (dim
4096, 32 heads of 128, ffn 11008), Q4_0, 2 layers, a bf16 cache of 1024
cells of which 640 are live.

    python -m tpulamm_torch.tools.mega_ablation [--layers 2] [--reps 20]

The ablated kernels compute wrong results; only their times are read.
Each build runs in its own nvcc process, all at once
(flash_ablation.build); the times are the median of `reps` launches with
the L2 flushed (tools/timing.py), in the order as-is, ablations,
ablations reversed, as-is, and each line gives both readings. It also
builds a TIMELINE copy, which stamps %globaltimer at each grid barrier
and at the source's TL_MARK points, and prints for each phase of each
layer when the first and the last block reach the barrier after it.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.ops import kernels
from tpulamm_torch.ops import mega_decode as MD
from tpulamm_torch.ops.qtensor import QTensor
from tpulamm_torch.ops.rope import RopeParams
from tpulamm_torch.tools.flash_ablation import build
from tpulamm_torch.tools.synth import random_blocks
from tpulamm_torch.tools.timing import device_label, time_ms, time_samples

# name -> (what is removed, [(text in the sources, replacement)])
_NO_ATTN = ("    attend(a, l, qpos, cell, kv[l & 1][0], kv[l & 1][1], at, "
            "buf);\n", "")
_NO_PRODUCTS = [("  Planes pw[NW];                          // in registers\n",
                 "  return;\n  Planes pw[NW];\n")]
ABLATIONS = {
    "no_attention": ("phase B (rope, attention, the new K / V rows)",
                     [_NO_ATTN]),
    "products_loads_only": ("the products' code conversion, MMAs and "
                            "scaling (their code and scale loads remain)", [
        ("        step_math<QT>(st.q, st, cur.sub, e0, xs, s16, t, tot[q]);",
         "      { const Step<QT>& r = st; uint32_t f = __float_as_uint("
         "r.s[0].x + r.s[1].w); for (int k = 0; k < 4; ++k) f ^= r.q[k].x ^ "
         "r.q[k].y ^ r.q[k].z ^ r.q[k].w; tot[q][0] = __uint_as_float("
         "__float_as_uint(tot[q][0]) ^ f); }")]),
    "no_products": ("the four products (staging, loads, math, split sums)",
                    _NO_PRODUCTS),
    "barriers_only": ("everything but the grid barriers",
                      [_NO_ATTN, *_NO_PRODUCTS]),
}

# a copy of the kernel as it is that stamps %globaltimer at each grid
# barrier (read back through tl_mega_stamps): the first and the last
# block's arrival, by generation, and block 0's exit, in order
TIMELINE = [
    ("#define TL_START()\n#define TL_MARK(id)\n",
     "__device__ unsigned long long tl_mark_ns[1024], tl_exit_ns[1024], "
     "tl_first[1024], tl_last[1024];\n"
     "__device__ unsigned int tl_mark_id[1024], tl_mark_n, tl_exit_n;\n"
     "__shared__ unsigned int tl_mark_s, tl_exit_s;\n"
     "__device__ __forceinline__ unsigned long long tl_now() {\n"
     "  unsigned long long ns;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ns));\n"
     "  return ns;\n}\n"
     "#define TL_START() do { if (threadIdx.x == 0) tl_mark_s = tl_exit_s = 0; "
     "} while (0)\n"
     "#define TL_MARK(id) do { if (blockIdx.x == 0 && threadIdx.x == 0) { "
     "const unsigned long long ns_ = tl_now(); const unsigned k_ = "
     "tl_mark_s++ & 1023; tl_mark_id[k_] = (id); tl_mark_ns[k_] = ns_; "
     "tl_mark_n = tl_mark_s; } } while (0)\n"),
    ("    const unsigned int g = *gen;\n",
     "    const unsigned int g = *gen;\n"
     "    { const unsigned long long ns = tl_now();\n"
     "      atomicMin(&tl_first[g & 1023], ns);\n"
     "      atomicMax(&tl_last[g & 1023], ns); }\n"),
    ("        if (++spins == (1u << 28)) __trap();\n      }\n    }\n"
     "    __threadfence();\n  }\n  __syncthreads();\n}",
     "        if (++spins == (1u << 28)) __trap();\n      }\n    }\n"
     "    __threadfence();\n  }\n  __syncthreads();\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    tl_exit_ns[tl_exit_s++ & 1023] = tl_now();\n"
     "    tl_exit_n = tl_exit_s;\n"
     "  }\n}"),
    ('extern "C" int tl_mega_blocks(long long kmax, int* blocks) {',
     'extern "C" int tl_mega_stamps(unsigned long long* out, unsigned int* id, '
     "unsigned int* n) {\n"
     "  static unsigned long long ones[1024], zeros[1024];\n"
     "  for (int i = 0; i < 1024; ++i) ones[i] = ~0ull;\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(n, tl_exit_n, 4);\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n + 1, tl_mark_n, 4);\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, tl_exit_ns, 8192);\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 1024, tl_first, 8192);\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 2048, tl_last, 8192);\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 3072, tl_mark_ns, 8192);\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(id, tl_mark_id, 4096);\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tl_first, ones, 8192);\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tl_last, zeros, 8192);\n"
     "  return (int)e;\n}\n\n"
     'extern "C" int tl_mega_blocks(long long kmax, int* blocks) {'),
]
PHASES = "ABCDE"


def timeline(lib, c, device, reps: int = 10) -> dict[str, list[float]]:
    """For each phase of each layer over `reps` steps with the L2 flushed
    (TIMELINE build `lib`), us from block 0's exit of the barrier before
    it to the first block's arrival at the barrier after it ("first"), to
    the last block's ("last"), and to block 0's exit ("exit"); and for
    each TL_MARK of block 0 (thread 0) in a phase, us from the exit
    before it ("mark")."""
    import ctypes
    lib.tl_mega_stamps.argtypes = [ctypes.c_void_p] * 3
    lib.tl_mega_stamps.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 4096)()
    ids = (ctypes.c_uint * 1024)()
    n = (ctypes.c_uint * 2)()
    kernels._loaded["mega_decode"] = lib
    MD._blocks.cache_clear()
    got: dict[str, list[float]] = {}
    per = 5 * c["mega"].spec.n_layers                   # barriers a step
    for _ in range(reps):
        time_samples(lambda: step(MD.mega_decode_layers, c), device, 1)
        torch.cuda.synchronize(device)
        kernels.check(lib.tl_mega_stamps(buf, ids, n), "stamps")
        exits = list(buf[:per])                  # the last launch's
        arr = sorted((buf[2048 + k], buf[1024 + k]) for k in range(1024)
                     if buf[2048 + k] != 0)[-per:]    # (last, first)
        for k in range(1, per):
            name = f"{PHASES[(k - 1) % 5]}{(k - 1) // 5}"
            for key, v in (("first", arr[k][1]), ("last", arr[k][0]),
                           ("exit", exits[k])):
                got.setdefault(f"{name} {key}", []).append(
                    (v - exits[k - 1]) / 1e3)
        for j in range(min(n[1], 1024)):
            t = buf[3072 + j]
            k = sum(e <= t for e in exits)       # barriers behind the mark
            if 1 <= k < per:
                name = f"{PHASES[(k - 1) % 5]}{(k - 1) // 5}"
                got.setdefault(f"mark {name}.{ids[j]}", []).append(
                    (t - exits[k - 1]) / 1e3)
    return got


def inputs(rng, device, *, dim: int = 4096, ffn: int = 11008,
           n_head: int = 32, n_kv: int | None = None, n_layers: int = 2,
           span: int = 1024, live: int = 640, qtype=GGMLType.Q4_0,
           rope_kind: str = "norm") -> dict:
    """One megakernel step on a random llama stack: each layer's fused
    QTensors (random blocks), norms near 1, a bf16 cache of `span` cells
    whose first `live` hold positions 0.. (the rest empty), x ~ N(0, 1), the
    position and cell `live`. Defaults: phase 3c's first case."""
    n_kv = n_kv or n_head
    hd = dim // n_head
    cfg = ModelConfig(arch="llama", dim=dim, n_layers=n_layers,
                      n_heads=n_head, n_kv_heads=n_kv, ffn_dim=ffn,
                      rope=RopeParams(n_rot=hd, kind=rope_kind))

    def q(n, k):
        return QTensor.from_gguf_raw(random_blocks(qtype, n, k, rng), qtype,
                                     (n, k), device=device)

    def norm():
        return torch.from_numpy((1.0 + 0.1 * rng.standard_normal(dim)).astype(
            np.float32)).to(device)
    layers = [dict(wqkv_fused=q((n_head + 2 * n_kv) * hd, dim),
                   wo=q(dim, n_head * hd), wgateup_fused=q(2 * ffn, dim),
                   w_down=q(dim, ffn), attn_norm=norm(), ffn_norm=norm())
              for _ in range(n_layers)]
    mega = MD.build_mega({"layers": layers}, cfg)
    kv = [torch.from_numpy(rng.standard_normal((1, n_kv, span, hd),
                                               dtype=np.float32)
                           ).to(device).to(torch.bfloat16)
          for _ in range(2 * n_layers)]
    kpos = torch.full((1, span), -1, dtype=torch.int32, device=device)
    kpos[0, :live] = torch.arange(live, dtype=torch.int32, device=device)
    lanes = MD.rope_lane_vectors(mega.rope, hd, n_head, n_kv,
                                 torch.tensor([live], device=device))
    x = torch.from_numpy(rng.standard_normal((1, dim), dtype=np.float32))
    # the position and the cell as the engine's step graphs pass them:
    # int32 device words, made once (a host int would add a copy a call)
    words = torch.tensor([live, live], dtype=torch.int32, device=device)
    return dict(mega=mega, x=x.to(device), pos=live, words=words, kpos=kpos,
                k=kv[:n_layers], v=kv[n_layers:], lanes=lanes)


def step(fn, c):
    """One decode step of case c through fn (mega_decode_layers or its
    plain version), position and cell in the case's device words."""
    w = c["words"]
    return fn(c["mega"], c["x"], w[:1], w[1:], c["kpos"], c["k"], c["v"],
              *c["lanes"])


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register / spill lines of mega_decode_kernel in an nvcc log,
    each spill line after the function it belongs to."""
    out, entry = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = "mega_decode_kernel" in line
        elif entry and re.search(r"registers|spill|Function properties", line):
            out.append(line.strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mega_ablation: needs a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"device: {device_label(device)}")
    names = ["as_is", *ABLATIONS]
    libs = build(names + ["timeline"],
                 {**ABLATIONS, "timeline": ("", TIMELINE)}, "mega_decode")
    log = (kernels.BUILD_DIR / "ablate_mega_decode_as_is" / "nvcc.log")
    for line in ptxas_lines(log.read_text()):
        print(f"ptxas (as_is): {line}")
    c = inputs(np.random.default_rng(1234), device, n_layers=args.layers)
    order = names + names[:0:-1] + names[:1]
    got: dict[str, list[float]] = {}
    for name in order:
        kernels._loaded["mega_decode"] = libs[name]
        MD._blocks.cache_clear()        # an ablated kernel may fit more
        got.setdefault(name, []).append(time_ms(
            lambda: step(MD.mega_decode_layers, c), device, args.reps))
    kernels._loaded["mega_decode"] = libs["as_is"]
    MD._blocks.cache_clear()
    kmax = max(c["mega"].spec.dim, c["mega"].spec.ffn)
    print(f"grid: {MD._blocks(device, kmax)} blocks")
    ph = timeline(libs["timeline"], c, device, args.reps)
    print("phases (us from block 0's exit of the barrier before, median "
          "of the steps: first / last block at the barrier after, "
          "block 0's exit): " + " | ".join(
              f"{k} {np.median(ph[k + ' first']):.2f} / "
              f"{np.median(ph[k + ' last']):.2f} / "
              f"{np.median(ph[k + ' exit']):.2f}"
              for k in dict.fromkeys(x.split()[0] for x in ph
                                     if not x.startswith("mark"))),
          flush=True)
    print("marks (us after the barrier exit before, block 0): " + " | ".join(
        f"{k[5:]} {np.median(v):.2f}" for k, v in ph.items()
        if k.startswith("mark")), flush=True)
    kernels._loaded.pop("mega_decode")
    MD._blocks.cache_clear()
    print(f"mega_decode Q4_0 LLaMA-7B {args.layers} layers span=1024 "
          "live=640 (ms): " + " | ".join(
              f"{n} {np.mean(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
              for n, v in got.items()), flush=True)
    for name, (what, _) in ABLATIONS.items():
        print(f"{name}: without {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
