"""Where the time of the fused decode FFN goes: build copies of
csrc/ffn_fused.cu (with the csrc headers it includes) with one part
removed and time them beside the source as it is, on the card, at the
LLaMA-7B FFN (dim 4096 -> ffn 11008 -> dim 4096), Q4_0, M = 1, 4, 8, 16.

    python -m tpulamm_torch.tools.ffn_ablation [--reps 20] [--as-is-only]

Each time is the median of `reps` calls with the L2 flushed
(tools/timing.py), in the order as-is, ablations, ablations reversed,
as-is, and each line gives both readings. The ablated kernels compute
wrong results; only their times are read. Each build runs in its own
nvcc process, all at once (flash_ablation.build). Besides the ablations
it times an empty launch (torch.cuda._sleep(0)) under the same harness:
the fixed cost that every timed call carries; the library (two bf16
torch.matmul and silu on weights dequantized beforehand, timed here
only); and prints the bound at each M. --as-is-only builds and times the
source as it is (no ablation texts), so the tool can time another
checkout's kernel (copy this file into that checkout). It measures the
kernel of its own checkout only: its texts are this kernel's. Needs a
GPU.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import ffn_fused as FF
from tpulamm_torch.ops import kernels
from tpulamm_torch.ops.layers import silu
from tpulamm_torch.ops.qtensor import QTensor, dequant_mm
from tpulamm_torch.tools.flash_ablation import build
from tpulamm_torch.tools.synth import random_blocks
from tpulamm_torch.tools.timing import device_label, time_ms

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS = 989e12

# name -> (what differs, [(text in the sources, replacement)])
ABLATIONS = {
    "loads_only": ("without the products' fragments, MMAs and scaling (their "
                   "plane and scale copies and the window remain, each "
                   "thread's share of a stage XORed into the sums)", [
        ("      step_math<QT, MT>(ring + (j % R) * S::BYTES, w, 256 * sp.wc(cur.c), "
         "cur.s, lcol,\n                        lane, acc);",
         "    { const uint4* q = reinterpret_cast<const uint4*>(ring + (j % R) * "
         "S::BYTES) + threadIdx.x; uint32_t f = (uint32_t)(cur.c + w.stride); "
         "for (int k = 0; k < S::BYTES / 4096; ++k) f ^= q[256 * k].x ^ "
         "q[256 * k].y ^ q[256 * k].z ^ q[256 * k].w; acc[0][0] = "
         "__uint_as_float(__float_as_uint(acc[0][0]) ^ f); }")]),
    "no_combine": ("without the split-K combines (the partials are written; "
                   "no thread adds them; the barriers remain)", [
        ("  ffn_combine<true>(&sa, a.qt_gu == Q8_0 ? 8 : 4);    // gu = x Wg | x Wu\n",
         "  // ffn_combine<true>\n"),
        ("  ffn_combine<false>(&sa, a.qt_dn == Q8_0 ? 8 : 4);\n", "")]),
    "phase_a_only": ("phase A alone (its products, a barrier and its combine; "
                     "the kernel returns before phase B)", [
        ("  ffn_combine<true>(&sa, a.qt_gu == Q8_0 ? 8 : 4);    // gu = x Wg | x Wu\n",
         "  ffn_combine<true>(&sa, a.qt_gu == Q8_0 ? 8 : 4);\n  return;\n")]),
    "phase_b_only": ("phase B without phase A's products and combine (the "
                     "barriers remain)", [
        ("  TLG_SWITCH_FMT(a.qt_gu, (ffn_prefetch<QT, MT, true>(&sa, smem, bars)))\n"
         "  TLG_SWITCH_FMT(a.qt_gu, (ffn_phase<QT, MT, true>(&sa, smem, bars)))\n",
         "  if (a.M < 0) TLG_SWITCH_FMT(a.qt_gu, (ffn_prefetch<QT, MT, true>(&sa, "
         "smem, bars)))\n  if (a.M < 0) TLG_SWITCH_FMT(a.qt_gu, (ffn_phase<QT, MT, "
         "true>(&sa, smem, bars)))\n"),
        ("  ffn_combine<true>(&sa, a.qt_gu == Q8_0 ? 8 : 4);    // gu = x Wg | x Wu\n",
         "  if (a.M < 0) ffn_combine<true>(&sa, 4);\n")]),
}
DIM, FFN = 4096, 11008                     # LLaMA-7B
MS = (1, 4, 8, 16)


def inputs(rng, device, qtype=GGMLType.Q4_0, dim=DIM, ffn=FFN, ms=MS):
    """(gate|up (2 ffn, dim), down (dim, ffn), {m: x (m, dim) f32}):
    random blocks of `qtype` and x ~ N(0, 1), from rng."""
    gu = QTensor.from_gguf_raw(random_blocks(qtype, 2 * ffn, dim, rng), qtype,
                               (2 * ffn, dim), device=device)
    dn = QTensor.from_gguf_raw(random_blocks(qtype, dim, ffn, rng), qtype,
                               (dim, ffn), device=device)
    xs = {m: torch.from_numpy(rng.standard_normal((m, dim), dtype=np.float32)
                              ).to(device) for m in ms}
    return gu, dn, xs


def bound_ms(m: int, gu: QTensor, dn: QTensor) -> tuple[float, float]:
    """(bytes ms, operations ms) of one fused FFN of m rows: the planes, x
    and the output once at the HBM rate; 2 m dim (2 ffn) + 2 m ffn dim
    operations on the bf16 tensor cores, twice (x and mid as bf16 hi +
    lo)."""
    dim, ffn = dn.mm_dims
    nbytes = gu.n_bytes + dn.n_bytes + 2 * m * dim * 4
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2 * 6.0 * m * dim * ffn / PEAK_BF16_OPS * 1e3)


def library(x: torch.Tensor, gu: QTensor, dn: QTensor):
    """The library's version of the same function: two bf16 torch.matmul
    and silu on weights dequantized beforehand (timed only; the port
    never calls it)."""
    ffn = dn.mm_dims[1]
    wg, wd = dequant_mm(gu, torch.bfloat16), dequant_mm(dn, torch.bfloat16)
    xb = x.to(torch.bfloat16)

    def run():
        g = torch.matmul(xb, wg)
        return torch.matmul(silu(g[:, :ffn]) * g[:, ffn:], wd)
    return run


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register / spill lines of the FFN kernel's entries (and the
    functions they call) in an nvcc log, each prefixed with its mangled
    name."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([^' ]+)'?", line)
        if m:
            entry = m.group(1) if "ffn" in m.group(1) else None
        elif entry and re.search(r"registers|spill", line):
            out.append(f"{entry}: {line.strip()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--as-is-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ffn_ablation: needs a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"device: {device_label(device)}")
    ablations = {} if args.as_is_only else ABLATIONS
    names = ["as_is", *ablations]
    libs = build(names, ablations, "ffn_fused")
    log = kernels.BUILD_DIR / "ablate_ffn_fused_as_is" / "nvcc.log"
    for line in ptxas_lines(log.read_text()):
        print(f"ptxas (as_is): {line}")
    gu, dn, xs = inputs(np.random.default_rng(1234), device)
    order = names + names[:0:-1] + names[:1]
    empty = time_ms(lambda: torch.cuda._sleep(0), device, args.reps)
    print(f"empty launch (ms, one timed call): {empty:.4f}")
    for m in MS:
        x = xs[m]
        got: dict[str, list[float]] = {}
        for name in order:
            kernels._loaded["ffn_fused"] = libs[name]
            FF._blocks.cache_clear()          # an ablated kernel may fit more
            got.setdefault(name, []).append(
                time_ms(lambda: FF.ffn_fused(x, gu, dn), device, args.reps))
        kernels._loaded["ffn_fused"] = libs["as_is"]
        FF._blocks.cache_clear()
        out = FF.ffn_fused(x, gu, dn)
        ref = FF.ffn_fused_ref(x, gu, dn)
        rel = float((out - ref).abs().max() / ref.abs().max())
        t_lib = time_ms(library(x, gu, dn), device, args.reps)
        t_b, t_o = bound_ms(m, gu, dn)
        print(f"ffn_fused Q4_0 dim={DIM} ffn={FFN} M={m} (ms): " + " | ".join(
            f"{n} {np.mean(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
            for n, v in got.items()) + f" | net of empty "
            f"{np.mean(got['as_is']) - empty:.4f} | empty {empty:.4f} | "
            f"library {t_lib:.4f} | bound {max(t_b, t_o):.4f} "
            f"({'bytes' if t_b >= t_o else 'operations'}) | as_is rel "
            f"{rel:.2e}", flush=True)
    kernels._loaded.pop("ffn_fused")
    FF._blocks.cache_clear()
    for name, (what, _) in ablations.items():
        print(f"{name}: {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
