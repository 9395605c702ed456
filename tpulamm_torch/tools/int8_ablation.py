"""Where the time of the int8-activation decode gemv goes: build copies of
csrc/qmm_int8.cu with one part removed and time them beside the source
as it is, on the card, at the five LLaMA-7B projections of a decode step
(fused QKV, wo, fused gate|up, down, the lm head padded to 32768), Q4_0,
at M = 1, 8 and 16.

    python -m tpulamm_torch.tools.int8_ablation [--reps 20] [--as-is-only]
                                                [--sweep]

Each line is a sum over the five shapes of the median of `reps` calls
with the L2 flushed (tools/timing.py), in the order as-is, ablations,
ablations reversed, as-is, and gives both readings. The ablated kernels
compute wrong results; only their times are read. Each build runs in its
own nvcc process, all at once (flash_ablation.build). Besides the
ablations it times the prologue alone (`tl_quantize_acts`, through
quantize_acts_cuda), the one-launch twin qmm_int8_inkq, and an empty
launch (torch.cuda._sleep(0)) under the same harness: the fixed cost that
every timed call carries. The as-is kernel is also timed shape by shape
with the L2 flushed by zeroing (the harness's default, whose dirty lines
a call pays to write back) and by a read (clean lines, as in a decode
step). --as-is-only builds and times the source as it
is (no ablation texts), so the tool can time another checkout's kernel;
--sweep times every ks of each shape at M = 1 and 16 (the L2 flushed by
a read) beside the one ops/qmm.py::int8_plan picks.
It measures the kernel of its own checkout only: its texts are this
kernel's. Needs a GPU.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import kernels
from tpulamm_torch.ops import qmm as Q
from tpulamm_torch.ops.qtensor import QTensor
from tpulamm_torch.tools.flash_ablation import build
from tpulamm_torch.tools.synth import random_blocks
from tpulamm_torch.tools.timing import device_label, time_ms

# name -> (what differs, [(text in the sources, replacement)])
ABLATIONS = {
    "loads_only": ("without the gemv's fragments, MMAs and f32 rescale (its plane "
                   "and scale copies remain, each thread's share of a stage "
                   "XORed into the sums)", [
        ("        step_math<QT, MT>(ring + (j % R) * S::BYTES, w, c - un.c0, "
         "s - c * S::SPC,\n                          warp, lane, acc);",
         "      { const uint4* p = reinterpret_cast<const uint4*>(ring + "
         "(j % R) * S::BYTES) + threadIdx.x; uint32_t f = (uint32_t)(c + "
         "w.stride); for (int i = 0; i < S::BYTES / 4096; ++i) f ^= "
         "p[256 * i].x ^ p[256 * i].y ^ p[256 * i].z ^ p[256 * i].w; "
         "acc[0][0] = __uint_as_float(__float_as_uint(acc[0][0]) ^ f); }")]),
    "no_combine": ("without the split-K combine (the partials are written; no block "
                   "adds them)", [
        ("    if (a.ks > 1) combine_tile<MT>(a, un.tile, lane);\n", "")]),
    "ring_4": ("a ring of 4 steps where shared memory holds them (the "
               "source keeps 3)", [
        ("constexpr int RING_MAX = 3;", "constexpr int RING_MAX = 4;")]),
}
# LLaMA-7B projections as the engine runs them (N, K)
SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096), "gate_up": (22016, 4096),
          "down": (4096, 11008), "lm_head": (32768, 4096)}
MS = (1, 8, 16)


def inputs(rng, device, qtype=GGMLType.Q4_0, shapes=SHAPES, ms=MS) -> dict:
    """{label: (qt, {m: x (m, K) f32})}: random blocks of `qtype` at each
    shape and x ~ N(0, 1) at each M, from rng."""
    out = {}
    for label, (n, k) in shapes.items():
        qt = QTensor.from_gguf_raw(random_blocks(qtype, n, k, rng), qtype,
                                   (n, k), device=device)
        xs = {m: torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                                  ).to(device) for m in ms}
        out[label] = (qt, xs)
    return out


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register / spill lines of the gemv and prologue entries in
    an nvcc log, each prefixed with its entry's mangled name."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'([^']+)'", line)
            name = m.group(1) if m else line
            entry = name if re.search(r"qmm_int8_kernel|quantize_acts_kernel",
                                      name) else None
        elif entry and re.search(r"registers|spill", line):
            out.append(f"{entry}: {line.strip()}")
    return out


def per_shape(cases, fn, m, device, reps, clean=False) -> dict[str, float]:
    """fn(x, qt) timed at every shape (clean: the L2 flushed by a read)."""
    return {label: time_ms(lambda: fn(xs[m], qt), device, reps, clean=clean)
            for label, (qt, xs) in cases.items()}


def sums(cases, fn, m, device, reps) -> float:
    """fn(x, qt) timed at every shape, summed."""
    return sum(per_shape(cases, fn, m, device, reps).values())


def sweep(cases, device, reps, ms=(1, 16)) -> None:
    """Each shape at each ks (the grid as int8_plan spreads its units),
    the L2 flushed by a read: the three fastest and int8_plan's choice."""
    plan = Q.int8_plan
    try:
        for m in ms:
            for label, (qt, xs) in cases.items():
                n, k = qt.mm_dims
                kch, groups = k // 256, -(-n // 1024)
                rows = []
                for ks in range(-(-kch // Q.INT8_WIN_CHUNKS[Q.int8_rows(m)]),
                                kch + 1):
                    units = groups * ks
                    grid = -(-units // -(-units // 132))
                    Q.int8_plan = lambda *_, p=(ks, grid): p
                    rows.append((time_ms(lambda: Q.qmm_int8_cuda(xs[m], qt),
                                         device, reps, clean=True), ks, grid))
                Q.int8_plan = plan
                chosen = [t for t, ks, g in rows
                          if (ks, g) == plan(m, n, k, 132)]
                rows.sort()
                print(f"sweep M={m} {label}: " + ", ".join(
                    f"ks={ks} grid={g} {t:.4f}" for t, ks, g in rows[:3])
                    + f" | int8_plan {plan(m, n, k, 132)} "
                    f"{chosen[0] if chosen else float('nan'):.4f} ms",
                    flush=True)
    finally:
        Q.int8_plan = plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--as-is-only", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every ks of each shape (132 SMs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_ablation: needs a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"device: {device_label(device)}")
    ablations = {} if args.as_is_only else ABLATIONS
    names = ["as_is", *ablations]
    libs = build(names, ablations, "qmm_int8")
    log = kernels.BUILD_DIR / "ablate_qmm_int8_as_is" / "nvcc.log"
    for line in ptxas_lines(log.read_text()):
        print(f"ptxas (as_is): {line}")
    cases = inputs(np.random.default_rng(1234), device)
    order = names + names[:0:-1] + names[:1]
    empty = time_ms(lambda: torch.cuda._sleep(0), device, args.reps)
    print(f"empty launch (ms, one timed call): {empty:.4f}; x5 {5 * empty:.4f}")
    clean = time_ms(lambda: torch.cuda._sleep(0), device, args.reps, clean=True)
    print(f"empty launch, L2 flushed by a read (ms): {clean:.4f}")
    for m in MS:
        got: dict[str, list[float]] = {}
        for name in order:
            kernels._loaded["qmm_int8"] = libs[name]
            got.setdefault(name, []).append(
                sums(cases, Q.qmm_int8_cuda, m, device, args.reps))
        kernels._loaded["qmm_int8"] = libs["as_is"]
        for clean in (False, True):
            shapes = per_shape(cases, Q.qmm_int8_cuda, m, device, args.reps,
                               clean)
            print(f"qmm_int8 Q4_0 M={m} as_is by shape, L2 flushed "
                  f"{'by a read' if clean else 'by zeroing'} (ms): sum "
                  f"{sum(shapes.values()):.4f} | " + " | ".join(
                      f"{k} {v:.4f}" for k, v in shapes.items()), flush=True)
        pro = sum(time_ms(lambda: Q.quantize_acts_cuda(xs[m], 32), device,
                          args.reps) for _, xs in cases.values())
        inkq = sums(cases, Q.qmm_int8_inkq_cuda, m, device, args.reps)
        print(f"qmm_int8 Q4_0 five 7B shapes M={m} (ms, sums): " + " | ".join(
            f"{n} {np.mean(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
            for n, v in got.items()) + f" | prologue {pro:.4f} | "
            f"inkq {inkq:.4f} | empty x5 {5 * empty:.4f}", flush=True)
    if args.sweep:
        sweep(cases, device, args.reps)
    kernels._loaded.pop("qmm_int8")
    for name, (what, _) in ablations.items():
        print(f"{name}: {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
