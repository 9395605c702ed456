"""Headline benchmark on the card: fused dequant + matmul GFLOPS, Q4_0
(counterpart of the repository's root bench.py).

The reference's la-benchmark-matmult methodology: the same GEMM shape
(weights 4096x11008 quantized, activations 11008x128), the same FLOPS
convention (2*M*K*N / elapsed) and the same correctness gate against the
f32 dequantized product (|sum - sum_f32| / |sum_f32| <= 1e-2 and nmse <=
1e-4). Baseline to beat: 121.31 GFLOPS (Q4_0, 4 threads, Loongson 3A6000).
The product runs through ops.qmm.qmm, which at M = 128 launches
csrc/qmm.cu. The weights are random Q4_0 blocks from a seed (the port has
no quantizers), the activations |N(0, 0.5)| in bf16, as in bench.py.

Timing (tools.timing): CUDA events, the median of 11 launches with the L2
flushed before each; spread_pct is (max - min) / median of the samples.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"spread_pct", "device"}.

    python -m tpulamm_torch.bench [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops.qmm import qmm, qmm_ref
from tpulamm_torch.ops.qtensor import QTensor
from tpulamm_torch.tools.synth import random_blocks
from tpulamm_torch.tools.timing import device_label, time_samples

BASELINE = 121.31       # Q4_0 4-thread GFLOPS (BASELINE.md section 1)
SHAPE = (4096, 11008, 128)  # N, K, M
METRIC = "fused_dequant_matmul_q4_0_gflops_4096x11008x128"


def gate(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(rel error of the output sum, nmse) of got against ref, in f64."""
    got, ref = got.to(torch.float64), ref.to(torch.float64)
    rel = float(abs(got.sum() - ref.sum()) / max(abs(float(ref.sum())), 1e-9))
    nmse = float(((got - ref) ** 2).mean() / (ref ** 2).mean())
    return rel, nmse


def run(shape=SHAPE, device="cuda", reps: int = 11) -> dict:
    """Time and gate one Q4_0 product of `shape` (N, K, M) on `device`."""
    from tpulamm_torch.runtime.engine import resolve_device
    dev = resolve_device(device)
    n, k, m = shape
    rng = np.random.default_rng(42)
    qt = QTensor.from_gguf_raw(random_blocks(GGMLType.Q4_0, n, k, rng),
                               GGMLType.Q4_0, (n, k), device=dev)
    x = torch.from_numpy(np.abs(rng.normal(size=(m, k)) * 0.5).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    samples = sorted(time_samples(lambda: qmm(x, qt), dev, reps))
    dt = float(np.median(samples))
    rel, nmse = gate(qmm(x, qt), qmm_ref(x, qt))
    gflops = 2.0 * m * k * n / (dt * 1e-3) / 1e9
    return {"gflops": gflops, "ms": dt, "rel": rel, "nmse": nmse,
            "spread_pct": 100.0 * (samples[-1] - samples[0]) / dt,
            "ok": rel <= 1e-2 and nmse <= 1e-4, "device": device_label(dev)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpulamm-torch-bench-matmul")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "version and times the host)")
    args = p.parse_args(argv)
    r = run(device=args.device)
    if not r["ok"]:
        print(json.dumps({"metric": "fused_dequant_matmul_q4_0", "value": 0.0,
                          "unit": "GFLOPS", "vs_baseline": 0.0,
                          "error": f"rel {r['rel']:.3e} nmse {r['nmse']:.3e}",
                          "device": r["device"]}))
        return 1
    print(json.dumps({"metric": METRIC, "value": round(r["gflops"], 2),
                      "unit": "GFLOPS",
                      "vs_baseline": round(r["gflops"] / BASELINE, 2),
                      "spread_pct": round(r["spread_pct"], 1),
                      "device": r["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
