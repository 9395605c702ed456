"""Per-layer quantization error statistics — examples/quantize-stats parity
(424 LoC): for each 2-D weight tensor and each requested format, reports
RMSE, max error and the RMSE histogram-style summary vs the F32 original
(counterpart of tpulamm.cli.quantize_stats; the host codec codes).

    python -m tpulamm_torch.cli.quantize_stats -m MODEL.gguf [-t q4_0] [-l blk.0.]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.gguf.reader import GGUFReader
from tpulamm_torch.quant.formats import dequantize, quantize

NAMES = {"q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1,
         "q5_0": GGMLType.Q5_0, "q5_1": GGMLType.Q5_1,
         "q8_0": GGMLType.Q8_0, "q2_k": GGMLType.Q2_K}


def tensor_stats(x: np.ndarray, qtype: GGMLType) -> dict:
    raw = quantize(x, qtype)
    y = dequantize(raw.reshape(x.shape[0], -1), qtype, x.shape[-1])
    err = (y.reshape(x.shape) - x).astype(np.float64)
    return {
        "rmse": float(np.sqrt(np.mean(err * err))),
        "maxerr": float(np.abs(err).max()),
        # reference also prints error vs rms(x) ("rmse/x")
        "rmse_rel": float(np.sqrt(np.mean(err * err))
                          / max(np.sqrt(np.mean(x.astype(np.float64) ** 2)),
                                1e-30)),
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-quantize-stats")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-t", "--type", action="append", default=[],
                   choices=sorted(NAMES), help="formats (default: all)")
    p.add_argument("-l", "--include-layer", action="append", default=[],
                   help="only tensors whose name contains this substring")
    p.add_argument("--per-layer", action="store_true",
                   help="print every tensor (default: aggregate per type)")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    types = [NAMES[t] for t in (args.type or sorted(NAMES))]
    r = GGUFReader(args.model)
    tensors = []
    for name, info in r.tensors.items():
        if len(info.shape) != 2 or not name.endswith("weight"):
            continue
        if args.include_layer and not any(s in name
                                          for s in args.include_layer):
            continue
        tensors.append((name, info))
    if not tensors:
        print("no matching tensors", file=sys.stderr)
        return 1

    for qtype in types:
        total_se = total_n = 0.0
        maxerr = 0.0
        print(f"== {qtype.name} ==")
        for name, info in tensors:
            x = info.to_f32()
            if x.shape[-1] % 256 != 0 and qtype == GGMLType.Q2_K:
                continue
            if x.shape[-1] % 32 != 0:
                continue
            s = tensor_stats(x, qtype)
            if args.per_layer:
                print(f"  {name:48s} rmse {s['rmse']:.6f}  "
                      f"maxerr {s['maxerr']:.6f}  rel {s['rmse_rel']:.4f}")
            total_se += s["rmse"] ** 2 * x.size
            total_n += x.size
            maxerr = max(maxerr, s["maxerr"])
        if total_n:
            print(f"  overall: rmse {np.sqrt(total_se / total_n):.6f}  "
                  f"maxerr {maxerr:.6f}  ({int(total_n)} weights)")
    r.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
