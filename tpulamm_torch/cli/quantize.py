"""Model requantization CLI — parity with examples/quantize/quantize.cpp and
llama_model_quantize_internal (llama.cpp:12015); counterpart of
tpulamm.cli.quantize, writing the same bytes.

Reads any GGUF (F32/F16/quantized), re-encodes the 2-D weight tensors to the
target format and writes a new GGUF. Per-tensor rules follow the reference's
spirit: 1-D tensors (norms) stay F32; `output.weight` is kept at Q8_0 when
the target is below 8 bits (the reference promotes it to Q6_K, which sits
between — we use the nearest supported type); tensors whose inner dimension
is not blockable become F16. `--pure` disables the promotion. The block
formats are coded by the host codec (quant.native).

    python -m tpulamm_torch.cli.quantize SRC.gguf DST.gguf q4_0 [--pure]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from tpulamm_torch.gguf.constants import (GGML_TYPE_SIZES, GGMLType,
                                          GGUFValueType, LlamaFtype)
from tpulamm_torch.gguf.reader import GGUFReader
from tpulamm_torch.gguf.writer import GGUFWriter
from tpulamm_torch.quant import formats
from tpulamm_torch.quant.weighted import quantize_weighted
from tpulamm_torch.tools.imatrix import load_imatrix

NAMES = {
    "f32": GGMLType.F32, "f16": GGMLType.F16,
    "q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1,
    "q5_0": GGMLType.Q5_0, "q5_1": GGMLType.Q5_1,
    "q8_0": GGMLType.Q8_0, "q2_k": GGMLType.Q2_K,
}

FTYPES = {
    GGMLType.F32: LlamaFtype.ALL_F32, GGMLType.F16: LlamaFtype.MOSTLY_F16,
    GGMLType.Q4_0: LlamaFtype.MOSTLY_Q4_0, GGMLType.Q4_1: LlamaFtype.MOSTLY_Q4_1,
    GGMLType.Q5_0: LlamaFtype.MOSTLY_Q5_0, GGMLType.Q5_1: LlamaFtype.MOSTLY_Q5_1,
    GGMLType.Q8_0: LlamaFtype.MOSTLY_Q8_0, GGMLType.Q2_K: LlamaFtype.MOSTLY_Q2_K,
}


def choose_type(name: str, shape, target: GGMLType, pure: bool) -> GGMLType:
    if len(shape) < 2 or not name.endswith("weight"):
        return GGMLType.F32
    if not pure and name == "output.weight" and target in (
            GGMLType.Q2_K, GGMLType.Q4_0, GGMLType.Q4_1,
            GGMLType.Q5_0, GGMLType.Q5_1):
        return GGMLType.Q8_0
    if shape[-1] % GGML_TYPE_SIZES[target][0] != 0:
        return GGMLType.F16 if target != GGMLType.F32 else GGMLType.F32
    return target


def quantize_file(src: str, dst: str, target: GGMLType, pure: bool = False,
                  verbose: bool = True, imatrix: str | None = None) -> None:
    qw_map: dict = {}
    if imatrix:
        qw_map = load_imatrix(imatrix)
        if verbose:
            print(f"imatrix: importance for {len(qw_map)} tensors")
    r = GGUFReader(src)
    w = GGUFWriter(dst, alignment=r.alignment)
    for k, v in r.metadata.items():
        if k == "general.file_type":
            continue
        if isinstance(v, np.ndarray) or isinstance(v, (list, str, bool, int, float)):
            w.add_kv(k, v)
    if target in FTYPES:
        w.add_kv("general.file_type", int(FTYPES[target]),
                 GGUFValueType.UINT32)

    t0 = time.time()
    total_in = total_out = 0
    for name, info in r.tensors.items():
        tt = choose_type(name, info.shape, target, pure)
        if tt == info.ggml_type:
            w.add_tensor(name, np.asarray(info.data), shape=info.shape,
                         ggml_type=info.ggml_type)
            total_in += info.n_bytes
            total_out += info.n_bytes
            continue
        x = info.to_f32()
        if name in qw_map and qw_map[name].shape[0] == x.shape[-1]:
            raw = quantize_weighted(x, tt, qw_map[name])
        else:
            raw = formats.quantize(x, tt)
        w.add_tensor(name, raw, shape=info.shape, ggml_type=tt)
        total_in += info.n_bytes
        total_out += raw.nbytes
        if verbose:
            print(f"{name:48s} {info.ggml_type.name:6s} -> {tt.name:6s} "
                  f"{info.n_bytes / 1e6:9.2f} MB -> {raw.nbytes / 1e6:9.2f} MB")
    w.write()
    r.close()
    if verbose:
        print(f"done in {time.time() - t0:.1f}s: {total_in / 1e6:.1f} MB -> "
              f"{total_out / 1e6:.1f} MB")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-quantize")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("type", choices=sorted(NAMES))
    p.add_argument("--pure", action="store_true",
                   help="disable per-tensor type promotion")
    p.add_argument("--imatrix", default=None,
                   help="importance matrix (.npz of an imatrix collector)"
                        " for weighted rounding")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.src, "input")
    quantize_file(args.src, args.dst, NAMES[args.type], pure=args.pure,
                  imatrix=args.imatrix)
    return 0


if __name__ == "__main__":
    sys.exit(main())
