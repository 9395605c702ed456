"""export-lora: merge LoRA adapter(s) into a base GGUF model file
(counterpart of tpulamm.cli.export_lora; a host tool, numpy and the codec).

Parity with the reference's examples/export-lora (export-lora.cpp):
`W += scale * (alpha/r) * B @ A` for every tensor matched by an adapter,
written back in the tensor's ORIGINAL storage type (quantized bases are
dequantized, patched, requantized — the same dance
llama_model_apply_lora_from_file does at load time); unmatched tensors
and all metadata pass through byte-identical. Multiple -l/-s pairs
accumulate, like the reference's repeated `-l FNAME -s S` arguments.

Unlike `--lora` on the generation CLI (apply at load, every run), the
exported file bakes the adapter in once.

    python -m tpulamm_torch.cli.export_lora -m base.gguf -o out.gguf \
        -l adapter.gguf [-s adapter2.gguf 0.5]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from tpulamm_torch.gguf.reader import GGUFReader
from tpulamm_torch.gguf.writer import GGUFWriter
from tpulamm_torch.quant import formats


def _load_adapter(path: str, scale: float) -> dict[str, np.ndarray]:
    """adapter GGUF -> {base tensor name: accumulated f32 delta}."""
    r = GGUFReader(path)
    if r.metadata.get("adapter.type") != "lora":
        raise ValueError(f"{path}: not a LoRA adapter "
                         "(missing adapter.type=lora)")
    rank = int(r.metadata.get("adapter.lora.r", 8))
    alpha = float(r.metadata.get("adapter.lora.alpha", 2 * rank))
    s = scale * alpha / rank
    deltas: dict[str, np.ndarray] = {}
    for name, info in r.tensors.items():
        if not name.endswith(".lora_a"):
            continue
        base = name[: -len(".lora_a")]
        b = r.tensors.get(base + ".lora_b")
        if b is None:
            raise ValueError(f"{path}: {base} has lora_a but no lora_b")
        a32, b32 = info.to_f32(), b.to_f32()         # (r, K), (N, r)
        deltas[base] = (s * (b32 @ a32)).astype(np.float32)
    r.close()
    return deltas


def export_lora(base: str, out: str, adapters: list[tuple[str, float]],
                verbose: bool = True) -> None:
    merged: dict[str, np.ndarray] = {}
    for path, scale in adapters:
        for name, delta in _load_adapter(path, scale).items():
            if name in merged:
                merged[name] = merged[name] + delta
            else:
                merged[name] = delta

    r = GGUFReader(base)
    w = GGUFWriter(out, alignment=r.alignment)
    for k, v in r.metadata.items():
        if isinstance(v, (np.ndarray, list, str, bool, int, float)):
            w.add_kv(k, v)
    n_patched = 0
    for name, info in r.tensors.items():
        delta = merged.pop(name, None)
        if delta is None:
            w.add_tensor(name, np.asarray(info.data), shape=info.shape,
                         ggml_type=info.ggml_type)
            continue
        if delta.shape != info.shape:
            raise ValueError(f"{name}: adapter delta {delta.shape} vs "
                             f"base {info.shape}")
        x = info.to_f32() + delta
        raw = formats.quantize(x, info.ggml_type)
        w.add_tensor(name, raw, shape=info.shape, ggml_type=info.ggml_type)
        n_patched += 1
        if verbose:
            print(f"merged {name} ({info.ggml_type.name})")
    if merged:
        raise ValueError("adapter tensors with no base match: "
                         + ", ".join(sorted(merged)))
    w.write()
    r.close()
    if verbose:
        print(f"wrote {out}: {n_patched} tensors patched")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tpulamm-torch-export-lora",
        description="bake LoRA adapter(s) into a base GGUF")
    p.add_argument("-m", "--model-base", required=True)
    p.add_argument("-o", "--model-out", required=True)
    p.add_argument("-l", "--lora", action="append", default=[],
                   metavar="FNAME", help="adapter file (repeatable)")
    p.add_argument("-s", "--lora-scaled", action="append", default=[],
                   nargs=2, metavar=("FNAME", "S"),
                   help="adapter file with user scale (repeatable)")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    adapters = [(f, 1.0) for f in args.lora] + \
        [(f, float(s)) for f, s in args.lora_scaled]
    if not adapters:
        p.error("at least one -l/--lora or -s/--lora-scaled required")
    t0 = time.time()
    export_lora(args.model_base, args.model_out, adapters,
                verbose=not args.quiet)
    if not args.quiet:
        print(f"done in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
