"""Decode-path KL audit of the int8 activation dots, per quant format
(counterpart of tpulamm.tools.int8_kl_audit).

The int8 activation path (ops.qmm's qmm_int8 gemv, the decode default at M
<= 16) carries the reference's own activation-quantization error class
(ggml.c vec_dot_type Q8 activations). This tool runs the teacher-forced
protocol on every format: the same quantized model decoded twice --
Engine(int8_dot="0") (qmm's f32 dequant dots) against int8_dot="1" (the
int8 dots) -- and reports KL(f32-path || int8-path) and top-1 agreement
over held-out text. The JAX tool flips TPULAMM_INT8_DOT; the port takes
the switch as an Engine option, which changes qmm's path choice only.

    python -m tpulamm_torch.tools.int8_kl_audit \
        --f32-model tmp_bench/spec_big_f32.gguf --steps 128 [--device cpu]

On the CPU both passes take the plain dequantize-then-dot path, as the
JAX tool's do off the TPU, so the two agree there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

FORMATS = ("Q8_0", "Q5_1", "Q5_0", "Q4_1", "Q4_0", "Q2_K")


def _tokens(n_prefix: int, n_steps: int) -> list[int]:
    """Held-out byte-token stream: the tail of the training corpus
    (tools.quality_table.build_corpus), which quality_table's train split
    never reaches."""
    from tpulamm_torch.tools.quality_table import build_corpus
    corpus = build_corpus(8_000_000)
    tail = corpus[-(n_prefix + n_steps + 1):]
    return [1] + [int(b) + 3 for b in tail]


def teacher_forced_logits(model: str, toks: list[int], n_prefix: int,
                          int8: bool, device=None,
                          on_decode=None) -> np.ndarray:
    """The logits of each decode_one step after a prefill of
    toks[:n_prefix], fed toks[n_prefix:] -> (steps, V) f64. int8: the
    engine's int8_dot "1", else "0". device: default "cuda". on_decode: a
    context-manager factory wrapped around the decode steps alone."""
    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(model, n_ctx=len(toks) + 8, int8_dot="1" if int8 else "0",
                 device=device)
    eng.reset_slot(0)
    eng.prefill(0, toks[:n_prefix])
    out = []
    with (on_decode() if on_decode else contextlib.nullcontext()):
        for t in toks[n_prefix:]:
            out.append(eng.decode_one(0, int(t)))      # gemv decode path
    del eng
    return np.stack(out).astype(np.float64)            # (steps, V)


def kl_row(base: np.ndarray, test: np.ndarray) -> dict:
    def logsoft(x):
        m = x.max(axis=-1, keepdims=True)
        e = np.exp(x - m)
        return (x - m) - np.log(e.sum(axis=-1, keepdims=True))
    lb, lt = logsoft(base), logsoft(test)
    kl = (np.exp(lb) * (lb - lt)).sum(axis=-1)     # per step
    top1 = (base.argmax(axis=-1) == test.argmax(axis=-1)).mean()
    return {"kl_mean": float(kl.mean()), "kl_p99": float(
        np.percentile(kl, 99)), "kl_max": float(kl.max()),
        "top1": float(top1)}


def main(argv=None, on_decode=None):
    """on_decode(fmt, int8): a context-manager factory wrapped around each
    pass's decode steps (teacher_forced_logits)."""
    p = argparse.ArgumentParser(prog="tpulamm-int8-kl-audit")
    p.add_argument("--f32-model", default="tmp_bench/spec_big_f32.gguf")
    p.add_argument("--formats", default=",".join(FORMATS))
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--prefix", type=int, default=64)
    p.add_argument("--out-dir", default="tmp_bench")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain path)")
    args = p.parse_args(argv)

    from tpulamm_torch.cli.quantize import quantize_file
    from tpulamm_torch.gguf.constants import GGMLType
    from tpulamm_torch.runtime.engine import resolve_device
    device = resolve_device(args.device)
    toks = _tokens(args.prefix, args.steps)
    os.makedirs(args.out_dir, exist_ok=True)
    rows = {}
    for fmt in args.formats.split(","):
        path = os.path.join(args.out_dir,
                            f"int8kl_{fmt.lower()}.gguf")
        if not os.path.exists(path):
            print(f"quantizing {fmt}...", file=sys.stderr)
            quantize_file(args.f32_model, path, getattr(GGMLType, fmt))

        def hook(int8, fmt=fmt):
            return None if on_decode is None else (
                lambda: on_decode(fmt, int8))
        print(f"{fmt}: f32-dot pass...", file=sys.stderr)
        base = teacher_forced_logits(path, toks, args.prefix, int8=False,
                                     device=device, on_decode=hook(False))
        print(f"{fmt}: int8-dot pass...", file=sys.stderr)
        test = teacher_forced_logits(path, toks, args.prefix, int8=True,
                                     device=device, on_decode=hook(True))
        rows[fmt] = kl_row(base, test)
        r = rows[fmt]
        print(f"{fmt}: KL mean {r['kl_mean']:.5f} p99 {r['kl_p99']:.4f} "
              f"max {r['kl_max']:.4f} top-1 {100 * r['top1']:.1f}%",
              file=sys.stderr)

    print("| format | KL(f32||int8) mean | p99 | max | top-1 agree |")
    print("|---|---|---|---|---|")
    for fmt, r in rows.items():
        print(f"| {fmt} | {r['kl_mean']:.5f} | {r['kl_p99']:.4f} "
              f"| {r['kl_max']:.4f} | {100 * r['top1']:.1f}% |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
