"""Measured per-format performance report on the card (counterpart of
tpulamm.tools.perf_report).

The matmul GFLOPS table over every quant format at the reference
benchmark shape (la-benchmark-matmult: 4096x11008 weights x 128
activations, GFLOPS = 2MKN/t), each row gated against its f32 product as
tpulamm_torch.bench gates Q4_0; with a model, the end-to-end pp512 /
tg256, aggregate batched decode vs slot count, and tg256 vs context size;
with --e2e-pattern, pp512 / tg256 of one model file per format (the files
`cli.quantize` writes from one F32 model), beside the reference's
published CPU numbers.
The f32 row is one bf16 torch.matmul, as the JAX row is a jnp.dot outside
any kernel; the quantized rows run ops.qmm.qmm (csrc/qmm.cu at M = 128).
The matmul table's quantized weights are random blocks from a seed.
Times: tools.timing (CUDA events, median of 20 launches with
a cold L2).

    python -m tpulamm_torch.tools.perf_report [-m model.gguf] [-o report.md]
        [--e2e-pattern 'model_{fmt}.gguf']
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpulamm_torch.bench import gate

REF_GFLOPS = {  # 3A6000 4-thread, level 3 (README.md:616-643)
    "f32": 113.17, "q4_0": 121.31, "q4_1": 118.77, "q5_0": 126.26,
    "q5_1": 130.79, "q8_0": 161.16, "q2_k": 109.91,
}
FORMATS = ("f32", "q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q2_k")
SHAPE = (4096, 11008, 128)      # N, K, M


def bench_matmul(qname: str, shape=SHAPE, device="cuda", reps: int = 20
                 ) -> dict:
    """{gflops, ms, rel, nmse, ok} of one format's product at `shape`."""
    from tpulamm_torch.gguf.constants import GGMLType
    from tpulamm_torch.ops.qmm import qmm, qmm_ref
    from tpulamm_torch.ops.qtensor import QTensor
    from tpulamm_torch.runtime.engine import resolve_device
    from tpulamm_torch.tools.synth import random_blocks
    from tpulamm_torch.tools.timing import time_ms
    dev = resolve_device(device)
    n, k, m = shape
    rng = np.random.default_rng(42)
    x = torch.from_numpy(np.abs(rng.normal(size=(m, k)) * 0.5).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    if qname == "f32":
        w = torch.from_numpy(np.abs(rng.normal(size=(n, k)) * 0.5).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        wt = w.T

        def one_call():
            return torch.matmul(x, wt)
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = x.to(torch.float32) @ wt.to(torch.float32)
    else:
        qtype = getattr(GGMLType, qname.upper())
        qt = QTensor.from_gguf_raw(random_blocks(qtype, n, k, rng), qtype,
                                   (n, k), device=dev)

        def one_call():
            return qmm(x, qt)
        ref = qmm_ref(x, qt)
    ms = time_ms(one_call, dev, reps)
    rel, nmse = gate(one_call(), ref)
    return {"gflops": 2.0 * m * k * n / (ms * 1e-3) / 1e9, "ms": ms,
            "rel": rel, "nmse": nmse, "ok": rel <= 1e-2 and nmse <= 1e-4}


def bench_model(path: str, device="cuda") -> dict:
    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(path, n_ctx=512, device=device)
    toks = list(np.random.default_rng(0).integers(
        3, min(1000, eng.cfg.vocab_size - 1), 512))
    eng.reset_slot(0)
    eng.prefill(0, toks)           # warm-up
    pp = 0.0
    for _ in range(4):             # best of 4: single reps are host-noisy
        eng.reset_slot(0)
        t0 = time.perf_counter()
        eng.prefill(0, toks)
        pp = max(pp, 512 / (time.perf_counter() - t0))
    eng.generate_fast([1], n_predict=256, temp=0.0, stop_on_eos=False)
    tg = 0.0
    for _ in range(3):
        eng.reset_slot(0)
        eng.prefill(0, [1])
        t0 = time.perf_counter()
        eng.generate_fast([1], n_predict=256, temp=0.0, stop_on_eos=False)
        tg = max(tg, 256 / (time.perf_counter() - t0))
    return {"pp512": pp, "tg256": tg}


def bench_batched(path: str, pls=(8, 16, 32), n_pp=128, n_tg=128,
                  n_ctx=512, device="cuda") -> list[dict]:
    """Aggregate decode throughput vs slot count (continuous batching):
    one decode_batch_fast block of n_tg steps for pl slots, best of 3.
    The engine is sized per row (n_slots = pl), so no configuration pays
    for idle cache slots."""
    from tpulamm_torch.runtime.engine import Engine
    rng = np.random.default_rng(0)
    rows = []
    for pl in pls:
        eng = Engine(path, n_ctx=n_ctx, n_slots=pl, device=device)
        hi = min(1000, eng.cfg.vocab_size - 1)
        for s in range(pl):
            eng.reset_slot(s)
            eng.prefill(s, list(rng.integers(3, hi, n_pp)))
        cur = {s: 2 for s in range(pl)}
        eng.decode_batch_fast(cur, n_tg)          # warm-up
        for s in range(pl):
            eng.rollback(s, n_pp)
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            eng.decode_batch_fast(cur, n_tg)
            best = max(best, pl * n_tg / (time.perf_counter() - t0))
            for s in range(pl):
                eng.rollback(s, n_pp)
        rows.append({"pl": pl, "agg_ts": best})
        del eng
    return rows


def bench_ctx_scaling(path: str, ctxs=(512, 2048), device="cuda",
                      **eng_kw) -> list[dict]:
    """tg256 at several context sizes (the KV-streaming cost curve)."""
    from tpulamm_torch.runtime.engine import Engine
    rows = []
    for n_ctx in ctxs:
        eng = Engine(path, n_ctx=n_ctx, device=device, **eng_kw)
        n_gen = min(256, max(4, n_ctx // 2))
        pre = [1] * max(1, n_ctx - n_gen - 44)
        eng.reset_slot(0)
        eng.prefill(0, pre)
        eng.generate_fast([2], n_predict=n_gen, temp=0.0, stop_on_eos=False)
        best = 0.0
        for _ in range(3):
            eng.reset_slot(0)
            eng.prefill(0, pre)
            t0 = time.perf_counter()
            eng.generate_fast([2], n_predict=n_gen, temp=0.0,
                              stop_on_eos=False)
            best = max(best, n_gen / (time.perf_counter() - t0))
        rows.append({"n_ctx": n_ctx, "tg256": best})
        del eng
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpulamm-torch-perf-report")
    p.add_argument("-m", "--model", default=None,
                   help="GGUF for end-to-end pp/tg numbers")
    p.add_argument("-o", "--output", default=None, help="write markdown here")
    p.add_argument("--formats", default=None,
                   help="comma-separated subset (e.g. q4_0,q8_0)")
    p.add_argument("--e2e-pattern", default=None, metavar="PATH{fmt}",
                   help="per-format end-to-end tg/pp matrix from models at "
                        "this pattern, e.g. tmp_bench/llama_{fmt}.gguf")
    p.add_argument("--batched", default=None, metavar="MODEL",
                   help="aggregate decode throughput vs slot count")
    p.add_argument("--ctx-scan", default=None, metavar="MODEL",
                   help="tg256 vs context size")
    p.add_argument("--skip-matmul", action="store_true",
                   help="skip the per-format matmul GFLOPS table")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path and times the host)")
    args = p.parse_args(argv)
    for path in (args.model, args.batched, args.ctx_scan):
        if path is not None and not os.path.isfile(path):
            p.error(f"model not found: {path}")
    fmts = args.formats.split(",") if args.formats else FORMATS
    for q in fmts:
        if q not in REF_GFLOPS:
            p.error(f"unknown format: {q}")
    from tpulamm_torch.runtime.engine import resolve_device
    from tpulamm_torch.tools.timing import device_label
    dev = resolve_device(args.device)
    label = device_label(dev)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    lines = [f"# Measured performance ({label})", "",
             "Matmul: reference shape 4096x11008x128, GFLOPS = 2MKN/t, CUDA "
             "events, median of 20 launches with a cold L2; each row gated "
             "against its f32 product (rel sum <= 1e-2, nmse <= 1e-4).",
             "Reference column: Loongson 3A6000, 4 threads, LAMM opt level 3.",
             "", f"| format | {card} GFLOPS | 3A6000 GFLOPS | ratio |",
             "|---|---|---|---|"]
    failed = []
    if not args.skip_matmul:
        for q in fmts:
            r = bench_matmul(q, device=dev)
            ref = REF_GFLOPS[q]
            if not r["ok"]:
                failed.append(f"{q}: rel {r['rel']:.3e} nmse {r['nmse']:.3e}")
            lines.append(f"| {q} | {r['gflops']:,.0f} | {ref} "
                         f"| {r['gflops'] / ref:,.0f}x |")
            print(lines[-1], file=sys.stderr)
    if args.model:
        r = bench_model(args.model, device=dev)
        lines += ["", f"End-to-end ({args.model}):", "",
                  f"- prompt eval (pp512): {r['pp512']:,.0f} tok/s",
                  f"- generation (tg256, generate_fast): "
                  f"{r['tg256']:,.1f} tok/s"]
        print("\n".join(lines[-2:]), file=sys.stderr)
    if args.e2e_pattern:
        # per-format end-to-end matrix (reference README.md:674-723 tables;
        # ref tg/pp columns: tiny-llama-1.1b, 4 threads, level 3)
        ref_pp = {"q4_0": 36.14, "q4_1": 36.87, "q5_0": 37.61,
                  "q5_1": 35.91, "q8_0": 79.68, "q2_k": 17.70}
        ref_tg = {"q4_0": 20.16, "q4_1": 19.76, "q5_0": 17.89,
                  "q5_1": 16.79, "q8_0": 18.60, "q2_k": 12.61}
        lines += ["", f"Per-format end-to-end ({args.e2e_pattern}, one "
                  "card; ref: tiny-llama-1.1b on 3A6000x4t L3):", "",
                  "| format | pp512 t/s | tg256 t/s | ref pp | ref tg "
                  "| tg ratio |", "|---|---|---|---|---|---|"]
        for q in ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q2_k"):
            path = args.e2e_pattern.replace("{fmt}", q)
            if not os.path.isfile(path):
                print(f"skip {q}: {path} missing", file=sys.stderr)
                continue
            r = bench_model(path, device=dev)
            lines.append(
                f"| {q} | {r['pp512']:,.0f} | {r['tg256']:,.1f} "
                f"| {ref_pp[q]} | {ref_tg[q]} "
                f"| {r['tg256'] / ref_tg[q]:,.0f}x |")
            print(lines[-1], file=sys.stderr)
    if args.batched:
        lines += ["", "Aggregate decode throughput vs slots "
                  "(pp128+tg128 per slot, one card):", "",
                  "| slots | aggregate tok/s | per-slot tok/s |",
                  "|---|---|---|"]
        for r in bench_batched(args.batched, device=dev):
            lines.append(f"| {r['pl']} | {r['agg_ts']:,.0f} "
                         f"| {r['agg_ts'] / r['pl']:,.1f} |")
            print(lines[-1], file=sys.stderr)
    if args.ctx_scan:
        lines += ["", "tg256 vs context size (decode spans the window "
                  "tail):", "", "| n_ctx | tg256 t/s |", "|---|---|"]
        for r in bench_ctx_scaling(args.ctx_scan, device=dev):
            lines.append(f"| {r['n_ctx']} | {r['tg256']:,.1f} |")
            print(lines[-1], file=sys.stderr)
    md = "\n".join(lines) + "\n"
    if args.output:
        with open(args.output, "w") as f:
            f.write(md)
    else:
        print(md)
    if failed:
        print(f"gate failed: {'; '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
