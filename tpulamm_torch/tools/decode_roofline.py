"""Op-by-op roofline accounting of ONE decode step (M = 1) on the card
(counterpart of tpulamm.tools.decode_roofline).

For a loaded model (post-fusion, the default int8 decode path) it times:
- every distinct quantized projection of the step (wqkv / wo / wgate|up /
  w_down / lm head) through ops.qmm.qmm at M = 1 (csrc/qmm_int8.cu),
- the int8 activation prologue (quantize_acts) for each distinct K,
- attention over the KV span at --span (the forward's einsum path: f32
  scores over bf16 K / V, masked softmax, PV),
- the real step (generate_fast), so the table closes with an accounted /
  unaccounted split.
Each op's bound is its bytes over --bw-gbs: 3350 by default, the H100
data sheet; pass the card's measured streaming ceiling
(tools/stream_ceiling.py) to score against what the card can stream.
Times: tools.timing (CUDA events, median of 20 calls with a cold L2).

    python -m tpulamm_torch.tools.decode_roofline -m model.gguf [--bw-gbs N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

QMM_KEYS = ("wqkv_fused", "wq", "wk", "wv", "wo", "wgateup_fused", "w_gate",
            "w_up", "w_down")


def attention_call(n_heads: int, n_kv: int, head_dim: int, span: int,
                   device):
    """One decode attention over `span` bf16 K / V cells as the forward's
    einsum path computes it (models/transformer.py), random inputs."""
    from tpulamm_torch.ops.layers import masked_softmax
    g = torch.Generator(device=device)
    g.manual_seed(0)
    kc = (torch.randn((1, n_kv, span, head_dim), generator=g, device=device)
          * 0.3).to(torch.bfloat16)
    vc = (torch.randn((1, n_kv, span, head_dim), generator=g, device=device)
          * 0.3).to(torch.bfloat16)
    q = torch.randn((1, 1, n_kv, n_heads // n_kv, head_dim), generator=g,
                    device=device)
    mask = torch.rand((1, 1, 1, 1, span), generator=g, device=device) < 0.5
    scale = 1.0 / float(np.sqrt(head_dim))

    def call():
        s = torch.einsum("bthgd,bhsd->bhgts", q, kc.to(torch.float32)) * scale
        p = masked_softmax(s, mask)
        return torch.einsum("bhgts,bhsd->bthgd", p, vc.to(torch.float32))
    return call


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpulamm-torch-decode-roofline")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--bw-gbs", type=float, default=3350.0,
                   help="memory bandwidth for the bound column (default "
                        "3350 GB/s, the H100 data sheet)")
    p.add_argument("--span", type=int, default=512,
                   help="KV span for the attention row (tg256 from an "
                        "empty prompt runs in the 512 bucket)")
    p.add_argument("--n-predict", type=int, default=256)
    p.add_argument("--json", default=None, help="dump rows here")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path and times the host)")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    from tpulamm_torch.ops.qmm import qmm, quantize_acts_cuda
    from tpulamm_torch.ops.qtensor import QTensor
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.tools.timing import device_label, time_ms
    eng = Engine(args.model, n_ctx=2048, device=args.device)
    dev = eng.device
    cfg = eng.cfg
    lyr = eng.params["layers"][0]
    rng = np.random.default_rng(0)
    rows = []

    def add(name, count, one_call_bytes, ms):
        us = ms * 1e3
        bound = one_call_bytes / (args.bw_gbs * 1e9) * 1e6
        rows.append({
            "op": name, "count": count, "mb": one_call_bytes / 1e6,
            "us": us, "bound_us": bound,
            "eff_gbs": one_call_bytes / (ms * 1e-3) / 1e9,
            "pct_of_bound": 100.0 * bound / us,
        })
        print(f"  {name}: {us:8.1f} us  bound {bound:8.1f} us  "
              f"({rows[-1]['eff_gbs']:.0f} GB/s, "
              f"{rows[-1]['pct_of_bound']:.0f}% of bound) x{count}",
              file=sys.stderr)

    def acts(m, k):
        return torch.from_numpy((rng.normal(size=(m, k)) * 0.3).astype(
            np.float32)).to(dev)

    # -- quantized matmuls of the decode step (post-fusion layout) --------
    n_l = cfg.n_layers
    mats = [(key, n_l, lyr.get(key)) for key in QMM_KEYS]
    mats.append(("lm_head", 1, eng.params.get("output")))
    mats = [(key, c, qt) for key, c, qt in mats
            if isinstance(qt, QTensor) and qt.layout == "mm"]
    for key, count, qt in mats:
        n, k = qt.mm_dims
        print(f"measuring {key} ({n}x{k})...", file=sys.stderr)
        x = acts(1, k)
        add(f"qmm {key} {n}x{k}", count, qt.n_bytes,
            time_ms(lambda: qmm(x, qt), dev))

    # -- int8 activation-quant prologue, per distinct K -------------------
    group = lyr["w_down"].spec.group if isinstance(
        lyr.get("w_down"), QTensor) else 32
    for k in sorted({qt.mm_dims[1] for _, _, qt in mats}):
        print(f"measuring int8 prologue K={k}...", file=sys.stderr)
        x = acts(8, k)
        # bytes: read 8xK f32 + write int8 codes + scales (tiny)
        add(f"prologue K={k}", 0, 8 * k * 5,
            time_ms(lambda: quantize_acts_cuda(x, group), dev))

    # -- attention KV streaming at the span --------------------------------
    print(f"measuring attention span={args.span}...", file=sys.stderr)
    hd = cfg.head_dim
    call = attention_call(cfg.n_heads, cfg.n_kv_heads, hd, args.span, dev)
    kv_bytes = 2 * cfg.n_kv_heads * args.span * hd * 2
    add(f"attention S={args.span}", n_l, kv_bytes, time_ms(call, dev))

    # -- the real end-to-end step ------------------------------------------
    print("measuring full step (generate_fast)...", file=sys.stderr)
    eng.generate_fast([1], n_predict=args.n_predict, temp=0.0,
                      stop_on_eos=False)
    best = None
    for _ in range(3):
        eng.reset_slot(0)
        eng.prefill(0, [1])
        t0 = time.perf_counter()
        eng.generate_fast([1], n_predict=args.n_predict, temp=0.0,
                          stop_on_eos=False)
        dt = (time.perf_counter() - t0) / args.n_predict
        best = dt if best is None else min(best, dt)
    step_us = best * 1e6

    acc_us = sum(r["us"] * r["count"] for r in rows)
    acc_bytes = sum(r["mb"] * r["count"] for r in rows)
    bound_us = sum(r["bound_us"] * r["count"] for r in rows)

    hdr = (f"# Decode roofline: {args.model} "
           f"(BW bound {args.bw_gbs:.0f} GB/s; {device_label(dev)})")
    lines = [hdr, "",
             "| op | xN | MB/call | us/call | bound us | eff GB/s | "
             "% of bound |", "|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['op']} | {r['count']} | {r['mb']:.1f} | {r['us']:.1f} "
            f"| {r['bound_us']:.1f} | {r['eff_gbs']:.0f} "
            f"| {r['pct_of_bound']:.0f}% |")
    lines += [
        "",
        f"- full step measured: {step_us:,.0f} us/token "
        f"({1e6 / step_us:,.1f} t/s)",
        f"- sum of measured ops: {acc_us:,.0f} us "
        f"({100 * acc_us / step_us:.0f}% of step; "
        f"{acc_bytes:,.0f} MB streamed)",
        f"- sum of op bounds: {bound_us:,.0f} us "
        f"(pure-streaming ceiling {1e6 / bound_us:,.1f} t/s)",
        f"- unaccounted (norms/rope/KV-writes/sampling/host dispatch): "
        f"{step_us - acc_us:,.0f} us",
    ]
    print("\n".join(lines))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "step_us": step_us,
                       "acc_us": acc_us, "bound_us": bound_us,
                       "model": args.model, "bw_gbs": args.bw_gbs,
                       "device": device_label(dev)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
