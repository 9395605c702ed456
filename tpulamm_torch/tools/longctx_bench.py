"""Long-context end-to-end measurements on the card (counterpart of
tpulamm.tools.longctx_bench).

The reference exercises its long-context machinery with examples/passkey
(self-extend) and context shifting (main.cpp:542-598); its perf tables
stop at n_ctx 2048. This tool produces the >=8k regime numbers the flash
kernel and the q8_0 KV cache exist for: for each n_ctx in --ctxs, prefill
to ~300 tokens below the window, then decode 256 at the tail, for every
{einsum, flash} x {bf16, q8_0} attention/cache combination — plus a
cross-path greedy parity check (einsum vs flash tokens must agree at the
full span; a masking/scale bug at 8k would diverge them).

    python -m tpulamm_torch.tools.longctx_bench \
        -m tmp_bench/llama7b_q4_0.gguf --ctxs 8192,16384 --json tmp_verify/longctx.json

The configs run one after another in this process; each engine is
dropped and the allocator's cache emptied before the next starts.
--device cpu runs the plain path (host wall clock).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def bench_cfg(model: str, n_ctx: int, flash: bool, kv: str,
              n_gen: int = 256, parity_tokens: bool = False,
              device: str = "cuda"):
    """tg is measured CONTINUING from the prefilled context
    (decode_batch_fast on the live slot), so attention really streams the
    ~n_ctx-token KV span every step. Round-4's version decoded via
    generate_fast, which RESETS the slot first — its 'decode is flat to
    16k' numbers measured an empty-context decode in the 512-cell span
    bucket, a physically impossible rate for a real 16k span (4.3 GB of
    bf16 KV per step + 3.8 GB of weights at 130 t/s would need >1 TB/s).
    This bug is why r5's long-context table supersedes r4's."""
    import torch

    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(model, n_ctx=n_ctx, flash_attn=flash, kv_dtype=kv,
                 n_ubatch=2048, device=device)
    rng = np.random.default_rng(0)
    pre = list(rng.integers(3, 1000, n_ctx - n_gen - 44))
    eng.reset_slot(0)
    lg = eng.prefill(0, pre)                 # includes compile
    carry = int(np.argmax(lg))
    eng.decode_batch_fast({0: carry}, n_gen)     # warm at the real span
    pp = tg = 0.0
    toks = None
    for _ in range(2):
        eng.reset_slot(0)
        t0 = time.perf_counter()
        lg = eng.prefill(0, pre)
        pp = max(pp, len(pre) / (time.perf_counter() - t0))
        carry = int(np.argmax(lg))
        t0 = time.perf_counter()
        blocks = eng.decode_batch_fast({0: carry}, n_gen)
        tg = max(tg, n_gen / (time.perf_counter() - t0))
        toks = [carry] + blocks[0]
    row = {"n_ctx": n_ctx, "attn": "flash" if flash else "einsum",
           "kv": kv, "pp": pp, "tg": tg}
    if parity_tokens:
        row["tokens"] = [int(t) for t in toks]
    del eng
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return row


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-longctx-bench")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--ctxs", default="8192")
    p.add_argument("--n-gen", type=int, default=256)
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path)")
    args = p.parse_args(argv)

    rows = []
    for n_ctx in (int(c) for c in args.ctxs.split(",")):
        tok_ref = {}
        for flash in (False, True):
            for kv in ("bfloat16", "q8_0"):
                name = "flash" if flash else "einsum"
                print(f"-- n_ctx {n_ctx} {name} {kv}...",
                      file=sys.stderr, flush=True)
                r = bench_cfg(args.model, n_ctx, flash, kv,
                              n_gen=args.n_gen, parity_tokens=True,
                              device=args.device)
                # greedy cross-path parity per KV type: einsum vs flash
                # must emit identical tokens at the full span
                keyp = ("tok", n_ctx, kv)
                if keyp in tok_ref:
                    r["parity_vs_einsum"] = tok_ref[keyp] == r["tokens"]
                else:
                    tok_ref[keyp] = r["tokens"]
                r.pop("tokens")
                rows.append(r)
                print(f"   pp {r['pp']:,.0f} t/s  tg{args.n_gen} "
                      f"{r['tg']:,.1f} t/s "
                      f"{r.get('parity_vs_einsum', '')}", file=sys.stderr)

    print("| n_ctx | attn | kv | pp t/s | tg t/s | parity |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['n_ctx']} | {r['attn']} | {r['kv']} | {r['pp']:,.0f} "
              f"| {r['tg']:,.1f} | {r.get('parity_vs_einsum', '-')} |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
