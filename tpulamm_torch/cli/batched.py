"""batched: N parallel continuations of one prompt (examples/batched) on
the torch engine (counterpart of tpulamm.cli.batched).

The prompt is evaluated once, its KV forked to every slot
(llama_kv_cache_seq_cp — batched.cpp evaluates once with n_seq_id=all),
then all sequences decode together in one device-resident
decode_batch_fast block.

    python -m tpulamm_torch.cli.batched -m model.gguf -p "Hello my name is" -np 4
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-batched")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-p", "--prompt", default="Hello my name is")
    p.add_argument("-np", "--n-parallel", type=int, default=4)
    p.add_argument("-n", "--n-predict", type=int, default=32)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--temp", type=float, default=0.8,
                   help="sampling temperature (0 = greedy: all sequences "
                        "become identical)")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(args.model, n_ctx=args.ctx_size, n_slots=args.n_parallel,
                 device=args.device)
    if eng.tokenizer is None:
        p.error(f"{args.model} has no tokenizer vocab")

    toks = eng.tokenizer.encode(args.prompt, add_bos=True)
    t0 = time.perf_counter()
    logits = eng.prefill(0, toks)
    for s in range(1, args.n_parallel):
        eng.seq_cp(0, s)                  # fork the prompt KV to every slot
    # sample each stream's first token independently from the prompt
    # logits (batched.cpp samples per sequence; argmax would seed every
    # stream with the same deterministic token even at temp > 0)
    rng = np.random.default_rng(args.seed)
    def first_tok():
        if args.temp <= 0:
            return int(np.argmax(logits))
        lg = logits.astype(np.float64) / max(args.temp, 1e-6)
        p = np.exp(lg - lg.max())
        p /= p.sum()
        return int(rng.choice(len(p), p=p))
    cur = {s: first_tok() for s in range(args.n_parallel)}
    outs = eng.decode_batch_fast(cur, args.n_predict - 1,
                                 temp=args.temp, seed=args.seed)
    dt = time.perf_counter() - t0

    for s in range(args.n_parallel):
        # cur[s] is the stream's first token (the JAX CLI reads an
        # undefined name here)
        text = eng.tokenizer.decode([cur[s]] + outs[s])
        print(f"sequence {s}: {args.prompt}{text}\n")
    n_dec = args.n_parallel * args.n_predict
    print(f"decoded {n_dec} tokens ({args.n_parallel} seqs) in {dt:.2f}s, "
          f"{n_dec / dt:.2f} t/s (includes graph capture)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
