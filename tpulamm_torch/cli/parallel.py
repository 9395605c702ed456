"""parallel: multi-client continuous-batching simulation on the torch
engine (counterpart of tpulamm.cli.parallel).

Re-creates examples/parallel/parallel.cpp: a shared system prompt is
evaluated once and forked to every slot with a KV copy
(llama_kv_cache_seq_cp, parallel.cpp:203), then -ns client requests are
served through -np parallel slots; all running slots decode together in
one batched device step per token (Engine.decode_batch = the server's
continuous-batching primitive).

    python -m tpulamm_torch.cli.parallel -m model.gguf -np 4 -ns 16 -n 32
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

SYSTEM = ("A chat between a curious user and an artificial intelligence "
          "assistant. The assistant gives helpful answers.\n")

# the reference's built-in question pool (parallel.cpp:k_prompts)
QUESTIONS = [
    "What is the meaning of life?",
    "Tell me an interesting fact about llamas.",
    "What is the best way to cook a steak?",
    "Are you familiar with the Special Theory of Relativity?",
    "Recommend some interesting books to read.",
    "What is the best way to learn a new language?",
    "How to get a job at Google?",
    "If you could have any superpower, what would it be?",
    "I want to learn how to play the piano.",
]


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-parallel")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-np", "--n-parallel", type=int, default=4,
                   help="simultaneous slots")
    p.add_argument("-ns", "--n-sequences", "--sequences", type=int,
                   default=8, help="total requests to serve")
    p.add_argument("-n", "--n-predict", type=int, default=32,
                   help="max tokens per answer")
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--temp", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("-f", "--file", default=None,
                   help="newline-separated custom prompts")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.sampling import Sampler, SamplingParams

    questions = QUESTIONS
    if args.file:
        with open(args.file) as f:
            questions = [ln.strip() for ln in f if ln.strip()]

    eng = Engine(args.model, n_ctx=args.ctx_size, n_slots=args.n_parallel,
                 device=args.device)
    if eng.tokenizer is None:
        p.error(f"{args.model} has no tokenizer vocab")
    eos = eng.tokenizer.vocab.eos_id

    t_start = time.perf_counter()
    sys_toks = eng.tokenizer.encode(SYSTEM, add_bos=True)
    eng.prefill(0, sys_toks)
    for s in range(1, args.n_parallel):
        eng.seq_cp(0, s)                   # fork the shared system KV
    n_sys = len(sys_toks)
    print(f"system prompt: {n_sys} tokens, forked to {args.n_parallel} "
          f"slots", file=sys.stderr)

    next_seq = 0
    n_prompt = n_sys
    n_decode = 0
    cur: dict[int, int] = {}               # slot -> last sampled token
    state: dict[int, dict] = {}            # slot -> client state

    def start(slot: int):
        nonlocal next_seq, n_prompt
        q = questions[next_seq % len(questions)]
        toks = eng.tokenizer.encode("User: " + q + "\nAssistant:")
        logits = eng.prefill(slot, toks)
        n_prompt += len(toks)
        smp = Sampler(SamplingParams(temp=args.temp,
                                     seed=args.seed + next_seq),
                      eng.cfg.vocab_size)
        tok = smp.sample(logits)
        state[slot] = {"seq": next_seq, "q": q, "smp": smp, "out": [],
                       "t0": time.perf_counter()}
        cur[slot] = tok
        next_seq += 1

    def finish(slot: int):
        st = state.pop(slot)
        dt = time.perf_counter() - st["t0"]
        text = eng.tokenizer.decode(st["out"]).strip()
        print(f"seq {st['seq']:3d} | slot {slot} | {len(st['out']):4d} tok "
              f"| {len(st['out']) / max(dt, 1e-9):7.2f} t/s")
        print(f"  Q: {st['q']}\n  A: {text}\n")
        cur.pop(slot)
        eng.rollback(slot, n_sys)          # retire: keep only the system KV

    for s in range(min(args.n_parallel, args.n_sequences)):
        start(s)
    while cur:
        logits = eng.decode_batch(cur)
        n_decode += len(cur)
        for slot in list(cur):
            st = state[slot]
            tok = cur[slot]
            if tok == eos or len(st["out"]) >= args.n_predict:
                finish(slot)
                if next_seq < args.n_sequences:
                    start(slot)
                continue
            st["out"].append(tok)
            cur[slot] = st["smp"].sample(logits[slot])

    dt = time.perf_counter() - t_start
    print(f"total: {args.n_sequences} sequences, {n_prompt} prompt + "
          f"{n_decode} decode tokens in {dt:.2f}s "
          f"({(n_prompt + n_decode) / dt:.2f} t/s aggregate)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
