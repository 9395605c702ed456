"""Perplexity evaluation — parity with examples/perplexity/perplexity.cpp
(counterpart of tpulamm.cli.perplexity, on the port's Engine).

Same methodology as perplexity() (perplexity.cpp:445): the corpus is
tokenized once (BOS prepended per chunk), split into n_ctx-token chunks; each
chunk is evaluated and the NLL of the second half (from min(512, n_ctx/2)) is
accumulated; PPL = exp(nll / count). This is the wikitext-2 quality metric
the per-format Δppl budgets are defined on (BASELINE.md §5).

Every mode runs its chunks through Engine.prefill(..., logits_all=True):
on the card each ubatch's projections are qmm launches (csrc/qmm.cu) in a
block format, dense f32 products for an F32 model.

    python -m tpulamm_torch.cli.perplexity -m MODEL.gguf -f TEXT [-c 512]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np


def log_softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max(axis=-1, keepdims=True)
    x = logits - m
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def compute_perplexity(engine, text: str, n_ctx: int = 512,
                       progress=True, tokens: list | None = None) -> dict:
    """tokens: pre-tokenized corpus (skips the tokenizer — used when the
    training-side token mapping differs from SPM text normalization)."""
    tok = engine.tokenizer
    if tokens is None:
        tokens = tok.encode(text, add_bos=False)
    bos = tok.vocab.bos_id if tok is not None else 1

    n_chunk = len(tokens) // n_ctx
    if n_chunk < 1:
        raise ValueError(f"corpus too short: {len(tokens)} tokens < n_ctx {n_ctx}")

    first = min(512, n_ctx // 2)
    nll = 0.0
    count = 0
    for i in range(n_chunk):
        chunk = [bos] + tokens[i * n_ctx: (i + 1) * n_ctx]
        chunk = chunk[:n_ctx]
        engine.reset_slot(0)
        logits = engine.prefill(0, chunk, logits_all=True)  # (n_ctx, vocab)
        lp = log_softmax(logits[first - 1:-1].astype(np.float64))
        targets = np.asarray(chunk[first:], np.int64)
        nll += -lp[np.arange(len(targets)), targets].sum()
        count += len(targets)
        if progress:
            ppl = math.exp(nll / count)
            print(f"[{i + 1}/{n_chunk}] ppl = {ppl:.4f}", file=sys.stderr)
    return {"ppl": math.exp(nll / count), "nll": nll / count, "tokens": count}


def compute_perplexity_v2(engine, text: str, n_ctx: int = 512,
                          stride: int = 32, output_type: int = 0,
                          progress=True) -> dict:
    """Strided perplexity (perplexity_v2, perplexity.cpp:332-446): windows
    start every `stride` tokens and only the final `stride` positions of
    each n_ctx window are scored; --ppl-output-type 1 emits cumulative
    `<tokens> <ppl>` pairs for plotting (perplexity.cpp:433-439)."""
    tok = engine.tokenizer
    tokens = tok.encode(text, add_bos=False)
    bos = tok.vocab.bos_id if tok is not None else 1
    if stride <= 0:
        raise ValueError("--ppl-stride must be > 0")
    calc_chunk = n_ctx
    if len(tokens) <= calc_chunk:
        raise ValueError(f"corpus too short: {len(tokens)} tokens <= {calc_chunk}")
    n_chunk = (len(tokens) - calc_chunk + stride - 1) // stride

    nll = 0.0
    count = 0
    for i in range(n_chunk):
        start = i * stride
        chunk = list(tokens[start:start + n_ctx])
        chunk[0] = bos                       # perplexity.cpp:381 overwrite
        engine.reset_slot(0)
        logits = engine.prefill(0, chunk, logits_all=True)
        j0 = n_ctx - stride - 1
        lp = log_softmax(logits[j0:n_ctx - 1].astype(np.float64))
        targets = np.asarray(chunk[j0 + 1:n_ctx], np.int64)
        nll += -lp[np.arange(len(targets)), targets].sum()
        count += len(targets)
        ppl = math.exp(nll / count)
        if output_type == 1:
            print(f"{count} {ppl:.4f}")
        elif progress:
            print(f"[{i + 1}/{n_chunk}] ppl = {ppl:.4f}", file=sys.stderr)
    return {"ppl": math.exp(nll / count), "nll": nll / count, "tokens": count}


def _ending_logprob(engine, ctx_tokens: list[int],
                    full_tokens: list[int]) -> float:
    """Sum log p of the tokens after the context (hellaswag_score method:
    one forward over ctx+ending, accumulate the ending's logprobs)."""
    engine.reset_slot(0)
    logits = engine.prefill(0, full_tokens, logits_all=True)
    lp = log_softmax(logits.astype(np.float64))
    start = len(ctx_tokens)
    tgt = np.asarray(full_tokens[start:], np.int64)
    return float(lp[np.arange(start - 1, len(full_tokens) - 1), tgt].sum())


def score_choices(engine, context: str, choices: list[str]) -> list[float]:
    tok = engine.tokenizer
    ctx_tokens = tok.encode(context, special=True)
    out = []
    for ch in choices:
        full = tok.encode(context + ch, special=True)
        if full[:len(ctx_tokens)] != ctx_tokens:      # boundary merge
            ctx2 = full[:len(ctx_tokens) - 1]
            out.append(_ending_logprob(engine, ctx2, full))
        else:
            out.append(_ending_logprob(engine, ctx_tokens, full))
    return out


def run_hellaswag(engine, path: str, limit: int = 0) -> dict:
    """JSONL tasks: {"ctx": str, "endings": [str...], "label": int}
    (hellaswag_score, perplexity.cpp:738)."""
    import json
    correct = total = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            t = json.loads(line)
            scores = score_choices(engine, t["ctx"],
                                   [" " + e.strip() for e in t["endings"]])
            correct += int(np.argmax(scores)) == int(t["label"])
            total += 1
            print(f"{total}\t{100.0 * correct / total:.4f}", file=sys.stderr)
            if limit and total >= limit:
                break
    return {"acc": correct / max(total, 1), "total": total}


def run_winogrande(engine, path: str, limit: int = 0) -> dict:
    """JSONL: {"sentence": "... _ ...", "option1","option2","answer":"1"|"2"}
    (winogrande_score, perplexity.cpp:977)."""
    import json
    correct = total = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            t = json.loads(line)
            scores = []
            for opt in (t["option1"], t["option2"]):
                pre, _, post = t["sentence"].partition("_")
                ctx = pre + opt
                full = ctx + post
                tokens_ctx = engine.tokenizer.encode(ctx, special=True)
                tokens_full = engine.tokenizer.encode(full, special=True)
                scores.append(_ending_logprob(engine, tokens_ctx,
                                              tokens_full))
            pick = int(np.argmax(scores)) + 1
            correct += pick == int(t["answer"])
            total += 1
            print(f"{total}\t{100.0 * correct / total:.4f}", file=sys.stderr)
            if limit and total >= limit:
                break
    return {"acc": correct / max(total, 1), "total": total}


def run_multiple_choice(engine, path: str, limit: int = 0) -> dict:
    """JSONL: {"question": str, "choices": [str...], "label": int}
    (multiple_choice_score, perplexity.cpp:1169)."""
    import json
    correct = total = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            t = json.loads(line)
            scores = score_choices(engine, t["question"],
                                   [" " + c for c in t["choices"]])
            correct += int(np.argmax(scores)) == int(t["label"])
            total += 1
            if limit and total >= limit:
                break
    return {"acc": correct / max(total, 1), "total": total}


def save_logits(engine, text: str, out_path: str, n_ctx: int = 512,
                max_chunks: int = 0, tokens: list | None = None) -> None:
    """Dump per-position log-probs for later KL comparison
    (--kl-divergence-base, perplexity.cpp:1461)."""
    tok = engine.tokenizer
    if tokens is None:
        tokens = tok.encode(text, add_bos=False)
    bos = tok.vocab.bos_id if tok is not None else 1
    n_chunk = len(tokens) // n_ctx
    if max_chunks:
        n_chunk = min(n_chunk, max_chunks)
    chunks, lps = [], []
    for i in range(n_chunk):
        chunk = ([bos] + tokens[i * n_ctx:(i + 1) * n_ctx])[:n_ctx]
        engine.reset_slot(0)
        logits = engine.prefill(0, chunk, logits_all=True)
        lps.append(log_softmax(logits.astype(np.float32)).astype(np.float16))
        chunks.append(np.asarray(chunk, np.int32))
    np.savez_compressed(out_path, n_ctx=n_ctx,
                        tokens=np.stack(chunks), logprobs=np.stack(lps))


def kl_divergence(engine, base_path: str) -> dict:
    """Mean KL(base || current) over the saved corpus + top-token agreement
    (perplexity.cpp kl_divergence :1525)."""
    z = np.load(base_path)
    base_lp = z["logprobs"].astype(np.float64)      # (C, T, V)
    toks = z["tokens"]
    kls, agree = [], []
    for c in range(toks.shape[0]):
        engine.reset_slot(0)
        logits = engine.prefill(0, list(toks[c]), logits_all=True)
        cur = log_softmax(logits.astype(np.float64))
        p = np.exp(base_lp[c])
        kls.append(np.sum(p * (base_lp[c] - cur), axis=-1))
        agree.append(base_lp[c].argmax(-1) == cur.argmax(-1))
    kls = np.concatenate(kls)
    agree = np.concatenate(agree)
    return {"kl_mean": float(kls.mean()), "kl_max": float(kls.max()),
            "kl_p99": float(np.percentile(kls, 99)),
            "top1_agree": float(agree.mean()), "tokens": int(kls.size)}


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-perplexity")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-f", "--file", help="raw text corpus")
    p.add_argument("-c", "--ctx-size", type=int, default=512)
    p.add_argument("-b", "--batch-size", type=int, default=512)
    p.add_argument("--compute-dtype", default=None)
    p.add_argument("--hellaswag", help="JSONL hellaswag tasks")
    p.add_argument("--hellaswag-tasks", type=int, default=0,
                   help="max hellaswag tasks (common.h hellaswag_tasks)")
    p.add_argument("--winogrande", help="JSONL winogrande tasks")
    p.add_argument("--multiple-choice", help="JSONL multiple-choice tasks")
    p.add_argument("--limit", type=int, default=0, help="max tasks/chunks")
    p.add_argument("--ppl-stride", type=int, default=0,
                   help="strided ppl windows (perplexity_v2 mode)")
    p.add_argument("--ppl-output-type", type=int, default=0, choices=(0, 1),
                   help="1 = cumulative '<tokens> <ppl>' pairs")
    p.add_argument("--save-logits", help="write base logprobs for KL")
    p.add_argument("--kl-divergence", "--kl-divergence-base",
                   dest="kl_divergence",
                   help="compare against saved logprobs")
    from tpulamm_torch.runtime.kvcache import KV_CACHE_TYPES
    p.add_argument("-ctk", "--cache-type-k", default="bfloat16",
                   choices=KV_CACHE_TYPES)
    p.add_argument("-ctv", "--cache-type-v", default=None,
                   choices=KV_CACHE_TYPES)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path)")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    from tpulamm_torch.runtime.engine import Engine
    engine = Engine(args.model, n_ctx=args.ctx_size + 1,
                    n_ubatch=args.batch_size,
                    compute_dtype=args.compute_dtype,
                    kv_dtype=args.cache_type_k,
                    kv_dtype_v=args.cache_type_v, device=args.device)

    if args.hellaswag:
        res = run_hellaswag(engine, args.hellaswag,
                            args.hellaswag_tasks or args.limit)
        print(f"hellaswag: acc = {100 * res['acc']:.4f}% "
              f"({res['total']} tasks)")
    elif args.winogrande:
        res = run_winogrande(engine, args.winogrande, args.limit)
        print(f"winogrande: acc = {100 * res['acc']:.4f}% "
              f"({res['total']} tasks)")
    elif args.multiple_choice:
        res = run_multiple_choice(engine, args.multiple_choice, args.limit)
        print(f"multiple-choice: acc = {100 * res['acc']:.4f}% "
              f"({res['total']} tasks)")
    elif args.kl_divergence:
        res = kl_divergence(engine, args.kl_divergence)
        print(f"KL(base||model): mean = {res['kl_mean']:.6f}, "
              f"p99 = {res['kl_p99']:.6f}, max = {res['kl_max']:.6f}, "
              f"top-1 agree = {100 * res['top1_agree']:.2f}% "
              f"({res['tokens']} tokens)")
    elif args.save_logits:
        if not args.file:
            p.error("--save-logits needs -f corpus")
        with open(args.file, errors="replace") as f:
            text = f.read()
        save_logits(engine, text, args.save_logits, n_ctx=args.ctx_size,
                    max_chunks=args.limit)
        print(f"saved base logprobs to {args.save_logits}")
    else:
        if not args.file:
            p.error("need -f corpus (or a task mode)")
        with open(args.file, errors="replace") as f:
            text = f.read()
        if args.ppl_stride > 0:
            res = compute_perplexity_v2(engine, text, n_ctx=args.ctx_size,
                                        stride=args.ppl_stride,
                                        output_type=args.ppl_output_type)
        else:
            res = compute_perplexity(engine, text, n_ctx=args.ctx_size)
        print(f"Final estimate: PPL = {res['ppl']:.4f}")
    print(engine.timings.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
