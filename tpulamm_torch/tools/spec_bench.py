"""Speculative-decoding benchmark on a trained model pair (counterpart of
tpulamm.tools.spec_bench).

Single-stream decode streams the weights once a token; speculative
decoding scores k+1 tokens for about one token's weight traffic, so its
rate multiplies by the tokens emitted a target step (1 + accepted).
Random-weight models accept at chance, so this tool trains a small target
and a smaller draft on the same corpus (quality_table's: the repository's
prose, bytes + 3) and measures, on held-out text prompts:

  - plain decode (generate_fast) on the target,
  - on-device speculation (runtime.speculative.generate_speculative_fast,
    prompt lookup, optionally the draft tree) at several draft lengths,
    with their accept rates.

Reference analogue: examples/speculative (speculative.cpp), whose win
likewise depends on a real model pair.

    python -m tpulamm_torch.tools.spec_bench [--steps 1500] [-o out.json]

Models are cached in tmp_bench/ (spec_target_f32.gguf, spec_draft_f32.gguf,
spec_target_q4_0.gguf); delete to retrain. At temp > 0 the JAX tool adds a
token-match row through its TPULAMM_SPEC_TOKEN_MATCH switch, which the
port does not copy (runtime.speculative): that row is left out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def ensure_models(steps: int, out_dir: str = "tmp_bench", big: bool = False,
                  log=print, device=None):
    """Train (when missing) the target and the draft and quantize the
    target to Q4_0; device: the training's (default "cuda")."""
    from tpulamm_torch.cli.quantize import quantize_file
    from tpulamm_torch.gguf.constants import GGMLType
    from tpulamm_torch.tools.quality_table import build_corpus, train_model

    os.makedirs(out_dir, exist_ok=True)
    name = "spec_big" if big else "spec_target"
    tgt = os.path.join(out_dir, f"{name}_f32.gguf")
    drf = os.path.join(out_dir, "spec_draft_f32.gguf")
    tgt_q4 = os.path.join(out_dir, f"{name}_q4_0.gguf")
    corpus = build_corpus()
    if not os.path.exists(tgt):
        if big:
            # ~520M params (dim 1536, 20 layers): decode on this target is
            # weight-streaming-bound like the 1.1B/7B bench models;
            # remat + batch 8 keep the AdamW state + activations in memory
            train_model(tgt, dim=1536, n_layers=20, n_heads=12,
                        n_kv_heads=6, ffn=4096, n_steps=steps,
                        batch_size=8, remat=True, corpus=corpus, log=log,
                        device=device)
        else:
            # same shape as the quality-table model (dim 512, 8 layers, ~30M)
            train_model(tgt, n_steps=steps, corpus=corpus, log=log,
                        device=device)
    if not os.path.exists(drf):
        # a draft of dim 256, 2 layers (64-dim heads): k proposals cost
        # well under one target step
        train_model(drf, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                    ffn=704, n_steps=min(steps, 1500), corpus=corpus,
                    log=log, device=device)
    if not os.path.exists(tgt_q4):
        quantize_file(tgt, tgt_q4, GGMLType.Q4_0)
    return tgt, drf, tgt_q4, corpus


def bench_pair(tgt_path: str, drf_path: str, corpus: bytes, *,
               n_predict: int = 256, drafts=(0, 3, 5, 8), n_ctx: int = 1024,
               lookup: bool = True, tree: bool = False,
               p_split: float = 0.1, temp: float = 0.0,
               log=print, device=None) -> list[dict]:
    """One row a (draft length, mode): the best decode tok/s over 3 runs
    after a warm-up run (Engine.timings.t_eval), the best wall tok/s,
    the accept rate and the tokens a target step."""
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.speculative import (
        generate_prompt_lookup_fast, generate_speculative_fast)

    target = Engine(tgt_path, n_ctx=n_ctx, device=device)
    draft = Engine(drf_path, n_ctx=n_ctx, device=device)
    # held-out prompt: tail 5% of the corpus (train used the first 95%)
    tail = corpus[int(len(corpus) * 0.95):]
    prompt = tail[1000:1250].decode("utf-8", "replace")

    def timed(fn):
        """Best decode-phase tok/s over the runs (Engine.timings.t_eval —
        the per-token generation rate, prefill/tokenize excluded, same
        convention as llama_print_timings "eval time") + wall tok/s."""
        best = best_wall = 0.0
        st = None
        for _ in range(3):
            e0, n0 = target.timings.t_eval, target.timings.n_eval
            t0 = time.perf_counter()
            out, stats = fn()
            wall = len(out) / (time.perf_counter() - t0)
            de = target.timings.t_eval - e0
            ts = (target.timings.n_eval - n0) / de if de > 0 else 0.0
            if ts > best:
                best, st = ts, stats
            best_wall = max(best_wall, wall)
        return best, best_wall, st

    def row(k, mode, ts, wall, st):
        r = {"n_draft": k, "tok_s": ts, "wall_tok_s": wall, "mode": mode,
             "accept": st.accept_rate if st else None}
        if st:
            r["tok_per_step"] = 1 + st.n_accepted / max(st.n_target_steps, 1)
        rows.append(r)
        log(json.dumps(r))

    rows = []
    if lookup:
        for k in drafts:
            if k == 0:
                continue
            generate_prompt_lookup_fast(target, prompt, n_predict=n_predict,
                                        n_draft=k, temp=0.0,
                                        stop_on_eos=False)          # warm
            ts, wall, st = timed(lambda: generate_prompt_lookup_fast(
                target, prompt, n_predict=n_predict, n_draft=k,
                temp=0.0, stop_on_eos=False)[::2])
            row(k, "on-device prompt lookup", ts, wall, st)
    for k in drafts:
        if k == 0:
            target.reset_slot(0)
            target.generate_fast(prompt, n_predict=n_predict, temp=temp,
                                 stop_on_eos=False)      # warm (capture)

            def plain():
                target.reset_slot(0)
                out, _ = target.generate_fast(prompt, n_predict=n_predict,
                                              temp=temp, stop_on_eos=False)
                return out, None
            ts, wall, _ = timed(plain)
            row(0, "plain generate_fast", ts, wall, None)
        else:
            generate_speculative_fast(target, draft, prompt,
                                      n_predict=n_predict, n_draft=k,
                                      temp=temp, stop_on_eos=False)  # warm
            ts, wall, st = timed(lambda: generate_speculative_fast(
                target, draft, prompt, n_predict=n_predict, n_draft=k,
                temp=temp, stop_on_eos=False)[::2])
            mode = ("on-device speculative stochastic" if temp > 0.0
                    else "on-device speculative")
            row(k, mode, ts, wall, st)
    if tree:
        from tpulamm_torch.runtime.spec_tree import generate_speculative_tree
        for k in drafts:
            if k == 0:
                continue
            for nsd in (2, 4):
                generate_speculative_tree(
                    target, draft, prompt, n_predict=n_predict, n_draft=k,
                    n_seq_dft=nsd, p_split=p_split, temp=0.0,
                    stop_on_eos=False)                              # warm
                ts, wall, st = timed(lambda: generate_speculative_tree(
                    target, draft, prompt, n_predict=n_predict, n_draft=k,
                    n_seq_dft=nsd, p_split=p_split, temp=0.0,
                    stop_on_eos=False)[::2])
                row(k, f"on-device draft-tree nsd={nsd}", ts, wall, st)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpulamm-torch-spec-bench")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("-n", "--n-predict", type=int, default=256)
    p.add_argument("--drafts", default="0,3,5,8")
    p.add_argument("--f32", action="store_true",
                   help="bench the f32 target instead of Q4_0")
    p.add_argument("-m", "--model", default=None,
                   help="override the target GGUF (still uses the trained "
                        "draft + corpus prompt)")
    p.add_argument("--no-lookup", action="store_true")
    p.add_argument("--tree", action="store_true",
                   help="also bench draft-TREE speculation (n_seq_dft 2/4)")
    p.add_argument("--p-split", type=float, default=0.1)
    p.add_argument("--temp", type=float, default=0.0,
                   help="sampling temperature: >0 benches STOCHASTIC "
                        "speculative sampling")
    p.add_argument("--big", action="store_true",
                   help="use the ~520M weight-streaming-bound target "
                        "(trains it on first use; --steps applies)")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path)")
    args = p.parse_args(argv)
    tgt, drf, tgt_q4, corpus = ensure_models(args.steps, big=args.big,
                                             device=args.device)
    target = args.model or (tgt if args.f32 else tgt_q4)
    rows = bench_pair(target, drf, corpus, n_predict=args.n_predict,
                      lookup=not args.no_lookup, tree=args.tree,
                      p_split=args.p_split, temp=args.temp,
                      drafts=tuple(int(x) for x in args.drafts.split(",")),
                      device=args.device)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
