"""Text-generation CLI on the torch engine — the `main` tool equivalent
(examples/main/main.cpp; counterpart of tpulamm.cli.main).

    python -m tpulamm_torch.cli.main -m model.gguf -p "Hello" -n 32
    (add --device cpu to run the plain path without a GPU)

Flag names mirror gpt_params / common.cpp's parser where applicable so users
of the reference can switch directly:
  -m/--model, -p/--prompt, -n/--n-predict, -c/--ctx-size, -b/--batch-size,
  -s/--seed, --temp, --top-k, --top-p, --min-p, --tfs, --typical,
  --repeat-penalty, --repeat-last-n, --frequency-penalty, --presence-penalty,
  --mirostat, --mirostat-lr, --mirostat-ent, --ignore-eos, --grp-attn-n,
  --grp-attn-w, -i/--interactive, --color, --samplers

--lora applies a LoRA adapter GGUF at load (Engine(lora_path=)). --tp /
--dp build the engine on a mesh (every rank on --device); --coordinator /
--num-processes / --process-id run it over several processes, each
starting the same command (parallel.distributed).
"""

from __future__ import annotations

import argparse
import sys

from tpulamm_torch.cli._common import require_file
from tpulamm_torch.parallel.distributed import (add_distributed_args,
                                                init_from_args)
from tpulamm_torch.runtime.kvcache import KV_CACHE_TYPES
from tpulamm_torch.utils import log as logm


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpulamm-torch",
        description="GGUF text generation on the torch engine (llama.cpp "
                    "`main` parity)")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("-f", "--file", help="read prompt from file")
    p.add_argument("-n", "--n-predict", type=int, default=128)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("-b", "--batch-size", type=int, default=512)
    p.add_argument("-s", "--seed", type=int, default=-1)
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="accepted for reference-CLI compatibility (torch "
                        "owns threading)")
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--min-p", type=float, default=0.05)
    p.add_argument("--tfs", type=float, default=1.0)
    p.add_argument("--typical", type=float, default=1.0)
    p.add_argument("--repeat-penalty", type=float, default=1.1)
    p.add_argument("--repeat-last-n", type=int, default=64)
    p.add_argument("--frequency-penalty", type=float, default=0.0)
    p.add_argument("--presence-penalty", type=float, default=0.0)
    p.add_argument("--mirostat", type=int, default=0)
    p.add_argument("--mirostat-lr", type=float, default=0.1)
    p.add_argument("--mirostat-ent", type=float, default=5.0)
    p.add_argument("--samplers", default="kfypmt")
    p.add_argument("--ignore-eos", action="store_true")
    p.add_argument("--grp-attn-n", type=int, default=1)
    p.add_argument("--grp-attn-w", type=int, default=512)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks of the mesh (all on --device)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel (slot-sharding) mesh dimension")
    add_distributed_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--override-kv", action="append", default=[],
                   metavar="KEY=TYPE:VALUE",
                   help="override a GGUF metadata value "
                        "(e.g. llama.rope.freq_base=float:1000000)")
    p.add_argument("-ctk", "--cache-type-k", default="bfloat16",
                   choices=KV_CACHE_TYPES,
                   help="K cache storage type (q8_0 = int8 + row scales)")
    p.add_argument("-ctv", "--cache-type-v", default=None,
                   choices=KV_CACHE_TYPES,
                   help="V cache storage type (default: same as -ctk)")
    p.add_argument("--prompt-cache", default=None,
                   help="session file: reuse cached KV for a matching "
                        "prompt prefix (main.cpp:600-620)")
    p.add_argument("--prompt-cache-ro", action="store_true",
                   help="do not update the prompt cache file")
    p.add_argument("--cfg-negative-prompt", default=None,
                   help="negative prompt for classifier-free guidance")
    p.add_argument("--cfg-scale", type=float, default=1.0)
    p.add_argument("--lora", default=None,
                   help="apply a LoRA adapter GGUF at load time")
    p.add_argument("--grammar", default=None,
                   help="GBNF grammar constraining the output")
    p.add_argument("--grammar-file", default=None,
                   help="read GBNF grammar from file")
    p.add_argument("--compute-dtype", default=None,
                   choices=[None, "bfloat16", "float32"])
    p.add_argument("--mlock", action="store_true",
                   help="accepted for reference-CLI compatibility (weights "
                        "live in device memory)")
    p.add_argument("--no-display-prompt", action="store_true")
    p.add_argument("-i", "--interactive", action="store_true")
    p.add_argument("--keep", type=int, default=0,
                   help="tokens to keep from the initial prompt on context "
                        "shift (-1 = all prompt tokens)")
    p.add_argument("-e", "--escape", action="store_true",
                   help="process \\n, \\t, \\', \\\", \\\\ escapes in the "
                        "prompt")
    p.add_argument("-r", "--reverse-prompt", action="append", default=[],
                   help="stop generation when this string is emitted "
                        "(repeatable)")
    p.add_argument("--verbose-prompt", action="store_true",
                   help="print the tokenized prompt before generation")
    p.add_argument("--in-prefix", default="",
                   help="string prepended to interactive user input")
    p.add_argument("--in-suffix", default="",
                   help="string appended to interactive user input")
    logm.add_args(p)
    return p


def _process_escapes(s: str) -> str:
    """Exact port of common.cpp process_escapes: handles \\n \\r \\t
    \\' \\" \\\\ and \\xHH byte escapes, character-wise — no
    encoding round-trips, so non-ASCII text passes through untouched."""
    out: list[str] = []
    mapping = {"n": "\n", "r": "\r", "t": "\t", "'": "'",
               '"': '"', "\\": "\\"}
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt in mapping:
                out.append(mapping[nxt])
                i += 2
                continue
            if nxt == "x" and i + 3 < len(s):
                try:
                    out.append(chr(int(s[i + 2:i + 4], 16)))
                    i += 4
                    continue
                except ValueError:
                    pass
        out.append(c)
        i += 1
    return "".join(out)


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_file(build_parser(), args.model)
    logm.setup(args, "main")
    logm.log(f"args: {vars(args)}")
    init_from_args(args)

    from tpulamm_torch.models.loader import parse_kv_override
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.sampling import SamplingParams

    prompt = args.prompt
    if args.file:
        with open(args.file) as f:
            prompt = f.read()
    if args.escape:
        prompt = _process_escapes(prompt)

    overrides = dict(parse_kv_override(s) for s in args.override_kv) or None
    engine = Engine(args.model, n_ctx=args.ctx_size, n_ubatch=args.batch_size,
                    n_slots=2 if args.cfg_negative_prompt else 1,
                    compute_dtype=args.compute_dtype,
                    kv_dtype=args.cache_type_k,
                    kv_dtype_v=args.cache_type_v,
                    grp_attn_n=args.grp_attn_n, grp_attn_w=args.grp_attn_w,
                    lora_path=args.lora, kv_overrides=overrides,
                    tp=args.tp, dp=args.dp, device=args.device)

    sampling = SamplingParams(
        seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
        temp=args.temp, top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        tfs_z=args.tfs, typical_p=args.typical,
        penalty_repeat=args.repeat_penalty, penalty_last_n=args.repeat_last_n,
        penalty_freq=args.frequency_penalty,
        penalty_present=args.presence_penalty,
        mirostat=args.mirostat, mirostat_eta=args.mirostat_lr,
        mirostat_tau=args.mirostat_ent,
        samplers_sequence=args.samplers, ignore_eos=args.ignore_eos,
    )

    grammar = args.grammar
    if args.grammar_file:
        with open(args.grammar_file) as f:
            grammar = f.read()

    def run_once(text: str):
        if not args.no_display_prompt:
            sys.stdout.write(text)
            sys.stdout.flush()
        gen_input: str | list[int] = text
        all_tokens: list[int] = []
        if engine.tokenizer is not None:
            ptoks = engine.tokenizer.encode(text, special=True)
            if args.verbose_prompt:
                for t in ptoks:
                    print(f"{t:6d} -> "
                          f"{engine.tokenizer.token_to_piece(t)!r}",
                          file=sys.stderr)
            # --keep: -1 = whole prompt (main.cpp:224-227)
            engine.n_keep = (len(ptoks) if args.keep < 0
                             else args.keep if args.keep > 0
                             else engine.n_keep)
        # reverse prompts (antiprompt, main.cpp:745-767): watch the
        # streamed tail and abort generation when one appears
        state = {"tail": "", "hit": False}

        def on_piece(piece):
            sys.stdout.write(piece)
            sys.stdout.flush()
            if args.reverse_prompt:
                state["tail"] = (state["tail"] + piece)[-256:]
                if any(rp in state["tail"] for rp in args.reverse_prompt):
                    state["hit"] = True

        prev_abort = engine.abort_callback
        if args.reverse_prompt:
            engine.set_abort_callback(lambda: state["hit"])
        if args.prompt_cache and engine.tokenizer is not None:
            from tpulamm_torch.runtime.session import load_session
            all_tokens = ptoks          # already tokenized above
            # process 0 of a mesh decides whether the file is there
            saved = load_session(args.prompt_cache, engine, missing_ok=True)
            if saved is not None:
                n = 0
                while (n < min(len(saved), len(all_tokens)) - 1
                       and saved[n] == all_tokens[n]):
                    n += 1
                if engine.recurrent and n != int(engine.n_past[0]):
                    # a recurrent state cannot be rolled back to a shorter
                    # prefix; only an exact-state continuation is reusable
                    engine.reset_slot(0)
                    gen_input = all_tokens
                elif n > 0:
                    # keep the matching prefix's KV, re-eval the rest
                    # (prompt-cache prefix reuse, main.cpp:600-620)
                    if not engine.recurrent:
                        engine.rollback(0, n)
                    gen_input = all_tokens[n:]
                    print(f"prompt cache: reusing {n} of "
                          f"{len(all_tokens)} prompt tokens",
                          file=sys.stderr)
                else:
                    engine.reset_slot(0)
                    gen_input = all_tokens
            else:
                gen_input = all_tokens
        ids, _ = engine.generate(
            gen_input, n_predict=args.n_predict, sampling=sampling,
            grammar=grammar,
            cfg_negative_prompt=args.cfg_negative_prompt,
            cfg_scale=args.cfg_scale,
            stream=on_piece)
        engine.abort_callback = prev_abort
        if args.prompt_cache and not args.prompt_cache_ro \
                and engine.tokenizer is not None:
            from tpulamm_torch.runtime.session import save_session
            save_session(args.prompt_cache, engine,
                         tokens=all_tokens + ids)
        sys.stdout.write("\n")

    if args.interactive:
        print("== interactive mode; empty line or Ctrl-D to exit ==",
              file=sys.stderr)
        while True:
            try:
                line = input("> ")
            except EOFError:
                break
            if not line:
                break
            run_once(args.in_prefix + line + args.in_suffix)
            engine.reset_slot(0)
    else:
        run_once(prompt)

    logm.log_tee("\n" + engine.timings.report())
    if args.logdir:
        logm.dump_yaml(args.logdir, "main",
                       {"model": args.model, "n_predict": args.n_predict,
                        "ctx_size": args.ctx_size, "seed": args.seed,
                        **logm.timings_record(engine.timings)})
    logm.close_file()
    return 0


if __name__ == "__main__":
    sys.exit(main())
