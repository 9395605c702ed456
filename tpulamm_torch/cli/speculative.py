"""Speculative / prompt-lookup decoding CLI (counterpart of
tpulamm.cli.speculative; --device cpu runs the plain path).

Tool parity with examples/speculative (draft model, -md) and
examples/lookup (prompt n-gram speculation) from the reference. Prints the
generation plus draft acceptance statistics, as those tools do.

    python -m tpulamm_torch.cli.speculative -m target.gguf -md draft.gguf \
        -p "..." --ondevice
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpulamm-torch-speculative",
        description="speculative decoding (draft model or prompt lookup)")
    p.add_argument("-m", "--model", required=True, help="target model GGUF")
    p.add_argument("-md", "--model-draft", default=None,
                   help="draft model GGUF (omit for prompt-lookup mode)")
    p.add_argument("--lookahead", action="store_true",
                   help="lookahead decoding (Jacobi window + n-gram pool; "
                        "examples/lookahead parity)")
    p.add_argument("-lw", "--lookahead-w", type=int, default=8)
    p.add_argument("-ln", "--lookahead-n", type=int, default=4)
    p.add_argument("-lg", "--lookahead-g", type=int, default=8)
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("-n", "--n-predict", type=int, default=128)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--draft", type=int, default=5,
                   help="number of tokens to draft per step")
    p.add_argument("-np", "--n-seq-dft", type=int, default=1,
                   help=">1 enables draft-TREE speculation with this many "
                        "branches (speculative.cpp n_seq_dft)")
    p.add_argument("--p-split", type=float, default=0.1,
                   help="draft branch split probability threshold "
                        "(speculative.cpp p_split)")
    p.add_argument("--ngram-min", type=int, default=1)
    p.add_argument("--ngram-max", type=int, default=4)
    p.add_argument("--temp", type=float, default=0.0)
    p.add_argument("-s", "--seed", type=int, default=-1)
    p.add_argument("--ignore-eos", action="store_true")
    p.add_argument("--ondevice", action="store_true",
                   help="run the whole draft/verify/accept loop on device "
                        "(one dispatch per block; no streaming). With -md "
                        "uses the draft model, without -md uses n-gram "
                        "prompt lookup")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(build_parser(), args.model)
    require_file(build_parser(), args.model_draft, "draft model")
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.sampling import SamplingParams
    from tpulamm_torch.runtime.speculative import (generate_prompt_lookup,
                                                   generate_speculative)

    sampling = SamplingParams(
        temp=args.temp, ignore_eos=args.ignore_eos,
        seed=args.seed if args.seed >= 0 else 0xFFFFFFFF)
    target = Engine(args.model, n_ctx=args.ctx_size, device=args.device)
    stream = lambda piece: (sys.stdout.write(piece), sys.stdout.flush())  # noqa: E731
    sys.stdout.write(args.prompt)

    if args.lookahead:
        from tpulamm_torch.runtime.lookahead import generate_lookahead
        _, _, stats = generate_lookahead(
            target, args.prompt, n_predict=args.n_predict, sampling=sampling,
            W=args.lookahead_w, N=args.lookahead_n, G=args.lookahead_g,
            stream=stream)
    elif args.ondevice and not args.model_draft:
        from tpulamm_torch.runtime.speculative import (
            generate_prompt_lookup_fast)
        _, text, stats = generate_prompt_lookup_fast(
            target, args.prompt, n_predict=args.n_predict,
            n_draft=args.draft, ngram_min=args.ngram_min,
            ngram_max=args.ngram_max, temp=args.temp,
            seed=max(args.seed, 0), stop_on_eos=not args.ignore_eos)
        sys.stdout.write(text)
    elif args.model_draft and args.n_seq_dft > 1:
        # draft-TREE speculation (always on device)
        from tpulamm_torch.runtime.spec_tree import generate_speculative_tree
        draft = Engine(args.model_draft, n_ctx=args.ctx_size,
                       device=args.device)
        _, text, stats = generate_speculative_tree(
            target, draft, args.prompt, n_predict=args.n_predict,
            n_draft=args.draft, n_seq_dft=args.n_seq_dft,
            p_split=args.p_split, temp=args.temp, seed=max(args.seed, 0),
            stop_on_eos=not args.ignore_eos)
        sys.stdout.write(text)
    elif args.model_draft and args.ondevice:
        from tpulamm_torch.runtime.speculative import (
            generate_speculative_fast)
        draft = Engine(args.model_draft, n_ctx=args.ctx_size,
                       device=args.device)
        _, text, stats = generate_speculative_fast(
            target, draft, args.prompt, n_predict=args.n_predict,
            n_draft=args.draft, temp=args.temp, seed=max(args.seed, 0),
            stop_on_eos=not args.ignore_eos)
        sys.stdout.write(text)
    elif args.model_draft:
        draft = Engine(args.model_draft, n_ctx=args.ctx_size,
                       device=args.device)
        _, _, stats = generate_speculative(
            target, draft, args.prompt, n_predict=args.n_predict,
            sampling=sampling, n_draft=args.draft, stream=stream)
    else:
        _, _, stats = generate_prompt_lookup(
            target, args.prompt, n_predict=args.n_predict, sampling=sampling,
            n_draft=args.draft, ngram_min=args.ngram_min,
            ngram_max=args.ngram_max, stream=stream)

    print()
    print(f"n_drafted = {stats.n_drafted}, n_accepted = {stats.n_accepted}, "
          f"accept rate = {stats.accept_rate:.3f}, "
          f"target steps = {stats.n_target_steps}", file=sys.stderr)
    print("\n" + target.timings.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
