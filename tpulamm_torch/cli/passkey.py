"""Passkey retrieval demo on the torch engine — examples/passkey parity
(302 LoC; counterpart of tpulamm.cli.passkey; --device cpu runs the plain
path).

Buries a random passkey inside junk filler text, then generates with
self-extend grouped attention (--grp-attn-n/--grp-attn-w position surgery,
main.cpp:575-598) so the effective context compresses into the trained
window. Demonstrates/exercises the long-context machinery end-to-end.
"""

from __future__ import annotations

import argparse
import random
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="tpulamm-torch-passkey")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--n-junk", type=int, default=60,
                   help="junk sentences around the passkey")
    p.add_argument("--passkey", type=int, default=-1)
    p.add_argument("--pos", type=int, default=-1,
                   help="junk index to insert the passkey at")
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--grp-attn-n", type=int, default=4)
    p.add_argument("--grp-attn-w", type=int, default=256)
    p.add_argument("-n", "--n-predict", type=int, default=24)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(build_parser(), args.model)
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.sampling import SamplingParams

    passkey = args.passkey if args.passkey >= 0 else random.randint(1, 50000)
    pos = args.pos if args.pos >= 0 else random.randint(0, args.n_junk - 1)
    junk = ("The grass is green. The sky is blue. The sun is yellow. "
            "Here we go. There and back again. ")
    prompt = ("There is an important info hidden inside a lot of irrelevant "
              "text. Find it and memorize them. I will quiz you about the "
              "important information there.\n")
    for i in range(args.n_junk):
        if i == pos:
            prompt += (f" The pass key is {passkey}. Remember it. "
                       f"{passkey} is the pass key.")
        prompt += junk
    prompt += "\n What is the pass key? The pass key is"

    engine = Engine(args.model, n_ctx=args.ctx_size,
                    grp_attn_n=args.grp_attn_n, grp_attn_w=args.grp_attn_w,
                    device=args.device)
    n_tokens = len(engine.tokenizer.encode(prompt, special=True))
    print(f"passkey = {passkey} at junk position {pos}; prompt is "
          f"{n_tokens} tokens, n_ctx {args.ctx_size}, "
          f"grp_attn_n {args.grp_attn_n}", file=sys.stderr)
    _, text = engine.generate(
        prompt, n_predict=args.n_predict,
        sampling=SamplingParams(temp=0.0),
        stream=lambda piece: (sys.stdout.write(piece), sys.stdout.flush()))
    print()
    ok = str(passkey) in text
    print(f"[{'OK' if ok else 'MISS'}] expected {passkey}", file=sys.stderr)
    print(engine.timings.report(), file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
