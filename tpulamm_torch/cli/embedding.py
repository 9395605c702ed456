"""Sentence-embedding CLI on the torch engine (examples/embedding parity;
counterpart of tpulamm.cli.embedding; --device cpu runs the plain path).

Embeds one or more prompts and prints the vectors; with several prompts it
also prints the cosine-similarity matrix, as the reference example does.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="tpulamm-torch-embedding")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-p", "--prompt", action="append", default=[],
                   help="prompt to embed (repeatable)")
    p.add_argument("-f", "--file", help="file with one prompt per line")
    p.add_argument("--pooling", choices=["mean", "cls", "last"], default=None)
    p.add_argument("-c", "--ctx-size", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--json", action="store_true", help="JSON output")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(build_parser(), args.model)
    from tpulamm_torch.runtime.engine import Engine

    prompts = list(args.prompt)
    if args.file:
        with open(args.file) as f:
            prompts += [ln.strip() for ln in f if ln.strip()]
    if not prompts:
        print("no prompts given (-p/-f)", file=sys.stderr)
        return 1

    engine = Engine(args.model, n_ctx=args.ctx_size, device=args.device)
    embs = np.stack([engine.embed(p, pooling=args.pooling) for p in prompts])

    if args.json:
        import json
        print(json.dumps({"embeddings": embs.tolist()}))
        return 0
    for p, e in zip(prompts, embs):
        head = " ".join(f"{x:.6f}" for x in e[:8])
        print(f"embedding ({len(e)} dims): {head} ...  | {p[:40]!r}")
    if len(prompts) > 1:
        norm = embs / np.linalg.norm(embs, axis=1, keepdims=True)
        sim = norm @ norm.T
        print("\ncosine similarity:")
        for i, row in enumerate(sim):
            print("  " + " ".join(f"{x:6.3f}" for x in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
