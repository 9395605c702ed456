"""Tokenize/detokenize CLI (examples/tokenize parity; counterpart of
tpulamm.cli.tokenize).

    python -m tpulamm_torch.cli.tokenize -m MODEL.gguf -p TEXT [--ids]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-tokenize")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-p", "--prompt", default=None)
    p.add_argument("-f", "--file", default=None)
    p.add_argument("--ids", action="store_true",
                   help="print bare ids only (one line)")
    p.add_argument("--no-bos", action="store_true")
    p.add_argument("--decode", default=None,
                   help="comma-separated ids to detokenize instead")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    from tpulamm_torch.gguf.reader import GGUFReader
    from tpulamm_torch.tokenizer.spm import build_tokenizer
    md = GGUFReader(args.model).metadata
    tok = build_tokenizer(md)

    if args.decode is not None:
        ids = [int(t) for t in args.decode.split(",") if t.strip()]
        print(tok.decode(ids, special=True))
        return 0

    text = args.prompt
    if args.file:
        with open(args.file, errors="replace") as f:
            text = f.read()
    if text is None:
        print("need -p or -f", file=sys.stderr)
        return 1
    ids = tok.encode(text, special=True,
                     add_bos=False if args.no_bos else None)
    if args.ids:
        print(" ".join(str(i) for i in ids))
    else:
        for i in ids:
            piece = tok.token_to_piece(i, special=True)
            print(f"{i:>8} -> {piece!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
