"""beam-search: decode with llama_beam_search semantics
(examples/beam-search/beam-search.cpp, 262 LoC) on the torch engine
(counterpart of tpulamm.cli.beam_search).

    python -m tpulamm_torch.cli.beam_search -m model.gguf -p "prompt" -b 4 -n 64
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-beam-search")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-p", "--prompt",
                   default="The quick brown fox")
    p.add_argument("-b", "--n-beams", type=int, default=2,
                   help="beam width (each beam occupies an engine slot)")
    p.add_argument("-n", "--n-predict", type=int, default=64)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    from tpulamm_torch.runtime.beam import beam_search
    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(args.model, n_ctx=args.ctx_size, n_slots=args.n_beams,
                 device=args.device)
    if eng.tokenizer is None:
        p.error(f"{args.model} has no tokenizer vocab")

    t0 = time.perf_counter()
    ids, score = beam_search(eng, args.prompt, n_beams=args.n_beams,
                             n_predict=args.n_predict)
    dt = time.perf_counter() - t0
    print(args.prompt, end="")
    print(eng.tokenizer.decode(ids))
    print(f"\n{len(ids)} tokens, {args.n_beams} beams, "
          f"logprob/token {score:.4f}, {dt:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
