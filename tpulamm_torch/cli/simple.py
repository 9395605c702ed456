"""simple: the minimal generation example (examples/simple/simple.cpp) on
the torch engine.

Loads a model, evaluates a prompt, greedy-decodes n tokens, and prints
throughput.

    python -m tpulamm_torch.cli.simple -m model.gguf -p "Hello my name is" -n 32
    (add --device cpu to run the plain path without a GPU)
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-simple")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-p", "--prompt", default="Hello my name is")
    p.add_argument("-n", "--n-predict", type=int, default=32)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(args.model, n_ctx=args.ctx_size, device=args.device)
    if eng.tokenizer is None:
        p.error(f"{args.model} has no tokenizer vocab")

    t0 = time.perf_counter()
    ids, text = eng.generate_fast(args.prompt, n_predict=args.n_predict,
                                  temp=0.0)
    dt = time.perf_counter() - t0
    print(args.prompt, end="")
    print(text)
    n = len(ids)
    print(f"\ndecoded {n} tokens in {dt:.2f}s, speed: {n / dt:.2f} t/s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
