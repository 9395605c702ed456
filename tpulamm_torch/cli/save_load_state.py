"""save-load-state: state serialization round-trip check on the torch
engine (counterpart of tpulamm.cli.save_load_state).

The reference smoke test (examples/save-load-state/save-load-state.cpp):
evaluate a prompt, snapshot the full state (KV cache + token history),
generate a continuation, then restore the snapshot in a FRESH engine and
generate again — the two continuations must be identical.

    python -m tpulamm_torch.cli.save_load_state -m model.gguf -n 16
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def _greedy(eng, first_logits, n: int) -> list[int]:
    out = [int(np.argmax(first_logits))]
    for _ in range(n - 1):
        out.append(int(np.argmax(eng.decode_one(0, out[-1]))))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-save-load-state")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-p", "--prompt", default="The quick brown fox")
    p.add_argument("-n", "--n-predict", type=int, default=16)
    p.add_argument("-c", "--ctx-size", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--session", default=None,
                   help="session file path (default: a temp file)")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.session import load_session, save_session

    path = args.session or os.path.join(tempfile.mkdtemp(), "state.bin")

    eng = Engine(args.model, n_ctx=args.ctx_size, device=args.device)
    if eng.tokenizer is None:
        p.error(f"{args.model} has no tokenizer vocab")
    toks = eng.tokenizer.encode(args.prompt, add_bos=True)
    logits = eng.prefill(0, toks)
    save_session(path, eng, toks)
    print(f"saved state after {len(toks)} prompt tokens -> {path} "
          f"({os.path.getsize(path)} bytes)", file=sys.stderr)
    run1 = _greedy(eng, logits, args.n_predict)
    print("first run :", eng.tokenizer.decode(run1))

    eng2 = Engine(args.model, n_ctx=args.ctx_size, device=args.device)
    restored = load_session(path, eng2)
    if restored != list(toks):
        print("FAIL: restored token history differs", file=sys.stderr)
        return 1
    # re-derive the last logits from the restored KV (rewind one token)
    eng2.rollback(0, len(toks) - 1)
    logits2 = eng2.decode_one(0, toks[-1])
    run2 = _greedy(eng2, logits2, args.n_predict)
    print("second run:", eng2.tokenizer.decode(run2))

    if run1 == run2:
        print("OK: continuations match after state reload", file=sys.stderr)
        return 0
    print("FAIL: continuations differ", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
