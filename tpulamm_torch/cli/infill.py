"""Fill-in-the-middle (FIM) CLI on the torch engine — examples/infill
parity (counterpart of tpulamm.cli.infill; --device cpu runs the plain
path).

Builds the infill prompt from the model's special FIM tokens
(tokenizer.ggml.{prefix,suffix,middle}_token_id; llama_token_prefix/
suffix/middle, llama.h:828-831):  <PRE> prefix <SUF> suffix <MID> ...
and generates until EOT/EOS.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="tpulamm-torch-infill")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--in-prefix", required=True, help="text before the hole")
    p.add_argument("--in-suffix", required=True, help="text after the hole")
    p.add_argument("-n", "--n-predict", type=int, default=64)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--temp", type=float, default=0.2)
    p.add_argument("-s", "--seed", type=int, default=-1)
    return p


def infill_tokens(engine, prefix: str, suffix: str) -> list[int]:
    md = engine.metadata
    tok = engine.tokenizer
    pre = md.get("tokenizer.ggml.prefix_token_id")
    suf = md.get("tokenizer.ggml.suffix_token_id")
    mid = md.get("tokenizer.ggml.middle_token_id")
    if pre is None or suf is None or mid is None:
        raise SystemExit("model has no FIM tokens "
                         "(tokenizer.ggml.{prefix,suffix,middle}_token_id)")
    out = []
    if tok.vocab.add_bos and tok.vocab.bos_id >= 0:
        out.append(tok.vocab.bos_id)
    out.append(int(pre))
    out += tok.encode(prefix, add_bos=False)
    out.append(int(suf))
    out += tok.encode(suffix, add_bos=False)
    out.append(int(mid))
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(build_parser(), args.model)
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.sampling import SamplingParams

    engine = Engine(args.model, n_ctx=args.ctx_size, device=args.device)
    tokens = infill_tokens(engine, args.in_prefix, args.in_suffix)
    eot = engine.metadata.get("tokenizer.ggml.eot_token_id",
                              engine.tokenizer.vocab.eos_id)
    sampling = SamplingParams(
        temp=args.temp, seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
        logit_bias={})
    engine.generate(
        tokens, n_predict=args.n_predict, sampling=sampling,
        stop_tokens={int(eot)},    # generation (and streaming) stop at EOT
        stream=lambda piece: (sys.stdout.write(piece), sys.stdout.flush()))
    print()
    print(engine.timings.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
