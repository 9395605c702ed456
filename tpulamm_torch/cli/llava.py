"""llava: multimodal (image + text) generation on the torch engine
(counterpart of tpulamm.cli.llava, examples/llava/llava-cli.cpp).

Splits the prompt at "<image>", evaluates the text before it, splices the
CLIP-projected image embeddings into the stream (Engine.eval_embeds, the
llama_batch.embd path), evaluates the trailing text, then decodes with the
host Sampler. An mmproj with image_grid_pinpoints takes llava-1.6's anyres
path (models.clip.encode_image_anyres).

    python -m tpulamm_torch.cli.llava -m llava-llama.gguf \
        --mmproj mmproj.gguf --image photo.npy \
        -p "USER: <image>\ndescribe ANSWER:" -n 128
    (add --device cpu to run the plain path without a GPU)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-llava")
    p.add_argument("-m", "--model", required=True, help="language model GGUF")
    p.add_argument("--mmproj", required=True,
                   help="CLIP vision tower + projector GGUF")
    p.add_argument("--image", required=True, action="append", default=None,
                   help="image file (.npy, .ppm, or any format PIL reads "
                        "where PIL is installed; repeatable, each fills one "
                        "<image>)")
    p.add_argument("-p", "--prompt",
                   default="USER: <image>\ndescribe the image ASSISTANT:")
    p.add_argument("-n", "--n-predict", type=int, default=128)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--temp", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    args = p.parse_args(argv)

    from tpulamm_torch.models.clip import (encode_image, encode_image_anyres,
                                           load_clip, load_image,
                                           preprocess_image)
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.sampling import Sampler, SamplingParams

    parts = args.prompt.split("<image>")
    n_imgs = len(args.image)
    if len(parts) - 1 != n_imgs:
        # llava-cli behavior: no marker -> image goes before the prompt
        if len(parts) == 1 and n_imgs == 1:
            parts = ["", parts[0]]
        else:
            p.error(f"prompt has {len(parts) - 1} <image> markers "
                    f"but {n_imgs} --image args")
    for path in (args.model, args.mmproj, *args.image):
        if not os.path.isfile(path):
            p.error(f"file not found: {path}")

    t0 = time.perf_counter()
    ccfg, cparams = load_clip(args.mmproj, device=args.device)
    embeds = []
    for path in args.image:
        if ccfg.image_grid_pinpoints:
            # llava-1.6 anyres grid (clip.cpp pinpoints path)
            emb = encode_image_anyres(ccfg, cparams, load_image(path))
        else:
            img = preprocess_image(load_image(path), ccfg)
            emb = encode_image(ccfg, cparams, img[None])[0].cpu().numpy()
        embeds.append(emb)
    if args.verbose:
        print(f"encoded {n_imgs} image(s) -> "
              f"{[e.shape for e in embeds]} in "
              f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)

    eng = Engine(args.model, n_ctx=args.ctx_size, device=args.device)
    if eng.tokenizer is None:
        p.error(f"{args.model} has no tokenizer vocab (not a llava "
                "language model?)")
    if embeds[0].shape[1] != eng.cfg.dim:
        p.error(f"mmproj projects to {embeds[0].shape[1]} dims but the "
                f"model embedding size is {eng.cfg.dim} — mismatched "
                "model/mmproj pair")
    need = sum(e.shape[0] for e in embeds) + len(args.prompt) // 2
    if need > args.ctx_size:
        p.error(f"context too small: ~{need} positions needed, "
                f"have {args.ctx_size} (-c)")

    # interleaved eval: text / image / text / ...
    # (llava-cli.cpp:process_prompt)
    logits = None
    for i, part in enumerate(parts):
        toks = eng.tokenizer.encode(part, add_bos=(i == 0))
        if toks:
            logits = eng.prefill(0, toks)
        if i < n_imgs:
            logits = eng.eval_embeds(0, embeds[i])

    smp = Sampler(SamplingParams(temp=args.temp, seed=args.seed),
                  eng.cfg.vocab_size)
    out = []
    tok = smp.sample(logits)
    for _ in range(args.n_predict):
        if tok == eng.tokenizer.vocab.eos_id:
            break
        out.append(tok)
        piece = eng.tokenizer.decode([tok])
        print(piece, end="", flush=True)
        logits = eng.decode_one(0, tok)
        tok = smp.sample(logits)
    print()
    if args.verbose:
        tm = eng.timings
        print(f"eval: {tm.n_eval} tokens, prefill: {tm.n_prefill} tokens",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
