"""gritlm: generative-representational instruction tuning demo
(counterpart of tpulamm.cli.gritlm; --device cpu runs the plain path).

Re-creates examples/gritlm/gritlm.cpp: ONE model serves both as an
embedder (instruction-prefixed input, mean pooling over the sample tokens
only — the instruction positions are excluded) and as a generator. Prints
the query x document cosine-similarity matrix, then a generation sample.

    python -m tpulamm_torch.cli.gritlm -m gritlm.gguf
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def gritlm_instruction(instruction: str) -> str:
    # gritlm.cpp:gritlm_instruction
    if instruction:
        return f"<|user|>\n{instruction}\n<|embed|>\n"
    return "<|embed|>\n"


def encode(eng, texts: list[str], instruction: str) -> np.ndarray:
    """Instruction-masked mean-pooled embeddings (gritlm.cpp:encode)."""
    out = []
    inst = gritlm_instruction(instruction)
    for text in texts:
        n_inst = len(eng.tokenizer.encode(inst, special=True))
        toks = eng.tokenizer.encode(inst + text, special=True)
        h = eng.embed(toks, pooling="none")          # (T, dim)
        emb = h[n_inst:].mean(axis=0)                # skip instruction rows
        emb = emb / max(np.linalg.norm(emb), 1e-12)
        out.append(emb)
    return np.stack(out)


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-gritlm")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("-n", "--n-predict", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)

    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(args.model, n_ctx=args.ctx_size, device=args.device)
    if eng.tokenizer is None:
        p.error(f"{args.model} has no tokenizer vocab")

    # the reference demo's fixed corpus (gritlm.cpp:main)
    queries = ["Generative Representational Instruction Tuning",
               "Bitcoin: A Peer-to-Peer Electronic Cash System"]
    documents = [
        "All text-based language problems can be reduced to either "
        "generation or embedding.",
        "A purely peer-to-peer version of electronic cash would allow "
        "online payments to be sent directly from one party to another.",
    ]
    inst = "Given a scientific paper title, retrieve the paper's abstract"
    q = encode(eng, queries, inst)
    d = encode(eng, documents, "")
    sims = q @ d.T
    for i, query in enumerate(queries):
        for j, doc in enumerate(documents):
            print(f'cosine sim between "{query[:30]}..." and '
                  f'"{doc[:30]}..." is: {sims[i, j]:.3f}')

    prompt = ("<|user|>\nPlease write me a poem about my recent hike of "
              "Mt. Fuji.\n<|assistant|>\n")
    eng.reset_slot(0)
    _, text = eng.generate_fast(prompt, n_predict=args.n_predict, temp=0.0)
    print("\ngeneration sample:\n" + text, file=sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
