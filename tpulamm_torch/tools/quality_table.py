"""Per-format quality deltas (counterpart of tpulamm.tools.quality_table).

The reference publishes Δppl per quant format on wikitext-2
(examples/quantize/quantize.cpp:19-49, perplexity.cpp:445). Offline, the
table is made from an F32 model: quantize it to every format and measure
ppl and KL-divergence against F32 with cli/perplexity's machinery on
held-out text. The text is the repository's own prose (its markdown
files), the same bytes on every host, tokenized as bytes (id = byte + 3,
the mapping the JAX package trains its quality model on).

    python -m tpulamm_torch.tools.quality_table --train -m F32.gguf
    python -m tpulamm_torch.tools.quality_table -m F32.gguf [--device cpu]

--train (train_model) first trains a small byte-level llama on 95% of the
corpus (train.train, AdamW) and writes it as the F32 model.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

FORMATS = ("Q8_0", "Q5_1", "Q5_0", "Q4_1", "Q4_0", "Q2_K")
REPO = Path(__file__).resolve().parents[2]
CORPUS_FILES = ("SURVEY.md", "README.md", "PAPER.md")


def build_corpus(max_bytes: int = 6_000_000, paths=None) -> bytes:
    """Concatenate English prose from `paths` (default: the repository's
    SURVEY.md, README.md and PAPER.md), skipping files that are not mostly
    ASCII text as the JAX tool does: real text statistics without network
    access."""
    paths = [REPO / name for name in CORPUS_FILES] if paths is None else paths
    chunks, total = [], 0
    for p in paths:
        if not os.path.isfile(p):
            continue
        with open(p, "rb") as f:
            data = f.read()
        if not data or data.count(b"\x00"):
            continue
        sample = data[:4096]
        printable = sum(32 <= b < 127 or b in (9, 10, 13) for b in sample)
        if printable / len(sample) < 0.95:
            continue
        chunks.append(data)
        total += len(data)
        if total >= max_bytes:
            break
    return b"\n".join(chunks)[:max_bytes]


def byte_vocab() -> dict:
    """SPM-style byte-fallback vocab: specials + 256 byte tokens."""
    tokens = ["<unk>", "<s>", "</s>"]
    ttypes = [2, 3, 3]
    scores = [0.0, 0.0, 0.0]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        ttypes.append(6)                     # TOKEN_TYPE_BYTE
        scores.append(0.0)
    return {"tokens": tokens, "scores": scores, "token_type": ttypes,
            "model": "llama", "bos": 1, "eos": 2}


def train_model(out_path: str, *, dim=512, n_layers=8, n_heads=8,
                n_kv_heads=4, ffn=1408, seq_len=512, n_steps=1500,
                batch_size=16, lr=3e-4, remat=False,
                corpus: bytes | None = None, log=print, device=None):
    """Train a byte-level llama (ids = byte + 3) on the first 95% of the
    corpus and write it as an F32 GGUF with the byte vocab; the JAX tool's
    model, config and draws. device: the training's (default "cuda")."""
    from tpulamm_torch.models.config import ModelConfig
    from tpulamm_torch.ops.rope import RopeParams
    from tpulamm_torch.train.model import init_params, save_params_gguf
    from tpulamm_torch.train.train import TrainConfig, train

    corpus = corpus if corpus is not None else build_corpus()
    log(f"corpus: {len(corpus) / 1e6:.1f} MB")
    data = np.frombuffer(corpus, np.uint8).astype(np.int32) + 3  # byte toks
    cfg = ModelConfig(vocab_size=259, dim=dim, n_layers=n_layers,
                      n_heads=n_heads, n_kv_heads=n_kv_heads, ffn_dim=ffn,
                      n_ctx_train=seq_len,
                      rope=RopeParams(n_rot=dim // n_heads))
    params = init_params(cfg, seed=0, device=device)
    tc = TrainConfig(lr=lr, batch_size=batch_size, seq_len=seq_len,
                     n_steps=n_steps, warmup_steps=50, seed=0, remat=remat)
    params, losses = train(params, cfg, data[: int(len(data) * 0.95)], tc,
                           log_every=100, log=log)
    save_params_gguf(params, cfg, out_path, vocab=byte_vocab())
    log(f"saved {out_path} (final loss {losses[-1]:.3f} = "
        f"ppl {np.exp(losses[-1]):.2f})")
    return out_path


def quality_table(f32_path: str, *, corpus: bytes | None = None,
                  n_ctx: int = 512, n_chunks: int = 8, log=print,
                  device=None) -> list:
    """Quantize to every format; ppl + KL(F32 || quant) per format. The
    quantized files are written beside the F32 one; device: the Engines'
    (default "cuda")."""
    from tpulamm_torch.cli.perplexity import (compute_perplexity,
                                              kl_divergence, save_logits)
    from tpulamm_torch.cli.quantize import quantize_file
    from tpulamm_torch.gguf.constants import GGMLType
    from tpulamm_torch.runtime.engine import Engine

    corpus = corpus if corpus is not None else build_corpus()
    held_out = corpus[int(len(corpus) * 0.95):]
    # evaluate with the byte token mapping (raw byte + 3): the SPM text
    # path would re-map spaces to U+2581 bytes
    toks = (np.frombuffer(held_out, np.uint8).astype(np.int32) + 3)
    toks = list(toks[: (n_ctx + 8) * n_chunks])

    rows = []
    base_dir = os.path.dirname(os.path.abspath(f32_path)) or "."
    base_npz = os.path.join(base_dir, "quality_base_logits.npz")

    eng = Engine(f32_path, n_ctx=n_ctx, device=device)
    ref = compute_perplexity(eng, "", n_ctx=n_ctx, progress=False,
                             tokens=toks)
    save_logits(eng, "", base_npz, n_ctx=n_ctx, max_chunks=n_chunks,
                tokens=toks)
    rows.append({"format": "F32", "ppl": ref["ppl"], "dppl": 0.0,
                 "kl": 0.0, "top1_agree": 1.0})
    log(f"F32    ppl {ref['ppl']:.4f}")
    del eng

    for fmt in FORMATS:
        qpath = os.path.join(base_dir, f"quality_{fmt.lower()}.gguf")
        quantize_file(f32_path, qpath, getattr(GGMLType, fmt),
                      verbose=False)
        eng = Engine(qpath, n_ctx=n_ctx, device=device)
        got = compute_perplexity(eng, "", n_ctx=n_ctx, progress=False,
                                 tokens=toks)
        kl = kl_divergence(eng, base_npz)
        rows.append({"format": fmt, "ppl": got["ppl"],
                     "dppl": got["ppl"] - ref["ppl"],
                     "kl": kl["kl_mean"], "top1_agree": kl["top1_agree"]})
        log(f"{fmt:<6} ppl {got['ppl']:.4f}  dppl {rows[-1]['dppl']:+.4f}  "
            f"KL {kl['kl_mean']:.5f}  top1 {kl['top1_agree'] * 100:.2f}%")
        del eng
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-quality-table")
    p.add_argument("-m", "--model", default="tmp_bench/quality_f32.gguf",
                   help="F32 GGUF (trained if --train)")
    p.add_argument("--train", action="store_true")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--n-chunks", type=int, default=8)
    p.add_argument("-o", "--output", default=None,
                   help="write the table as JSON here")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path)")
    args = p.parse_args(argv)
    corpus = build_corpus()
    if args.train or not os.path.exists(args.model):
        os.makedirs(os.path.dirname(args.model) or ".", exist_ok=True)
        train_model(args.model, n_steps=args.steps, corpus=corpus,
                    device=args.device)
    rows = quality_table(args.model, corpus=corpus, n_chunks=args.n_chunks,
                         device=args.device)
    print(json.dumps(rows, indent=1))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
