"""train-text-from-scratch CLI equivalent (counterpart of
tpulamm.cli.train).

Trains a llama-arch model from scratch on a raw text file and writes a GGUF
checkpoint the generation CLI can run (examples/train-text-from-scratch
parity; ADAM/LBFGS flags from ggml_opt).

    python -m tpulamm_torch.cli.train --train-data text.txt -o model.gguf \
        [--vocab-model vocab.gguf] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def byte_vocab() -> dict:
    """Self-contained byte-level vocab (no base model needed)."""
    tokens = ["<unk>", "<s>", "</s>", "▁"]   # ▁ decodes back to a space
    ttype = [2, 3, 3, 1]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        ttype.append(6)
    return dict(model="llama", tokens=tokens, scores=[0.0] * len(tokens),
                token_type=ttype, bos=1, eos=2, unk=0)


def build_parser():
    p = argparse.ArgumentParser(
        prog="tpulamm-torch-train",
        description="train a llama-arch model from scratch (GGUF out)")
    p.add_argument("--train-data", required=True, help="raw text file")
    p.add_argument("-o", "--checkpoint-out", required=True)
    p.add_argument("--vocab-model", default=None,
                   help="GGUF whose tokenizer vocab to use (default: bytes)")
    p.add_argument("--embd", type=int, default=256)
    p.add_argument("--head", type=int, default=8)
    p.add_argument("--head-kv", type=int, default=8)
    p.add_argument("--layer", type=int, default=4)
    p.add_argument("--ff", type=int, default=768)
    p.add_argument("--ctx", type=int, default=128)
    p.add_argument("-b", "--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--opt", choices=["adamw", "lbfgs"], default="adamw")
    p.add_argument("--grad-checkpointing", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu trains on the "
                        "host)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from tpulamm_torch.models.config import ModelConfig
    from tpulamm_torch.ops.rope import RopeParams
    from tpulamm_torch.tokenizer.spm import build_tokenizer
    from tpulamm_torch.train.model import init_params, save_params_gguf
    from tpulamm_torch.train.train import TrainConfig, train

    if args.vocab_model:
        from tpulamm_torch.gguf.reader import GGUFReader
        md = GGUFReader(args.vocab_model).metadata
        vocab = dict(model=md.get("tokenizer.ggml.model", "llama"),
                     tokens=list(md["tokenizer.ggml.tokens"]),
                     scores=list(md.get("tokenizer.ggml.scores", [])),
                     token_type=list(md.get("tokenizer.ggml.token_type", [])),
                     bos=int(md.get("tokenizer.ggml.bos_token_id", 1)),
                     eos=int(md.get("tokenizer.ggml.eos_token_id", 2)))
        tok_md = {f"tokenizer.ggml.{k}": v for k, v in [
            ("model", vocab["model"]), ("tokens", vocab["tokens"]),
            ("scores", vocab["scores"]), ("token_type", vocab["token_type"])]}
    else:
        vocab = byte_vocab()
        tok_md = {
            "tokenizer.ggml.model": vocab["model"],
            "tokenizer.ggml.tokens": vocab["tokens"],
            "tokenizer.ggml.scores": vocab["scores"],
            "tokenizer.ggml.token_type": vocab["token_type"],
        }
    tokenizer = build_tokenizer(tok_md)

    with open(args.train_data) as f:
        text = f.read()
    data = np.asarray(tokenizer.encode(text, add_bos=False), np.int32)
    print(f"corpus: {len(text)} chars -> {len(data)} tokens", file=sys.stderr)

    cfg = ModelConfig(
        arch="llama", vocab_size=len(vocab["tokens"]), dim=args.embd,
        n_layers=args.layer, n_heads=args.head, n_kv_heads=args.head_kv,
        ffn_dim=args.ff, n_ctx_train=args.ctx, norm_eps=1e-5,
        rope=RopeParams(n_rot=args.embd // args.head), compute_dtype="float32")
    params = init_params(cfg, seed=args.seed, device=args.device)
    tc = TrainConfig(optimizer=args.opt, lr=args.lr, batch_size=args.batch,
                     seq_len=min(args.ctx, max(len(data) - 2, 8)),
                     n_steps=args.iters, remat=args.grad_checkpointing,
                     seed=args.seed)
    params, losses = train(params, cfg, data, tc,
                           log=lambda s: print(s, file=sys.stderr))
    save_params_gguf(params, cfg, args.checkpoint_out, vocab=vocab)
    print(f"saved {args.checkpoint_out} (final loss {losses[-1]:.4f})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
