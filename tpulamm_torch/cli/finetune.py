"""LoRA finetune CLI (examples/finetune parity; counterpart of
tpulamm.cli.finetune).

Finetunes low-rank adapters on a frozen base model (GGUF in, adapter GGUF
out); the adapter can then be applied at load time with `--lora` on the
generation CLI (llama_model_apply_lora_from_file parity) or baked into a
model file with cli.export_lora.

    python -m tpulamm_torch.cli.finetune -m base.gguf --train-data t.txt \
        -o adapter.gguf [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="tpulamm-torch-finetune",
        description="LoRA finetuning on a frozen GGUF base model")
    p.add_argument("-m", "--model-base", required=True)
    p.add_argument("--train-data", required=True)
    p.add_argument("-o", "--lora-out", required=True)
    p.add_argument("--lora-r", type=int, default=8)
    p.add_argument("--lora-alpha", type=int, default=16)
    p.add_argument("--targets", default="wq,wv",
                   help="comma list of wq,wk,wv,wo,w_gate,w_up,w_down")
    p.add_argument("--ctx", type=int, default=128)
    p.add_argument("-b", "--batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu trains on the "
                        "host)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(build_parser(), args.model_base)

    from tpulamm_torch.models.loader import load_model
    from tpulamm_torch.runtime.engine import resolve_device
    from tpulamm_torch.tokenizer.spm import build_tokenizer
    from tpulamm_torch.tools.imatrix import densify_params
    from tpulamm_torch.train.lora import finetune_lora, save_lora_gguf
    from tpulamm_torch.train.train import TrainConfig

    dev = resolve_device(args.device)
    cfg, params, md = load_model(args.model_base, compute_dtype="float32",
                                 device=dev)
    tokenizer = build_tokenizer(md)

    assert cfg.arch == "llama", "finetune supports llama-arch bases"

    # densify the base for the differentiable forward
    dense = densify_params(params)

    with open(args.train_data) as f:
        data = np.asarray(tokenizer.encode(f.read(), add_bos=False), np.int32)
    print(f"corpus: {len(data)} tokens", file=sys.stderr)

    tc = TrainConfig(lr=args.lr, batch_size=args.batch,
                     seq_len=min(args.ctx, max(len(data) - 2, 8)),
                     n_steps=args.iters, seed=args.seed)
    lora, losses = finetune_lora(
        dense, cfg, data, tc, r=args.lora_r, alpha=args.lora_alpha,
        targets=tuple(args.targets.split(",")),
        log=lambda s: print(s, file=sys.stderr))
    save_lora_gguf(lora, args.lora_out)
    print(f"saved {args.lora_out} (final loss {losses[-1]:.4f})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
