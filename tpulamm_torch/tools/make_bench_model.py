"""Regenerate the gitignored tmp_bench/ benchmark & smoke-test models
(counterpart of tpulamm.tools.make_bench_model, writing through the port's
convert_hf; numpy only but for the mmproj target).

The perf/verify workflow uses a small zoo of synthetic GGUF models that are
too large (or too pointless) to commit; this script rebuilds them after an
environment reset so benchmarks stay reproducible:

- tiny11b_{fmt}.gguf   TinyLlama-1.1B-shape llama (dim 2048, ffn 5632,
                       22 layers, 32 heads / 4 kv heads, vocab 32000),
                       random weights, NO tokenizer — the end-to-end
                       pp512/tg256 bench model (BASELINE.md §2/§3 rows).
- llama7b_{fmt}.gguf   LLaMA-7B shape (dim 4096, ffn 11008, 32 layers,
                       MHA) — the reference's headline size (--targets
                       llama7b; ~26 GB host RAM while building).
- llava_lm_q4.gguf     2048-dim 4-layer Q4_0 WITH a byte-fallback SPM vocab;
                       drives any CLI (main/server/llava) on real text.
- padtest_q4.gguf      4608-token vocab — exercises the padded-lm-head path.
- mmproj_test.gguf     tiny CLIP vision tower + llava projector (proj dim
                       matches llava_lm's embedding) + test_img.jpg (with
                       PIL). It needs `transformers` for the tower and
                       skips without it.

The files are host work only (numpy and the port's quantizer); nothing
runs on a device, so there is no --device.

Usage: python -m tpulamm_torch.tools.make_bench_model [--out tmp_bench]
           [--targets tiny11b,llava,padtest,mmproj] [--formats q4_0,...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.tokenizer.spm import (TOKEN_TYPE_BYTE, TOKEN_TYPE_CONTROL,
                                   TOKEN_TYPE_NORMAL)


def make_spm_vocab(n_vocab: int) -> dict:
    """Byte-fallback SPM vocab: specials + 256 byte tokens + a few words."""
    tokens = ["<unk>", "<s>", "</s>"]
    ttypes = [2, TOKEN_TYPE_CONTROL, TOKEN_TYPE_CONTROL]
    scores = [0.0, 0.0, 0.0]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        ttypes.append(TOKEN_TYPE_BYTE)
        scores.append(0.0)
    words = ["▁the", "▁cat", "▁sat", "▁on", "▁mat", "▁a", "▁describe",
             "▁USER", "▁ANSWER", "at", "he", "▁", "t", "h", "e", "c", "s",
             "o", "n", "m", "a", "r", "i", "d", "u", "l", "p"]
    for i, w in enumerate(words):
        tokens.append(w)
        ttypes.append(TOKEN_TYPE_NORMAL)
        scores.append(-float(i + 1))
    while len(tokens) < n_vocab:
        tokens.append(f"<extra_{len(tokens)}>")
        ttypes.append(TOKEN_TYPE_NORMAL)
        scores.append(-1000.0)
    return {"tokens": tokens[:n_vocab], "scores": scores[:n_vocab],
            "token_type": ttypes[:n_vocab], "model": "llama",
            "bos": 1, "eos": 2}


def make_llama_sd(dim: int, n_ff: int, n_layers: int, n_head: int,
                  n_kv: int, n_vocab: int, seed: int = 0) -> tuple:
    """Random HF-llama state dict (numpy, GPT-style init: residual-writing
    projections scaled 1/sqrt(2L) so deep stacks stay numerically tame)."""
    rng = np.random.default_rng(seed)
    hd = dim // n_head
    res = 0.02 / np.sqrt(2 * n_layers)

    def g(shape, std=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * std)

    sd = {"model.embed_tokens.weight": g((n_vocab, dim)),
          "model.norm.weight": np.ones(dim, np.float32),
          "lm_head.weight": g((n_vocab, dim))}
    for i in range(n_layers):
        h = f"model.layers.{i}."
        sd[h + "input_layernorm.weight"] = np.ones(dim, np.float32)
        sd[h + "post_attention_layernorm.weight"] = np.ones(dim, np.float32)
        sd[h + "self_attn.q_proj.weight"] = g((n_head * hd, dim))
        sd[h + "self_attn.k_proj.weight"] = g((n_kv * hd, dim))
        sd[h + "self_attn.v_proj.weight"] = g((n_kv * hd, dim))
        sd[h + "self_attn.o_proj.weight"] = g((dim, n_head * hd), res)
        sd[h + "mlp.gate_proj.weight"] = g((n_ff, dim))
        sd[h + "mlp.up_proj.weight"] = g((n_ff, dim))
        sd[h + "mlp.down_proj.weight"] = g((dim, n_ff), res)
    cfg = SimpleNamespace(
        vocab_size=n_vocab, hidden_size=dim, intermediate_size=n_ff,
        num_hidden_layers=n_layers, num_attention_heads=n_head,
        num_key_value_heads=n_kv, max_position_embeddings=2048,
        rms_norm_eps=1e-5, rope_theta=10000.0, name_or_path="bench",
        num_local_experts=0)
    return sd, cfg


def build_tiny11b(out_dir: str, formats: list[str]) -> None:
    from tpulamm_torch.tools.convert_hf import convert_hf_llama
    sd, cfg = make_llama_sd(dim=2048, n_ff=5632, n_layers=22, n_head=32,
                            n_kv=4, n_vocab=32000, seed=42)
    for fmt in formats:
        path = os.path.join(out_dir, f"tiny11b_{fmt}.gguf")
        t0 = time.time()
        convert_hf_llama(sd, cfg, path, qtype=getattr(GGMLType, fmt.upper()))
        print(f"wrote {path} ({os.path.getsize(path) / 1e6:.0f} MB, "
              f"{time.time() - t0:.0f}s)", file=sys.stderr)
    # canonical alias used throughout PERF.md / VERDICT.md
    if "q4_0" in formats:
        src = os.path.join(out_dir, "tiny11b_q4_0.gguf")
        dst = os.path.join(out_dir, "tiny11b_q4.gguf")
        if os.path.exists(dst):
            os.remove(dst)
        os.link(src, dst)
        print(f"linked {dst}", file=sys.stderr)


class LazySD:
    """Mapping that synthesizes random-weight tensors on demand, so a
    13B/30B f32 state dict (52/130 GB if materialized) never exists in
    RAM — the converter reads one tensor at a time, quantizes it, and the
    f32 source is freed. Deterministic per tensor name (crc32-keyed
    stream), independent of access order."""

    def __init__(self, specs: dict, seed: int):
        self.specs = specs        # name -> (shape, std|None)
        self.seed = seed

    def __contains__(self, k) -> bool:
        return k in self.specs

    def __getitem__(self, k) -> np.ndarray:
        import zlib
        shape, std = self.specs[k]
        if std is None:                              # norm weights
            return np.ones(shape, np.float32)
        rng = np.random.default_rng((self.seed, zlib.crc32(k.encode())))
        return rng.standard_normal(shape, dtype=np.float32) * std


def make_llama_lazy_sd(dim: int, n_ff: int, n_layers: int, n_head: int,
                       n_kv: int, n_vocab: int, seed: int) -> tuple:
    """LazySD twin of make_llama_sd (same shapes/stds, streamed)."""
    hd = dim // n_head
    res = 0.02 / np.sqrt(2 * n_layers)
    specs = {"model.embed_tokens.weight": ((n_vocab, dim), 0.02),
             "model.norm.weight": ((dim,), None),
             "lm_head.weight": ((n_vocab, dim), 0.02)}
    for i in range(n_layers):
        h = f"model.layers.{i}."
        specs[h + "input_layernorm.weight"] = ((dim,), None)
        specs[h + "post_attention_layernorm.weight"] = ((dim,), None)
        specs[h + "self_attn.q_proj.weight"] = ((n_head * hd, dim), 0.02)
        specs[h + "self_attn.k_proj.weight"] = ((n_kv * hd, dim), 0.02)
        specs[h + "self_attn.v_proj.weight"] = ((n_kv * hd, dim), 0.02)
        specs[h + "self_attn.o_proj.weight"] = ((dim, n_head * hd), res)
        specs[h + "mlp.gate_proj.weight"] = ((n_ff, dim), 0.02)
        specs[h + "mlp.up_proj.weight"] = ((n_ff, dim), 0.02)
        specs[h + "mlp.down_proj.weight"] = ((dim, n_ff), res)
    cfg = SimpleNamespace(
        vocab_size=n_vocab, hidden_size=dim, intermediate_size=n_ff,
        num_hidden_layers=n_layers, num_attention_heads=n_head,
        num_key_value_heads=n_kv, max_position_embeddings=2048,
        rms_norm_eps=1e-5, rope_theta=10000.0, name_or_path="bench",
        num_local_experts=0)
    return LazySD(specs, seed), cfg


def build_llama13b(out_dir: str, formats: list[str]) -> None:
    """LLaMA-13B shape (dim 5120, ffn 13824, 40 layers, MHA) — reference
    scale row README.md:716 (13B Q4_0 tg 2.66 on the 3A6000)."""
    from tpulamm_torch.tools.convert_hf import convert_hf_llama
    sd, cfg = make_llama_lazy_sd(dim=5120, n_ff=13824, n_layers=40,
                                 n_head=40, n_kv=40, n_vocab=32000, seed=13)
    for fmt in formats:
        path = os.path.join(out_dir, f"llama13b_{fmt}.gguf")
        t0 = time.time()
        convert_hf_llama(sd, cfg, path, qtype=getattr(GGMLType, fmt.upper()))
        print(f"wrote {path} ({os.path.getsize(path) / 1e6:.0f} MB, "
              f"{time.time() - t0:.0f}s)", file=sys.stderr)


def build_llama30b(out_dir: str, formats: list[str]) -> None:
    """LLaMA-30B shape (dim 6656, ffn 17920, 60 layers, 52 heads, MHA) —
    reference scale row README.md:721 (30B Q2_K tg 0.34)."""
    from tpulamm_torch.tools.convert_hf import convert_hf_llama
    sd, cfg = make_llama_lazy_sd(dim=6656, n_ff=17920, n_layers=60,
                                 n_head=52, n_kv=52, n_vocab=32000, seed=30)
    for fmt in formats:
        path = os.path.join(out_dir, f"llama30b_{fmt}.gguf")
        t0 = time.time()
        convert_hf_llama(sd, cfg, path, qtype=getattr(GGMLType, fmt.upper()))
        print(f"wrote {path} ({os.path.getsize(path) / 1e6:.0f} MB, "
              f"{time.time() - t0:.0f}s)", file=sys.stderr)


def build_llama7b(out_dir: str, formats: list[str]) -> None:
    """LLaMA-7B shape (dim 4096, ffn 11008, 32 layers, 32 heads, MHA) —
    the reference's headline model size (README.md:684,710)."""
    from tpulamm_torch.tools.convert_hf import convert_hf_llama
    sd, cfg = make_llama_sd(dim=4096, n_ff=11008, n_layers=32, n_head=32,
                            n_kv=32, n_vocab=32000, seed=7)
    for fmt in formats:
        path = os.path.join(out_dir, f"llama7b_{fmt}.gguf")
        t0 = time.time()
        convert_hf_llama(sd, cfg, path, qtype=getattr(GGMLType, fmt.upper()))
        print(f"wrote {path} ({os.path.getsize(path) / 1e6:.0f} MB, "
              f"{time.time() - t0:.0f}s)", file=sys.stderr)


def build_llava_lm(out_dir: str) -> str:
    from tpulamm_torch.tools.convert_hf import convert_hf_llama
    sd, cfg = make_llama_sd(dim=2048, n_ff=4096, n_layers=4, n_head=16,
                            n_kv=4, n_vocab=512, seed=7)
    path = os.path.join(out_dir, "llava_lm_q4.gguf")
    convert_hf_llama(sd, cfg, path, qtype=GGMLType.Q4_0,
                     vocab=make_spm_vocab(512))
    print(f"wrote {path}", file=sys.stderr)
    return path


def build_padtest(out_dir: str) -> None:
    from tpulamm_torch.tools.convert_hf import convert_hf_llama
    # 4608 = 36*128: not a multiple of the 512-lane lm-head tile,
    # exercising the tile-padded lm head path
    sd, cfg = make_llama_sd(dim=256, n_ff=512, n_layers=2, n_head=4,
                            n_kv=2, n_vocab=4608, seed=3)
    path = os.path.join(out_dir, "padtest_q4.gguf")
    convert_hf_llama(sd, cfg, path, qtype=GGMLType.Q4_0,
                     vocab=make_spm_vocab(4608))
    print(f"wrote {path}", file=sys.stderr)


def build_mmproj(out_dir: str, proj_dim: int = 2048) -> None:
    """Tiny CLIP tower + projector into proj_dim (llava_lm's embedding)."""
    try:
        import torch
        from transformers import CLIPVisionConfig, CLIPVisionModel
    except ImportError:
        print("transformers/torch unavailable; skipping mmproj",
              file=sys.stderr)
        return
    from tpulamm_torch.tools.convert_hf import convert_hf_clip
    torch.manual_seed(3)
    hf_cfg = CLIPVisionConfig(
        hidden_size=64, num_attention_heads=2, num_hidden_layers=3,
        intermediate_size=128, image_size=64, patch_size=16,
        hidden_act="quick_gelu", layer_norm_eps=1e-5)
    vision = CLIPVisionModel(hf_cfg).eval()
    lin1 = torch.nn.Linear(64, proj_dim)
    lin2 = torch.nn.Linear(proj_dim, proj_dim)
    proj_sd = {
        "multi_modal_projector.linear_1.weight": lin1.weight.detach().numpy(),
        "multi_modal_projector.linear_1.bias": lin1.bias.detach().numpy(),
        "multi_modal_projector.linear_2.weight": lin2.weight.detach().numpy(),
        "multi_modal_projector.linear_2.bias": lin2.bias.detach().numpy()}
    sd = {k: v.float().numpy() for k, v in vision.state_dict().items()}
    path = os.path.join(out_dir, "mmproj_test.gguf")
    convert_hf_clip(sd, hf_cfg, path, proj_sd=proj_sd, skip_last=0)
    print(f"wrote {path}", file=sys.stderr)

    try:
        from PIL import Image
        rng = np.random.default_rng(0)
        img = (rng.uniform(0, 255, size=(96, 128, 3))).astype(np.uint8)
        img[20:60, 30:90] = (200, 40, 40)          # a "feature" block
        ipath = os.path.join(out_dir, "test_img.jpg")
        Image.fromarray(img).save(ipath, quality=90)
        print(f"wrote {ipath}", file=sys.stderr)
    except ImportError:
        pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpulamm-torch-make-bench-model",
                                description=__doc__)
    p.add_argument("--out", default="tmp_bench")
    p.add_argument("--targets", default="tiny11b,llava,padtest,mmproj")
    p.add_argument("--formats", default="q4_0",
                   help="tiny11b formats (comma list or 'all')")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    targets = set(args.targets.split(","))
    fmts = (["q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q2_k"]
            if args.formats == "all" else args.formats.split(","))
    if "tiny11b" in targets:
        build_tiny11b(args.out, fmts)
    if "llama7b" in targets:
        build_llama7b(args.out, fmts)
    if "llama13b" in targets:
        build_llama13b(args.out, fmts)
    if "llama30b" in targets:
        build_llama30b(args.out, fmts)
    if "llava" in targets:
        build_llava_lm(args.out)
    if "padtest" in targets:
        build_padtest(args.out)
    if "mmproj" in targets:
        build_mmproj(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
