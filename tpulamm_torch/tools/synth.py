"""Synthetic weights and LLaMA-shape GGUF models made from a seed, for the
measurement tools and chip_smoke.py. A quantized weight is random GGUF
blocks, and its dequantized values are the truth every kernel is held to;
an F32 model (normal draws) is the source the quantizer (cli.quantize)
makes every format from.
"""

from __future__ import annotations

import numpy as np

from tpulamm_torch.gguf.constants import GGML_TYPE_SIZES, GGMLType
from tpulamm_torch.gguf.writer import GGUFWriter


def random_blocks(qtype: GGMLType, n: int, k: int, rng,
                  scale: float = 0.02 / 8) -> np.ndarray:
    """GGUF rows (n, row_bytes) of random codes with fp16 scales near
    `scale` (and mins near -8 * scale where the format has them)."""
    bs, tb = GGML_TYPE_SIZES[qtype]
    nb = k // bs
    raw = np.frombuffer(rng.bytes(n * nb * tb), np.uint8).reshape(n, nb, tb).copy()

    def f16(v):
        return np.asarray(v, np.float16).view(np.uint8).reshape(n, nb, 2)
    d = scale * rng.uniform(0.5, 1.5, size=(n, nb))
    if qtype == GGMLType.Q2_K:
        raw[..., 80:82] = f16(d / 4)                       # d
        raw[..., 82:84] = f16(d / 4)                       # dmin
    else:
        raw[..., 0:2] = f16(d)
        if qtype in (GGMLType.Q4_1, GGMLType.Q5_1):
            raw[..., 2:4] = f16(-8 * d)                    # m
    return raw.reshape(n, nb * tb)


# the fill-in-the-middle token ids of write_llama_gguf(fim=True): the first
# filler ids after the specials and the 256 byte tokens
FIM_ROLES = ("prefix", "suffix", "middle", "eot")
FIM_FIRST_ID = 259


def spm_vocab(n_vocab: int) -> dict:
    """Byte-fallback SPM vocab: specials + 256 byte tokens + fillers."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    ttypes = [2, 3, 3] + [6] * 256
    while len(tokens) < n_vocab:
        tokens.append(f"<extra_{len(tokens)}>")
        ttypes.append(1)
    return {"tokens": tokens, "token_type": ttypes,
            "scores": [0.0] * 3 + [0.0] * 256 + [-1000.0] * (n_vocab - 259)}


def write_llama_gguf(path: str, n_layers: int, rng, dim: int, ffn: int,
                     n_head: int, vocab: int, n_ctx_train: int = 2048,
                     freq_base: float = 10000.0, qtype=GGMLType.Q4_0,
                     std: float = 0.02, fim: bool = False) -> None:
    """A LLaMA-shape GGUF, norm weights 1: with qtype Q4_0 every matrix is
    random Q4_0 blocks; with F32 it is normal draws of standard deviation
    `std` (0.02, LLaMA's initializer range, puts the logits' spread near
    1.3 at dim 4096). fim: name the first four filler ids of the vocab
    the fill-in-the-middle prefix, suffix, middle and end-of-text tokens
    (what cli.infill needs)."""
    if qtype not in (GGMLType.Q4_0, GGMLType.F32):
        raise ValueError(f"synthetic models are Q4_0 or F32, not {qtype!r}")
    w = GGUFWriter(path)
    md = {"general.architecture": "llama", "general.name": "smoke",
          "llama.context_length": n_ctx_train,
          "llama.rope.freq_base": float(freq_base),
          "llama.embedding_length": dim,
          "llama.block_count": n_layers, "llama.feed_forward_length": ffn,
          "llama.attention.head_count": n_head,
          "llama.attention.head_count_kv": n_head,
          "llama.rope.dimension_count": dim // n_head,
          "llama.attention.layer_norm_rms_epsilon": 1e-5,
          "llama.vocab_size": vocab}
    for key, val in md.items():
        w.add_kv(key, val)
    voc = spm_vocab(vocab)
    w.add_kv("tokenizer.ggml.model", "llama")
    w.add_kv("tokenizer.ggml.tokens", voc["tokens"])
    w.add_kv("tokenizer.ggml.scores", np.asarray(voc["scores"], np.float32))
    w.add_kv("tokenizer.ggml.token_type",
             np.asarray(voc["token_type"], np.int32))
    w.add_kv("tokenizer.ggml.bos_token_id", 1)
    w.add_kv("tokenizer.ggml.eos_token_id", 2)
    if fim:
        for i, role in enumerate(FIM_ROLES):
            w.add_kv(f"tokenizer.ggml.{role}_token_id", FIM_FIRST_ID + i)

    def q4(name, n, k):
        if qtype == GGMLType.F32:
            w.add_tensor(name, rng.standard_normal((n, k), np.float32) * std)
            return
        w.add_tensor(name, random_blocks(GGMLType.Q4_0, n, k, rng),
                     shape=(n, k), ggml_type=GGMLType.Q4_0)

    ones = np.ones(dim, np.float32)
    q4("token_embd.weight", vocab, dim)
    w.add_tensor("output_norm.weight", ones)
    q4("output.weight", vocab, dim)
    for i in range(n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", ones)
        w.add_tensor(p + "ffn_norm.weight", ones)
        for t in ("attn_q", "attn_k", "attn_v", "attn_output"):
            q4(p + t + ".weight", dim, dim)
        q4(p + "ffn_gate.weight", ffn, dim)
        q4(p + "ffn_up.weight", ffn, dim)
        q4(p + "ffn_down.weight", dim, ffn)
    w.write()
