"""Synthetic weights and GGUF models made from a seed, for the
measurement tools, the tests and chip_smoke.py. A quantized weight is
random GGUF blocks, and its dequantized values are the truth every kernel
is held to; an F32 model (normal draws) is the source the quantizer
(cli.quantize) makes every format from.

Writers: `write_llama_gguf` (LLaMA shape, Q4_0 or F32),
`write_mixtral_gguf` (LLaMA with GQA and top-k MoE experts, Q4_0, an F32
router) and `write_family_gguf` (one small model of each architecture
family in FAMILIES, with the JAX loader's per-arch tensor names), with
synthetic SPM, BPE (`bpe_vocab`) and WPM (`wpm_vocab`) vocabularies; and,
through tools.convert_hf from HF-named state dicts drawn a tensor at a
time, `write_mamba_gguf` (a Mamba checkpoint) and `write_clip_gguf` (a
CLIP vision tower with a llava projector, an mmproj).
"""

from __future__ import annotations

import zlib
from collections import Counter
from types import SimpleNamespace

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
                     std: float = 0.02, fim: bool = False,
                     n_kv: int | None = None) -> None:
    """A LLaMA-shape GGUF, norm weights 1: with qtype Q4_0 every matrix is
    random Q4_0 blocks; with F32 it is normal draws of standard deviation
    `std` (0.02, LLaMA's initializer range, puts the logits' spread near
    1.3 at dim 4096). fim: name the first four filler ids of the vocab
    the fill-in-the-middle prefix, suffix, middle and end-of-text tokens
    (what cli.infill needs). n_kv: KV heads (GQA; default n_head)."""
    n_kv = n_head if n_kv is None else n_kv
    if qtype not in (GGMLType.Q4_0, GGMLType.F32):
        raise ValueError(f"synthetic models are Q4_0 or F32, not {qtype!r}")
    w = GGUFWriter(path)
    md = {"general.architecture": "llama", "general.name": "smoke",
          "llama.context_length": n_ctx_train,
          "llama.rope.freq_base": float(freq_base),
          "llama.embedding_length": dim,
          "llama.block_count": n_layers, "llama.feed_forward_length": ffn,
          "llama.attention.head_count": n_head,
          "llama.attention.head_count_kv": n_kv,
          "llama.rope.dimension_count": dim // n_head,
          "llama.attention.layer_norm_rms_epsilon": 1e-5,
          "llama.vocab_size": vocab}
    for key, val in md.items():
        w.add_kv(key, val)
    _add_vocab(w, "llama", vocab)
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
            q4(p + t + ".weight",
               dim * n_kv // n_head if t in ("attn_k", "attn_v") else dim,
               dim)
        q4(p + "ffn_gate.weight", ffn, dim)
        q4(p + "ffn_up.weight", ffn, dim)
        q4(p + "ffn_down.weight", dim, ffn)
    w.write()


def write_mixtral_gguf(path: str, n_layers: int, rng, dim: int, ffn: int,
                       n_head: int, n_kv: int, vocab: int, n_expert: int,
                       n_expert_used: int, n_ctx_train: int = 32768,
                       freq_base: float = 1e6) -> None:
    """A Mixtral-shape GGUF (general.architecture "llama" with
    expert_count experts, expert_used_count of them a token; the
    reference's build_llama MoE branch): every matrix random Q4_0 blocks
    but the router, ffn_gate_inp (n_expert, dim) F32 normal draws of
    std 0.02; norm weights 1; an SPM vocab."""
    w = GGUFWriter(path)
    md = {"general.architecture": "llama", "general.name": "smoke-moe",
          "llama.context_length": n_ctx_train,
          "llama.rope.freq_base": float(freq_base),
          "llama.embedding_length": dim, "llama.block_count": n_layers,
          "llama.feed_forward_length": ffn,
          "llama.attention.head_count": n_head,
          "llama.attention.head_count_kv": n_kv,
          "llama.rope.dimension_count": dim // n_head,
          "llama.attention.layer_norm_rms_epsilon": 1e-5,
          "llama.expert_count": n_expert,
          "llama.expert_used_count": n_expert_used,
          "llama.vocab_size": vocab}
    for key, val in md.items():
        w.add_kv(key, val)
    _add_vocab(w, "llama", vocab)

    def q4(name, n, k):
        w.add_tensor(name, random_blocks(GGMLType.Q4_0, n, k, rng),
                     shape=(n, k), ggml_type=GGMLType.Q4_0)
    hd = dim // n_head
    ones = np.ones(dim, np.float32)
    q4("token_embd.weight", vocab, dim)
    w.add_tensor("output_norm.weight", ones)
    q4("output.weight", vocab, dim)
    for i in range(n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", ones)
        w.add_tensor(p + "ffn_norm.weight", ones)
        q4(p + "attn_q.weight", dim, dim)
        q4(p + "attn_k.weight", n_kv * hd, dim)
        q4(p + "attn_v.weight", n_kv * hd, dim)
        q4(p + "attn_output.weight", dim, dim)
        w.add_tensor(p + "ffn_gate_inp.weight",
                     rng.standard_normal((n_expert, dim), np.float32)
                     * 0.02)
        for e in range(n_expert):
            q4(f"{p}ffn_gate.{e}.weight", ffn, dim)
            q4(f"{p}ffn_up.{e}.weight", ffn, dim)
            q4(f"{p}ffn_down.{e}.weight", dim, ffn)
    w.write()


# One small model of each architecture family: its tensors by the names
# the loader maps (the JAX loader's _layer_params), its metadata, and what
# each exercises in the forward. qkv: "fused" (attn_qkv) or "split";
# bias: the projections with biases ("qkv", "o", "ffn", "out"); ffn:
# "gated" (gate, up, down) or "plain" (up, down); layout: "pre" (attn_norm,
# ffn_norm), "par" (attn_norm only: parallel residual sharing it),
# "par2" (parallel residual with its own ffn_norm), "post" (bert's
# attn_output_norm and layer_output_norm); n_kv: KV heads (default all);
# hd: the head dim (default dim / n_head; falcon's one KV head needs 128
# to tile); rot: the rope share of the head dim; vocab: "bpe", "spm" or
# "wpm".
FAMILIES = {
    "gpt2": dict(qkv="fused", bias=("qkv", "o", "ffn"), ffn="plain",
                 layout="pre", pos_emb=True, vocab="bpe"),
    "falcon": dict(qkv="fused", bias=(), ffn="plain", layout="par", n_kv=1,
                   hd=128, vocab="bpe"),
    "bloom": dict(qkv="fused", bias=("qkv", "o", "ffn"), ffn="plain",
                  layout="pre", tok_norm=True, tied=True, vocab="bpe"),
    "mpt": dict(qkv="fused", bias=(), ffn="plain", layout="pre", tied=True,
                act_scales=True, vocab="bpe",
                kv={"attention.max_alibi_bias": 8.0,
                    "attention.clamp_kqv": 6.0}),
    "phi2": dict(qkv="fused", bias=("qkv", "o", "ffn", "out"), ffn="plain",
                 layout="par", rot=0.5, vocab="bpe"),
    "gemma": dict(qkv="split", bias=(), ffn="gated", layout="pre",
                  tied=True, vocab="spm", n_kv=2, key_length=True),
    "persimmon": dict(qkv="fused", bias=("qkv", "o", "ffn"), ffn="plain",
                      layout="pre", qk_norm=True, rot=0.5, vocab="spm"),
    "starcoder2": dict(qkv="split", bias=("qkv", "o", "ffn", "out"),
                       ffn="plain", layout="pre", n_kv=2, vocab="bpe"),
    "qwen2": dict(qkv="split", bias=("qkv",), ffn="gated", layout="pre",
                  n_kv=2, vocab="bpe"),
    "stablelm": dict(qkv="split", bias=(), ffn="gated", layout="pre",
                     rot=0.25, vocab="bpe"),
    "gptneox": dict(qkv="fused", bias=("qkv", "o", "ffn"), ffn="plain",
                    layout="par2", rot=0.25, vocab="bpe",
                    kv={"use_parallel_residual": True}),
    "bert": dict(qkv="split", bias=("qkv", "o", "ffn"), ffn="plain",
                 layout="post", pos_emb=True, type_emb=True, tok_norm=True,
                 no_output=True, vocab="wpm",
                 kv={"attention.causal": False, "pooling_type": 1}),
    "nomic-bert": dict(qkv="fused", bias=(), ffn="gated", layout="post",
                       type_emb=True, tok_norm=True, no_output=True,
                       vocab="wpm",
                       kv={"attention.causal": False, "pooling_type": 1}),
}


def write_family_gguf(path: str, arch: str, rng, n_layers: int = 2,
                      dim: int = 512, ffn: int = 1536, n_head: int = 8,
                      vocab: int = 1024, n_ctx_train: int = 2048,
                      head_dim: int | None = None,
                      n_kv: int | None = None) -> None:
    """A small `arch` model of FAMILIES: every projection random Q4_0
    blocks (tiling at the default widths: K % 256 == 0, N % 128 == 0),
    norm weights near 1, biases, positions and act scales small normal or
    uniform draws, all from `rng`. head_dim: n_head heads of head_dim
    each, whose product may differ from dim (Gemma-7B: 16 x 256 over
    3072; the family must write attention.key_length); default the
    family's head dim or dim / n_head, with n_head = dim / head dim.
    n_kv: the KV heads (default the family's, else n_head)."""
    from tpulamm_torch.models.config import ARCH_SPECS
    f = FAMILIES[arch]
    ln = ARCH_SPECS[arch]["norm"] == "ln"
    if head_dim is None:
        hd = f.get("hd", dim // n_head)
        n_head = dim // hd
    else:
        hd = head_dim
    if n_kv is None:
        n_kv = f.get("n_kv", n_head)
    w = GGUFWriter(path)
    md = {"context_length": n_ctx_train, "embedding_length": dim,
          "block_count": n_layers, "feed_forward_length": ffn,
          "attention.head_count": n_head, "attention.head_count_kv": n_kv,
          "rope.dimension_count": int(hd * f.get("rot", 1.0)),
          "vocab_size": vocab, **f.get("kv", {})}
    md["attention.layer_norm_epsilon" if ln
       else "attention.layer_norm_rms_epsilon"] = 1e-5
    if f.get("key_length"):
        md["attention.key_length"] = md["attention.value_length"] = hd
    w.add_kv("general.architecture", arch)
    w.add_kv("general.name", f"smoke-{arch}")
    for key, val in md.items():
        w.add_kv(f"{arch}.{key}", val)
    _add_vocab(w, f["vocab"], vocab)

    def q4(name, n, k):
        w.add_tensor(name + ".weight",
                     random_blocks(GGMLType.Q4_0, n, k, rng),
                     shape=(n, k), ggml_type=GGMLType.Q4_0)

    def vec(name, n, std=0.02):
        w.add_tensor(name, rng.standard_normal(n, np.float32) * std)

    def norm(name, n=dim):
        w.add_tensor(name + ".weight",
                     1.0 + rng.standard_normal(n, np.float32) * 0.05)
        if ln:
            vec(name + ".bias", n)

    def proj(name, n, k, part):
        q4(name, n, k)
        if part in f["bias"]:
            vec(name + ".bias", n)

    q4("token_embd", vocab, dim)
    if f.get("pos_emb"):
        vec("position_embd.weight", (n_ctx_train, dim))
    if f.get("type_emb"):
        vec("token_types.weight", (2, dim))
    if f.get("tok_norm"):
        norm("token_embd_norm")
    if not f.get("no_output"):
        norm("output_norm")
        if not f.get("tied"):
            proj("output", vocab, dim, "out")
    for i in range(n_layers):
        p = f"blk.{i}."
        if f["layout"] != "post":
            norm(p + "attn_norm")
        if f["layout"] in ("pre", "par2"):
            norm(p + "ffn_norm")
        if f["qkv"] == "fused":
            proj(p + "attn_qkv", (n_head + 2 * n_kv) * hd, dim, "qkv")
        else:
            proj(p + "attn_q", n_head * hd, dim, "qkv")
            proj(p + "attn_k", n_kv * hd, dim, "qkv")
            proj(p + "attn_v", n_kv * hd, dim, "qkv")
        if f.get("qk_norm"):
            norm(p + "attn_q_norm", hd)
            norm(p + "attn_k_norm", hd)
        proj(p + "attn_output", dim, n_head * hd, "o")
        if f["layout"] == "post":
            norm(p + "attn_output_norm")
        if f["ffn"] == "gated":
            proj(p + "ffn_gate", ffn, dim, "ffn")
        proj(p + "ffn_up", ffn, dim, "ffn")
        proj(p + "ffn_down", dim, ffn, "ffn")
        if f.get("act_scales"):
            w.add_tensor(p + "ffn.act.scales",
                         rng.uniform(0.5, 1.5, ffn).astype(np.float32))
        if f["layout"] == "post":
            norm(p + "layer_output_norm")
    w.write()


# a few sentences for the synthetic BPE merges and WPM words
CORPUS = ("The quick brown fox jumps over the lazy dog. It's 2024 and we'll "
          "see 1234 tokens, don't you think? Models read text as tokens; "
          "the tokenizer splits words into pieces and merges the pairs "
          "that occur most often. Hello world! café naïve 北京")


def bpe_vocab(n_vocab: int, text: str = CORPUS) -> dict:
    """A byte-level BPE vocab of n_vocab tokens: the 256 byte units, the
    merges a greedy trainer finds on `text` (the most frequent pair
    first, ties to the larger pair), filler tokens, and <|endoftext|>
    last (control, bos and eos)."""
    from tpulamm_torch.tokenizer.bpe import bytes_to_unicode, gpt2_pretokenize
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    words = Counter("".join(b2u[b] for b in w.encode("utf-8"))
                    for w in gpt2_pretokenize(text))
    seqs = {w: list(w) for w in words}
    merges: list[str] = []
    known = set(tokens)
    while len(tokens) < n_vocab - 1:
        pairs: Counter = Counter()
        for word, c in words.items():
            for pair in zip(seqs[word], seqs[word][1:]):
                pairs[pair] += c
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        if a + b not in known:
            tokens.append(a + b)
            known.add(a + b)
        for word, seq in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[word] = out
    while len(tokens) < n_vocab - 1:
        tokens.append(f"<|extra_{len(tokens)}|>")
    tokens.append("<|endoftext|>")
    eot = len(tokens) - 1
    return {"model": "gpt2", "tokens": tokens,
            "token_type": [1] * eot + [3], "merges": merges,
            "bos": eot, "eos": eot}


def wpm_vocab(n_vocab: int, text: str = CORPUS) -> dict:
    """A WordPiece vocab in GGUF form (convert-hf-to-gguf's BertModel:
    a word start "▁w", a continuation piece "w"): the specials [PAD]
    [UNK] [CLS] [SEP] [MASK], the lower-cased words of `text`, each
    character of it as a start and as a continuation, and fillers."""
    import unicodedata
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    norm = "".join(c for c in unicodedata.normalize("NFD", text.lower())
                   if unicodedata.category(c) != "Mn")
    words = sorted({w.strip(".,!?;'") for w in norm.split()} - {""})
    chars = sorted(set(norm) - set(" "))
    pieces = (["▁" + w for w in words] + ["▁" + c for c in chars] + chars)
    tokens = specials + list(dict.fromkeys(pieces))
    while len(tokens) < n_vocab:
        tokens.append(f"▁extra{len(tokens)}")
    tokens = tokens[:n_vocab]
    return {"model": "bert", "tokens": tokens,
            "token_type": [3] * len(specials)
            + [1] * (len(tokens) - len(specials)),
            "bos": 2, "eos": 3, "unk": 1}


def _add_vocab(w: GGUFWriter, kind: str, n_vocab: int) -> None:
    """The tokenizer metadata of a synthetic vocab: "llama"/"spm", "bpe"
    or "wpm"."""
    if kind in ("llama", "spm"):
        voc = spm_vocab(n_vocab)
        w.add_kv("tokenizer.ggml.model", "llama")
        w.add_kv("tokenizer.ggml.tokens", voc["tokens"])
        w.add_kv("tokenizer.ggml.scores",
                 np.asarray(voc["scores"], np.float32))
        w.add_kv("tokenizer.ggml.token_type",
                 np.asarray(voc["token_type"], np.int32))
        w.add_kv("tokenizer.ggml.bos_token_id", 1)
        w.add_kv("tokenizer.ggml.eos_token_id", 2)
        return
    voc = bpe_vocab(n_vocab) if kind == "bpe" else wpm_vocab(n_vocab)
    w.add_kv("tokenizer.ggml.model", voc["model"])
    w.add_kv("tokenizer.ggml.tokens", voc["tokens"])
    w.add_kv("tokenizer.ggml.token_type",
             np.asarray(voc["token_type"], np.int32))
    if voc.get("merges"):
        w.add_kv("tokenizer.ggml.merges", voc["merges"])
    w.add_kv("tokenizer.ggml.bos_token_id", voc["bos"])
    w.add_kv("tokenizer.ggml.eos_token_id", voc["eos"])
    if "unk" in voc:
        w.add_kv("tokenizer.ggml.unknown_token_id", voc["unk"])


class LazyStateDict:
    """A read-only state dict whose tensors are drawn when read: name ->
    fn(rng) with an rng seeded by (seed, crc32(name)), so a tensor does not
    depend on the order of reads and the f32 source of a large model is
    never whole in memory (the converter quantizes one tensor at a time)."""

    def __init__(self, makers: dict, seed: int):
        self.makers = makers
        self.seed = seed

    def __contains__(self, name) -> bool:
        return name in self.makers

    def __getitem__(self, name) -> np.ndarray:
        rng = np.random.default_rng((self.seed, zlib.crc32(name.encode())))
        return np.asarray(self.makers[name](rng), np.float32)


def _normal(shape, std):
    return lambda rng: rng.standard_normal(shape, np.float32) * std


def _const(shape, value):
    return lambda rng: np.full(shape, value, np.float32)


def write_mamba_gguf(path: str, n_layers: int, seed: int, dim: int,
                     d_inner: int, d_state: int, d_conv: int, dt_rank: int,
                     vocab: int, qtype=GGMLType.Q4_0) -> None:
    """A Mamba GGUF through convert_hf.convert_mamba, the tied head (no
    lm_head), from a state dict of HF MambaForCausalLM names drawn as that
    model initializes them: projections N(0, 0.02), but out_proj N(0,
    0.2 / sqrt(n_layers)) (at 0.02 the mixers' updates are small beside
    the tied embedding, and greedy decoding repeats its input token);
    dt_proj weight uniform in +-dt_rank^-0.5 and its bias the inverse
    softplus of dt log-uniform in [1e-3, 1e-1], A_log = log(1..d_state),
    D = 1, the conv uniform in +-d_conv^-0.5, norms 1.
    qtype quantizes every 2-D weight the converter quantizes (in_proj,
    out_proj, the embedding)."""
    from tpulamm_torch.tools.convert_hf import convert_mamba

    def dt_bias(rng):
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), d_inner))
        return dt + np.log(-np.expm1(-dt))

    a_log = np.log(np.arange(1, d_state + 1, dtype=np.float32))
    mk = {"backbone.embeddings.weight": _normal((vocab, dim), 0.02),
          "backbone.norm_f.weight": _const((dim,), 1.0)}
    for i in range(n_layers):
        h = f"backbone.layers.{i}."
        mk.update({
            h + "norm.weight": _const((dim,), 1.0),
            h + "mixer.in_proj.weight": _normal((2 * d_inner, dim), 0.02),
            h + "mixer.conv1d.weight": lambda rng: rng.uniform(
                -d_conv ** -0.5, d_conv ** -0.5, (d_inner, 1, d_conv)),
            h + "mixer.conv1d.bias": lambda rng: rng.uniform(
                -d_conv ** -0.5, d_conv ** -0.5, d_inner),
            h + "mixer.x_proj.weight": _normal(
                (dt_rank + 2 * d_state, d_inner), 0.02),
            h + "mixer.dt_proj.weight": lambda rng: rng.uniform(
                -dt_rank ** -0.5, dt_rank ** -0.5, (d_inner, dt_rank)),
            h + "mixer.dt_proj.bias": dt_bias,
            h + "mixer.A_log": lambda rng: np.broadcast_to(
                a_log, (d_inner, d_state)),
            h + "mixer.D": _const((d_inner,), 1.0),
            h + "mixer.out_proj.weight": _normal(
                (dim, d_inner), 0.2 / np.sqrt(n_layers)),
        })
    cfg = SimpleNamespace(
        model_type="mamba", hidden_size=dim, num_hidden_layers=n_layers,
        intermediate_size=d_inner, state_size=d_state, conv_kernel=d_conv,
        time_step_rank=dt_rank, vocab_size=vocab, layer_norm_epsilon=1e-5)
    convert_mamba(LazyStateDict(mk, seed), cfg, path, qtype=qtype)


# llava-v1.6-vicuna-7b's config.json image_grid_pinpoints, flattened
LLAVA16_PINPOINTS = (336, 672, 672, 336, 672, 672, 1008, 336, 336, 1008)


def write_clip_gguf(path: str, seed: int, hidden: int, n_heads: int,
                    n_layers: int, ffn: int, image: int, patch: int,
                    proj_dim: int, skip_last: int = 1,
                    pinpoints: tuple = (), merge: str | None = None) -> None:
    """An mmproj GGUF through convert_hf.convert_hf_clip: a CLIP vision
    tower (quick_gelu) with llava-1.5's `mlp` projector to proj_dim, from
    a state dict of HF CLIPVisionModel names (weights N(0, 0.02), biases
    N(0, 0.01), the class and position embeddings N(0, 0.02), norms 1);
    the last skip_last blocks are not written (llava's
    vision_feature_layer -2). pinpoints / merge: llava-1.6's anyres keys,
    with an image_newline of N(0, 0.02) under "spatial_unpad"."""
    from tpulamm_torch.tools.convert_hf import convert_hf_clip
    pre = "vision_model."
    n_pos = (image // patch) ** 2 + 1
    mk = {pre + "embeddings.patch_embedding.weight": _normal(
              (hidden, 3, patch, patch), 0.02),
          pre + "embeddings.class_embedding": _normal((hidden,), 0.02),
          pre + "embeddings.position_embedding.weight": _normal(
              (n_pos, hidden), 0.02),
          pre + "pre_layrnorm.weight": _const((hidden,), 1.0),
          pre + "pre_layrnorm.bias": _const((hidden,), 0.0)}
    shapes = {"self_attn.q_proj": (hidden, hidden),
              "self_attn.k_proj": (hidden, hidden),
              "self_attn.v_proj": (hidden, hidden),
              "self_attn.out_proj": (hidden, hidden),
              "mlp.fc1": (ffn, hidden), "mlp.fc2": (hidden, ffn)}
    for i in range(n_layers - skip_last):
        h = f"{pre}encoder.layers.{i}."
        for name, shape in shapes.items():
            mk[h + name + ".weight"] = _normal(shape, 0.02)
            mk[h + name + ".bias"] = _normal((shape[0],), 0.01)
        for ln in ("layer_norm1", "layer_norm2"):
            mk[h + ln + ".weight"] = _const((hidden,), 1.0)
            mk[h + ln + ".bias"] = _const((hidden,), 0.0)
    sd = LazyStateDict(mk, seed)
    proj = LazyStateDict({
        "multi_modal_projector.linear_1.weight": _normal(
            (proj_dim, hidden), 0.02),
        "multi_modal_projector.linear_1.bias": _normal((proj_dim,), 0.01),
        "multi_modal_projector.linear_2.weight": _normal(
            (proj_dim, proj_dim), 0.02),
        "multi_modal_projector.linear_2.bias": _normal((proj_dim,), 0.01)},
        seed + 1)
    proj_sd = {k: proj[k] for k in proj.makers}
    cfg = SimpleNamespace(
        num_hidden_layers=n_layers, hidden_size=hidden,
        intermediate_size=ffn, num_attention_heads=n_heads,
        layer_norm_eps=1e-5, image_size=image, patch_size=patch)
    newline = (LazyStateDict({"nl": _normal((proj_dim,), 0.02)}, seed + 2)
               ["nl"] if merge == "spatial_unpad" else None)
    convert_hf_clip(sd, cfg, path, proj_sd=proj_sd, skip_last=skip_last,
                    image_grid_pinpoints=pinpoints, mm_patch_merge_type=merge,
                    image_newline=newline)
