"""HF checkpoint -> GGUF converter for every reference architecture
(counterpart of tpulamm.tools.convert_hf; numpy only, writing through the
port's gguf.writer and quant.formats, so its files equal the JAX
converter's byte for byte).

Capability parity with the reference's convert.py (llama.cpp-b2430/convert.py,
LLaMA family) and convert-hf-to-gguf.py (2,056 LoC, many archs): maps HF
tensor names to GGUF names, applies the per-arch weight transforms the
reference applies, writes hparams + tokenizer metadata, and optionally
quantizes weights. The notable transforms (same as the reference):

- llama family: rope permutation converting HF's half-split rotary layout to
  ggml's interleaved NORM layout (convert.py `permute`)
- falcon: de-interleave kv-group fused qkv into contiguous q|k|v
  (convert-hf-to-gguf.py FalconModel.write_tensors)
- bloom: de-interleave (n_head, 3, hd) fused qkv (BloomModel.write_tensors)
- gpt2: transpose Conv1D weights (GPT2Model writes transposed)
- gemma: +1.0 on rms-norm weights (GemmaModel.write_tensors)
- mamba: ssm_a = -exp(A_log) (MambaModel.write_tensors)
- persimmon: fused qkv kept per-head interleaved (PersimmonModel; the
  graph/our loader expects exactly that layout)

The input is a state dict of numpy arrays (or tensors) and an attribute
config (an HF config, or a types.SimpleNamespace with its field names), so
nothing here needs `transformers`: convert_hf takes an HF model, or a
state dict with `config=`.
"""

from __future__ import annotations

import numpy as np

from tpulamm_torch.gguf.constants import GGML_TYPE_SIZES, GGMLType
from tpulamm_torch.gguf.writer import GGUFWriter
from tpulamm_torch.quant.formats import quantize

# 1-D tensors and these roles always stay F32 (same policy as
# llama_model_quantize_internal for non-matmul tensors)
_NEVER_QUANT = ("position_embd", "token_types", "ssm_conv1d", "ssm_a",
                "ssm_d", "ssm_dt", "ssm_x", "rope_freqs", ".act.")


def permute_rope(w: np.ndarray, n_head: int) -> np.ndarray:
    """HF half-split rotary rows -> ggml interleaved NORM rows."""
    out_dim = w.shape[0]
    return (w.reshape(n_head, 2, out_dim // n_head // 2, *w.shape[1:])
             .swapaxes(1, 2).reshape(w.shape))


class ModelWriter:
    """GGUFWriter wrapper with the converter's quantization policy."""

    def __init__(self, out_path: str, arch: str, qtype: GGMLType):
        self.w = GGUFWriter(out_path)
        self.arch = arch
        self.qtype = qtype
        self.kv("general.architecture", arch)

    def kv(self, key: str, val):
        self.w.add_kv(key, val)

    def akv(self, key: str, val):
        """arch-prefixed KV."""
        self.w.add_kv(f"{self.arch}.{key}", val)

    def tensor(self, name: str, x: np.ndarray):
        x = np.asarray(x, np.float32)
        tq = self.qtype
        if (x.ndim != 2 or any(s in name for s in _NEVER_QUANT)
                or "norm" in name):
            tq = GGMLType.F32
        if tq != GGMLType.F32:
            bs = GGML_TYPE_SIZES[tq][0]
            if x.shape[-1] % bs != 0:
                tq = GGMLType.F32      # dims not blockable stay dense
        if tq == GGMLType.F32:
            self.w.add_tensor(name, x)
        else:
            raw = quantize(x, tq)
            self.w.add_tensor(name, raw, shape=x.shape, ggml_type=tq)

    def maybe(self, sd: dict, hf_name: str, gguf_name: str, transform=None):
        if hf_name in sd:
            x = np.asarray(sd[hf_name], np.float32)
            if transform is not None:
                x = transform(x)
            self.tensor(gguf_name, x)
            return True
        return False

    def vocab(self, vocab: dict | None):
        if not vocab:
            return
        self.kv("tokenizer.ggml.model", vocab.get("model", "llama"))
        self.kv("tokenizer.ggml.tokens", list(vocab["tokens"]))
        if "scores" in vocab:
            self.kv("tokenizer.ggml.scores",
                    np.asarray(vocab["scores"], np.float32))
        if "token_type" in vocab:
            self.kv("tokenizer.ggml.token_type",
                    np.asarray(vocab["token_type"], np.int32))
        if "merges" in vocab:
            self.kv("tokenizer.ggml.merges", list(vocab["merges"]))
        for k in ("bos", "eos", "unk", "pad"):
            if k in vocab:
                self.kv(f"tokenizer.ggml.{k}_token_id", int(vocab[k]))

    def write(self):
        self.w.write()


def _common_kv(W: ModelWriter, c, *, n_ctx_key="max_position_embeddings",
               rms=True):
    n_head = int(c.num_attention_heads)
    n_kv = int(getattr(c, "num_key_value_heads", None) or n_head)
    W.kv("general.name", getattr(c, "name_or_path", "") or "converted")
    W.akv("context_length", int(getattr(c, n_ctx_key, 2048) or 2048))
    W.akv("embedding_length", int(c.hidden_size))
    W.akv("block_count", int(c.num_hidden_layers))
    W.akv("feed_forward_length",
          int(getattr(c, "intermediate_size", None) or 4 * c.hidden_size))
    W.akv("attention.head_count", n_head)
    W.akv("attention.head_count_kv", n_kv)
    if rms:
        W.akv("attention.layer_norm_rms_epsilon",
              float(getattr(c, "rms_norm_eps", 1e-5)))
    else:
        W.akv("attention.layer_norm_epsilon",
              float(getattr(c, "layer_norm_epsilon",
                            getattr(c, "layer_norm_eps", 1e-5))))
    W.akv("vocab_size", int(c.vocab_size))
    return n_head, n_kv


def _rope_kv(W: ModelWriter, c, n_rot: int):
    W.akv("rope.dimension_count", int(n_rot))
    W.akv("rope.freq_base", float(getattr(c, "rope_theta", 10000.0)))


# ---------------------------------------------------------------------------
# llama family (llama / mixtral / internlm2 / orion-style naming)
# ---------------------------------------------------------------------------

def convert_llama_family(sd: dict, c, out_path: str, *, arch: str = "llama",
                         qtype=GGMLType.F32, vocab=None, rms=True,
                         permute_qk=True) -> None:
    n_head = int(c.num_attention_heads)
    n_kv = int(getattr(c, "num_key_value_heads", None) or n_head)
    head_dim = int(c.hidden_size) // n_head
    W = ModelWriter(out_path, arch, qtype)
    _common_kv(W, c, rms=rms)
    _rope_kv(W, c, head_dim)
    if getattr(c, "num_local_experts", 0):
        W.akv("expert_count", int(c.num_local_experts))
        W.akv("expert_used_count", int(c.num_experts_per_tok))
    W.vocab(vocab)

    pq = (lambda x: permute_rope(x, n_head)) if permute_qk else None
    pk = (lambda x: permute_rope(x, n_kv)) if permute_qk else None
    W.maybe(sd, "model.embed_tokens.weight", "token_embd.weight")
    W.maybe(sd, "model.norm.weight", "output_norm.weight")
    W.maybe(sd, "lm_head.weight", "output.weight")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"model.layers.{i}.", f"blk.{i}."
        W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "self_attn.q_proj.weight", g + "attn_q.weight", pq)
        W.maybe(sd, h + "self_attn.k_proj.weight", g + "attn_k.weight", pk)
        W.maybe(sd, h + "self_attn.q_proj.bias", g + "attn_q.bias", pq)
        W.maybe(sd, h + "self_attn.k_proj.bias", g + "attn_k.bias", pk)
        W.maybe(sd, h + "self_attn.v_proj.weight", g + "attn_v.weight")
        W.maybe(sd, h + "self_attn.v_proj.bias", g + "attn_v.bias")
        W.maybe(sd, h + "self_attn.o_proj.weight", g + "attn_output.weight")
        W.maybe(sd, h + "post_attention_layernorm.weight",
                g + "ffn_norm.weight")
        W.maybe(sd, h + "mlp.gate_proj.weight", g + "ffn_gate.weight")
        W.maybe(sd, h + "mlp.up_proj.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.down_proj.weight", g + "ffn_down.weight")
        # mixtral MoE
        W.maybe(sd, h + "block_sparse_moe.gate.weight",
                g + "ffn_gate_inp.weight")
        e = 0
        while h + f"block_sparse_moe.experts.{e}.w1.weight" in sd:
            W.maybe(sd, h + f"block_sparse_moe.experts.{e}.w1.weight",
                    g + f"ffn_gate.{e}.weight")
            W.maybe(sd, h + f"block_sparse_moe.experts.{e}.w2.weight",
                    g + f"ffn_down.{e}.weight")
            W.maybe(sd, h + f"block_sparse_moe.experts.{e}.w3.weight",
                    g + f"ffn_up.{e}.weight")
            e += 1
    W.write()


# back-compat name used by the original llama-only converter
def convert_hf_llama(state_dict: dict, hf_config, out_path: str,
                     qtype: GGMLType = GGMLType.F32,
                     vocab: dict | None = None) -> None:
    convert_llama_family(state_dict, hf_config, out_path, qtype=qtype,
                         vocab=vocab)


# ---------------------------------------------------------------------------
# per-arch converters
# ---------------------------------------------------------------------------

def convert_gpt2(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                 vocab=None) -> None:
    W = ModelWriter(out_path, "gpt2", qtype)
    W.kv("general.name", "gpt2")
    W.akv("context_length", int(c.n_positions))
    W.akv("embedding_length", int(c.n_embd))
    W.akv("block_count", int(c.n_layer))
    W.akv("feed_forward_length", int(getattr(c, "n_inner", None) or 4 * c.n_embd))
    W.akv("attention.head_count", int(c.n_head))
    W.akv("attention.head_count_kv", int(c.n_head))
    W.akv("attention.layer_norm_epsilon", float(c.layer_norm_epsilon))
    W.akv("vocab_size", int(c.vocab_size))
    W.vocab(vocab)
    T = np.transpose      # HF gpt2 Conv1D stores (in, out)
    W.maybe(sd, "transformer.wte.weight", "token_embd.weight")
    W.maybe(sd, "transformer.wpe.weight", "position_embd.weight")
    W.maybe(sd, "transformer.ln_f.weight", "output_norm.weight")
    W.maybe(sd, "transformer.ln_f.bias", "output_norm.bias")
    for i in range(int(c.n_layer)):
        h, g = f"transformer.h.{i}.", f"blk.{i}."
        W.maybe(sd, h + "ln_1.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "ln_1.bias", g + "attn_norm.bias")
        W.maybe(sd, h + "attn.c_attn.weight", g + "attn_qkv.weight", T)
        W.maybe(sd, h + "attn.c_attn.bias", g + "attn_qkv.bias")
        W.maybe(sd, h + "attn.c_proj.weight", g + "attn_output.weight", T)
        W.maybe(sd, h + "attn.c_proj.bias", g + "attn_output.bias")
        W.maybe(sd, h + "ln_2.weight", g + "ffn_norm.weight")
        W.maybe(sd, h + "ln_2.bias", g + "ffn_norm.bias")
        W.maybe(sd, h + "mlp.c_fc.weight", g + "ffn_up.weight", T)
        W.maybe(sd, h + "mlp.c_fc.bias", g + "ffn_up.bias")
        W.maybe(sd, h + "mlp.c_proj.weight", g + "ffn_down.weight", T)
        W.maybe(sd, h + "mlp.c_proj.bias", g + "ffn_down.bias")
    W.write()


def convert_gptj(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                 vocab=None) -> None:
    """GPT-J (GPTJForCausalLM): parallel residual with one shared norm,
    partial interleaved rope (rotary_dim), biased lm head."""
    W = ModelWriter(out_path, "gptj", qtype)
    W.kv("general.name", "gptj")
    W.akv("context_length", int(c.n_positions))
    W.akv("embedding_length", int(c.n_embd))
    W.akv("block_count", int(c.n_layer))
    W.akv("feed_forward_length",
          int(getattr(c, "n_inner", None) or 4 * c.n_embd))
    W.akv("attention.head_count", int(c.n_head))
    W.akv("attention.head_count_kv", int(c.n_head))
    W.akv("attention.layer_norm_epsilon", float(c.layer_norm_epsilon))
    W.akv("rope.dimension_count", int(c.rotary_dim))
    W.akv("vocab_size", int(c.vocab_size))
    W.vocab(vocab)
    W.maybe(sd, "transformer.wte.weight", "token_embd.weight")
    W.maybe(sd, "transformer.ln_f.weight", "output_norm.weight")
    W.maybe(sd, "transformer.ln_f.bias", "output_norm.bias")
    W.maybe(sd, "lm_head.weight", "output.weight")
    W.maybe(sd, "lm_head.bias", "output.bias")
    for i in range(int(c.n_layer)):
        h, g = f"transformer.h.{i}.", f"blk.{i}."
        W.maybe(sd, h + "ln_1.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "ln_1.bias", g + "attn_norm.bias")
        # HF rotate_every_two == ggml "norm" interleaved rope: no permute
        W.maybe(sd, h + "attn.q_proj.weight", g + "attn_q.weight")
        W.maybe(sd, h + "attn.k_proj.weight", g + "attn_k.weight")
        W.maybe(sd, h + "attn.v_proj.weight", g + "attn_v.weight")
        W.maybe(sd, h + "attn.out_proj.weight", g + "attn_output.weight")
        W.maybe(sd, h + "mlp.fc_in.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.fc_in.bias", g + "ffn_up.bias")
        W.maybe(sd, h + "mlp.fc_out.weight", g + "ffn_down.weight")
        W.maybe(sd, h + "mlp.fc_out.bias", g + "ffn_down.bias")
    W.write()


def convert_gptneox(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                    vocab=None) -> None:
    """GPT-NeoX (GPTNeoXForCausalLM): per-head-interleaved fused qkv is
    de-interleaved into separate q|k|v (convert-hf-to-gguf.py GPTNeoXModel
    does the same); parallel residual per use_parallel_residual with the
    FFN fed from post_attention_layernorm; partial neox rope (rotary_pct)."""
    n_head = int(c.num_attention_heads)
    hd = int(c.hidden_size) // n_head
    W = ModelWriter(out_path, "gptneox", qtype)
    W.kv("general.name", "gptneox")
    W.akv("context_length", int(c.max_position_embeddings))
    W.akv("embedding_length", int(c.hidden_size))
    W.akv("block_count", int(c.num_hidden_layers))
    W.akv("feed_forward_length", int(c.intermediate_size))
    W.akv("attention.head_count", n_head)
    W.akv("attention.head_count_kv", n_head)
    W.akv("attention.layer_norm_epsilon", float(c.layer_norm_eps))
    W.akv("rope.dimension_count", int(hd * float(c.rotary_pct)))
    W.akv("rope.freq_base", float(getattr(c, "rotary_emb_base", 10000.0)))
    W.akv("use_parallel_residual",
          bool(getattr(c, "use_parallel_residual", True)))
    W.akv("vocab_size", int(c.vocab_size))
    W.vocab(vocab)

    def part(which):
        # HF fuses qkv per head: rows are [h0:q,k,v | h1:q,k,v | ...]
        def f(x):
            y = x.reshape(n_head, 3, hd, -1)[:, which]
            y = y.reshape(n_head * hd, -1)
            return y if x.ndim == 2 else y.reshape(-1)
        return f

    W.maybe(sd, "gpt_neox.embed_in.weight", "token_embd.weight")
    W.maybe(sd, "gpt_neox.final_layer_norm.weight", "output_norm.weight")
    W.maybe(sd, "gpt_neox.final_layer_norm.bias", "output_norm.bias")
    W.maybe(sd, "embed_out.weight", "output.weight")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"gpt_neox.layers.{i}.", f"blk.{i}."
        W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "input_layernorm.bias", g + "attn_norm.bias")
        W.maybe(sd, h + "post_attention_layernorm.weight",
                g + "ffn_norm.weight")
        W.maybe(sd, h + "post_attention_layernorm.bias", g + "ffn_norm.bias")
        for which, nm in ((0, "attn_q"), (1, "attn_k"), (2, "attn_v")):
            W.maybe(sd, h + "attention.query_key_value.weight",
                    g + f"{nm}.weight", part(which))
            W.maybe(sd, h + "attention.query_key_value.bias",
                    g + f"{nm}.bias", part(which))
        W.maybe(sd, h + "attention.dense.weight", g + "attn_output.weight")
        W.maybe(sd, h + "attention.dense.bias", g + "attn_output.bias")
        W.maybe(sd, h + "mlp.dense_h_to_4h.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.dense_h_to_4h.bias", g + "ffn_up.bias")
        W.maybe(sd, h + "mlp.dense_4h_to_h.weight", g + "ffn_down.weight")
        W.maybe(sd, h + "mlp.dense_4h_to_h.bias", g + "ffn_down.bias")
    W.write()


def convert_falcon(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                   vocab=None) -> None:
    n_head = int(c.num_attention_heads)
    n_kv = int(getattr(c, "num_kv_heads", None) or 1) \
        if getattr(c, "new_decoder_architecture", False) else \
        (n_head if not getattr(c, "multi_query", True) else 1)
    hd = int(c.hidden_size) // n_head
    W = ModelWriter(out_path, "falcon", qtype)
    W.kv("general.name", "falcon")
    W.akv("context_length", 2048)
    W.akv("embedding_length", int(c.hidden_size))
    W.akv("block_count", int(c.num_hidden_layers))
    W.akv("feed_forward_length", 4 * int(c.hidden_size))
    W.akv("attention.head_count", n_head)
    W.akv("attention.head_count_kv", n_kv)
    W.akv("attention.layer_norm_epsilon", float(c.layer_norm_epsilon))
    W.akv("vocab_size", int(c.vocab_size))
    W.vocab(vocab)

    def deinterleave(x):
        # kv-grouped [q*(H/Hkv), k, v] per group -> contiguous q|k|v
        # (convert-hf-to-gguf.py FalconModel)
        qkv = x.reshape(n_kv, n_head // n_kv + 2, hd, -1)
        q = qkv[:, :-2].reshape(n_head * hd, -1)
        k = qkv[:, -2].reshape(n_kv * hd, -1)
        v = qkv[:, -1].reshape(n_kv * hd, -1)
        out = np.concatenate([q, k, v], axis=0)
        return out if x.ndim == 2 else out.reshape(-1)

    W.maybe(sd, "transformer.word_embeddings.weight", "token_embd.weight")
    W.maybe(sd, "transformer.ln_f.weight", "output_norm.weight")
    W.maybe(sd, "transformer.ln_f.bias", "output_norm.bias")
    W.maybe(sd, "lm_head.weight", "output.weight")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"transformer.h.{i}.", f"blk.{i}."
        # falcon-40B: ln_attn feeds attention, ln_mlp feeds ffn;
        # falcon-7B: single input_layernorm
        if h + "ln_attn.weight" in sd:
            W.maybe(sd, h + "ln_mlp.weight", g + "attn_norm.weight")
            W.maybe(sd, h + "ln_mlp.bias", g + "attn_norm.bias")
            W.maybe(sd, h + "ln_attn.weight", g + "attn_norm_2.weight")
            W.maybe(sd, h + "ln_attn.bias", g + "attn_norm_2.bias")
        else:
            W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight")
            W.maybe(sd, h + "input_layernorm.bias", g + "attn_norm.bias")
        W.maybe(sd, h + "self_attention.query_key_value.weight",
                g + "attn_qkv.weight", deinterleave)
        W.maybe(sd, h + "self_attention.dense.weight",
                g + "attn_output.weight")
        W.maybe(sd, h + "mlp.dense_h_to_4h.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.dense_4h_to_h.weight", g + "ffn_down.weight")
    W.write()


def convert_gptbigcode(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                       vocab=None) -> None:
    """starcoder (GPTBigCodeForCausalLM): MQA, learned positions, gelu."""
    W = ModelWriter(out_path, "starcoder", qtype)
    W.kv("general.name", "starcoder")
    W.akv("context_length", int(c.n_positions))
    W.akv("embedding_length", int(c.n_embd))
    W.akv("block_count", int(c.n_layer))
    W.akv("feed_forward_length", int(getattr(c, "n_inner", None) or 4 * c.n_embd))
    W.akv("attention.head_count", int(c.n_head))
    W.akv("attention.head_count_kv", 1 if c.multi_query else int(c.n_head))
    W.akv("attention.layer_norm_epsilon", float(c.layer_norm_epsilon))
    W.akv("vocab_size", int(c.vocab_size))
    W.vocab(vocab)
    W.maybe(sd, "transformer.wte.weight", "token_embd.weight")
    W.maybe(sd, "transformer.wpe.weight", "position_embd.weight")
    W.maybe(sd, "transformer.ln_f.weight", "output_norm.weight")
    W.maybe(sd, "transformer.ln_f.bias", "output_norm.bias")
    W.maybe(sd, "lm_head.weight", "output.weight")
    for i in range(int(c.n_layer)):
        h, g = f"transformer.h.{i}.", f"blk.{i}."
        W.maybe(sd, h + "ln_1.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "ln_1.bias", g + "attn_norm.bias")
        W.maybe(sd, h + "attn.c_attn.weight", g + "attn_qkv.weight")
        W.maybe(sd, h + "attn.c_attn.bias", g + "attn_qkv.bias")
        W.maybe(sd, h + "attn.c_proj.weight", g + "attn_output.weight")
        W.maybe(sd, h + "attn.c_proj.bias", g + "attn_output.bias")
        W.maybe(sd, h + "ln_2.weight", g + "ffn_norm.weight")
        W.maybe(sd, h + "ln_2.bias", g + "ffn_norm.bias")
        W.maybe(sd, h + "mlp.c_fc.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.c_fc.bias", g + "ffn_up.bias")
        W.maybe(sd, h + "mlp.c_proj.weight", g + "ffn_down.weight")
        W.maybe(sd, h + "mlp.c_proj.bias", g + "ffn_down.bias")
    W.write()


def convert_bloom(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                  vocab=None) -> None:
    n_head = int(c.n_head)
    n_embd = int(c.hidden_size)
    hd = n_embd // n_head
    W = ModelWriter(out_path, "bloom", qtype)
    W.kv("general.name", "bloom")
    W.akv("context_length", n_embd)
    W.akv("embedding_length", n_embd)
    W.akv("block_count", int(c.n_layer))
    W.akv("feed_forward_length", 4 * n_embd)
    W.akv("attention.head_count", n_head)
    W.akv("attention.head_count_kv", n_head)
    W.akv("attention.layer_norm_epsilon", float(c.layer_norm_epsilon))
    W.akv("vocab_size", int(c.vocab_size))
    W.vocab(vocab)

    def deint_w(x):
        q = x.reshape(n_head, 3, hd, n_embd)
        return np.concatenate([q[:, 0].reshape(-1, n_embd),
                               q[:, 1].reshape(-1, n_embd),
                               q[:, 2].reshape(-1, n_embd)], axis=0)

    def deint_b(x):
        q = x.reshape(n_head, 3, hd)
        return np.concatenate([q[:, 0].ravel(), q[:, 1].ravel(),
                               q[:, 2].ravel()])

    W.maybe(sd, "transformer.word_embeddings.weight", "token_embd.weight")
    W.maybe(sd, "transformer.word_embeddings_layernorm.weight",
            "token_embd_norm.weight")
    W.maybe(sd, "transformer.word_embeddings_layernorm.bias",
            "token_embd_norm.bias")
    W.maybe(sd, "transformer.ln_f.weight", "output_norm.weight")
    W.maybe(sd, "transformer.ln_f.bias", "output_norm.bias")
    for i in range(int(c.n_layer)):
        h, g = f"transformer.h.{i}.", f"blk.{i}."
        W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "input_layernorm.bias", g + "attn_norm.bias")
        W.maybe(sd, h + "self_attention.query_key_value.weight",
                g + "attn_qkv.weight", deint_w)
        W.maybe(sd, h + "self_attention.query_key_value.bias",
                g + "attn_qkv.bias", deint_b)
        W.maybe(sd, h + "self_attention.dense.weight",
                g + "attn_output.weight")
        W.maybe(sd, h + "self_attention.dense.bias", g + "attn_output.bias")
        W.maybe(sd, h + "post_attention_layernorm.weight",
                g + "ffn_norm.weight")
        W.maybe(sd, h + "post_attention_layernorm.bias", g + "ffn_norm.bias")
        W.maybe(sd, h + "mlp.dense_h_to_4h.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.dense_h_to_4h.bias", g + "ffn_up.bias")
        W.maybe(sd, h + "mlp.dense_4h_to_h.weight", g + "ffn_down.weight")
        W.maybe(sd, h + "mlp.dense_4h_to_h.bias", g + "ffn_down.bias")
    W.write()


def convert_mpt(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                vocab=None) -> None:
    attn_cfg = getattr(c, "attn_config", {}) or {}
    if not isinstance(attn_cfg, dict):
        attn_cfg = attn_cfg.to_dict() if hasattr(attn_cfg, "to_dict") \
            else vars(attn_cfg)
    W = ModelWriter(out_path, "mpt", qtype)
    W.kv("general.name", "mpt")
    W.akv("context_length", int(c.max_seq_len))
    W.akv("embedding_length", int(c.d_model))
    W.akv("block_count", int(c.n_layers))
    W.akv("feed_forward_length", int(getattr(c, "expansion_ratio", 4)) * int(c.d_model))
    W.akv("attention.head_count", int(c.n_heads))
    W.akv("attention.head_count_kv",
          int(attn_cfg.get("kv_n_heads", 0)) or int(c.n_heads))
    W.akv("attention.layer_norm_epsilon", 1e-5)
    W.akv("attention.max_alibi_bias",
          float(attn_cfg.get("alibi_bias_max", 8.0)))
    if attn_cfg.get("clip_qkv"):
        W.akv("attention.clamp_kqv", float(attn_cfg["clip_qkv"]))
    W.akv("vocab_size", int(c.vocab_size))
    W.vocab(vocab)
    W.maybe(sd, "transformer.wte.weight", "token_embd.weight")
    W.maybe(sd, "transformer.norm_f.weight", "output_norm.weight")
    W.maybe(sd, "transformer.norm_f.bias", "output_norm.bias")
    for i in range(int(c.n_layers)):
        h, g = f"transformer.blocks.{i}.", f"blk.{i}."
        W.maybe(sd, h + "norm_1.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "norm_1.bias", g + "attn_norm.bias")
        W.maybe(sd, h + "attn.Wqkv.weight", g + "attn_qkv.weight")
        W.maybe(sd, h + "attn.Wqkv.bias", g + "attn_qkv.bias")
        W.maybe(sd, h + "attn.out_proj.weight", g + "attn_output.weight")
        W.maybe(sd, h + "norm_2.weight", g + "ffn_norm.weight")
        W.maybe(sd, h + "norm_2.bias", g + "ffn_norm.bias")
        W.maybe(sd, h + "ffn.up_proj.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "ffn.down_proj.weight", g + "ffn_down.weight")
    W.write()


def convert_phi2(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                 vocab=None) -> None:
    n_head = int(c.num_attention_heads)
    hd = int(c.hidden_size) // n_head
    n_rot = int(round(float(getattr(c, "partial_rotary_factor", 0.5)) * hd))
    W = ModelWriter(out_path, "phi2", qtype)
    _common_kv(W, c, rms=False)
    _rope_kv(W, c, n_rot)
    W.vocab(vocab)
    W.maybe(sd, "model.embed_tokens.weight", "token_embd.weight")
    W.maybe(sd, "model.final_layernorm.weight", "output_norm.weight")
    W.maybe(sd, "model.final_layernorm.bias", "output_norm.bias")
    W.maybe(sd, "lm_head.weight", "output.weight")
    W.maybe(sd, "lm_head.bias", "output.bias")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"model.layers.{i}.", f"blk.{i}."
        W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "input_layernorm.bias", g + "attn_norm.bias")
        for p, t in (("q_proj", "attn_q"), ("k_proj", "attn_k"),
                     ("v_proj", "attn_v")):
            W.maybe(sd, h + f"self_attn.{p}.weight", g + f"{t}.weight")
            W.maybe(sd, h + f"self_attn.{p}.bias", g + f"{t}.bias")
        W.maybe(sd, h + "self_attn.dense.weight", g + "attn_output.weight")
        W.maybe(sd, h + "self_attn.dense.bias", g + "attn_output.bias")
        W.maybe(sd, h + "mlp.fc1.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.fc1.bias", g + "ffn_up.bias")
        W.maybe(sd, h + "mlp.fc2.weight", g + "ffn_down.weight")
        W.maybe(sd, h + "mlp.fc2.bias", g + "ffn_down.bias")
    W.write()


def convert_stablelm(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                     vocab=None) -> None:
    n_head = int(c.num_attention_heads)
    hd = int(c.hidden_size) // n_head
    n_rot = int(float(getattr(c, "partial_rotary_factor",
                              getattr(c, "rope_pct", 0.25))) * hd)
    W = ModelWriter(out_path, "stablelm", qtype)
    _common_kv(W, c, rms=False)
    _rope_kv(W, c, n_rot)
    W.vocab(vocab)
    W.maybe(sd, "model.embed_tokens.weight", "token_embd.weight")
    W.maybe(sd, "model.norm.weight", "output_norm.weight")
    W.maybe(sd, "model.norm.bias", "output_norm.bias")
    W.maybe(sd, "lm_head.weight", "output.weight")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"model.layers.{i}.", f"blk.{i}."
        W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "input_layernorm.bias", g + "attn_norm.bias")
        for p, t in (("q_proj", "attn_q"), ("k_proj", "attn_k"),
                     ("v_proj", "attn_v")):
            W.maybe(sd, h + f"self_attn.{p}.weight", g + f"{t}.weight")
            W.maybe(sd, h + f"self_attn.{p}.bias", g + f"{t}.bias")
        W.maybe(sd, h + "self_attn.o_proj.weight", g + "attn_output.weight")
        W.maybe(sd, h + "post_attention_layernorm.weight",
                g + "ffn_norm.weight")
        W.maybe(sd, h + "post_attention_layernorm.bias", g + "ffn_norm.bias")
        W.maybe(sd, h + "mlp.gate_proj.weight", g + "ffn_gate.weight")
        W.maybe(sd, h + "mlp.up_proj.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.down_proj.weight", g + "ffn_down.weight")
    W.write()


def convert_qwen2(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                  vocab=None) -> None:
    """qwen2: llama naming, neox rope (no permute), q/k/v biases."""
    n_head = int(c.num_attention_heads)
    hd = int(c.hidden_size) // n_head
    W = ModelWriter(out_path, "qwen2", qtype)
    _common_kv(W, c)
    _rope_kv(W, c, hd)
    W.vocab(vocab)
    W.maybe(sd, "model.embed_tokens.weight", "token_embd.weight")
    W.maybe(sd, "model.norm.weight", "output_norm.weight")
    W.maybe(sd, "lm_head.weight", "output.weight")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"model.layers.{i}.", f"blk.{i}."
        W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight")
        for p, t in (("q_proj", "attn_q"), ("k_proj", "attn_k"),
                     ("v_proj", "attn_v")):
            W.maybe(sd, h + f"self_attn.{p}.weight", g + f"{t}.weight")
            W.maybe(sd, h + f"self_attn.{p}.bias", g + f"{t}.bias")
        W.maybe(sd, h + "self_attn.o_proj.weight", g + "attn_output.weight")
        W.maybe(sd, h + "post_attention_layernorm.weight",
                g + "ffn_norm.weight")
        W.maybe(sd, h + "mlp.gate_proj.weight", g + "ffn_gate.weight")
        W.maybe(sd, h + "mlp.up_proj.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.down_proj.weight", g + "ffn_down.weight")
    W.write()


def convert_starcoder2(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                       vocab=None) -> None:
    n_head = int(c.num_attention_heads)
    hd = int(c.hidden_size) // n_head
    W = ModelWriter(out_path, "starcoder2", qtype)
    _common_kv(W, c, rms=False)
    _rope_kv(W, c, hd)
    W.vocab(vocab)
    W.maybe(sd, "model.embed_tokens.weight", "token_embd.weight")
    W.maybe(sd, "model.norm.weight", "output_norm.weight")
    W.maybe(sd, "model.norm.bias", "output_norm.bias")
    W.maybe(sd, "lm_head.weight", "output.weight")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"model.layers.{i}.", f"blk.{i}."
        W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "input_layernorm.bias", g + "attn_norm.bias")
        for p, t in (("q_proj", "attn_q"), ("k_proj", "attn_k"),
                     ("v_proj", "attn_v"), ("o_proj", "attn_output")):
            W.maybe(sd, h + f"self_attn.{p}.weight", g + f"{t}.weight")
            W.maybe(sd, h + f"self_attn.{p}.bias", g + f"{t}.bias")
        W.maybe(sd, h + "post_attention_layernorm.weight",
                g + "ffn_norm.weight")
        W.maybe(sd, h + "post_attention_layernorm.bias", g + "ffn_norm.bias")
        W.maybe(sd, h + "mlp.c_fc.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.c_fc.bias", g + "ffn_up.bias")
        W.maybe(sd, h + "mlp.c_proj.weight", g + "ffn_down.weight")
        W.maybe(sd, h + "mlp.c_proj.bias", g + "ffn_down.bias")
    W.write()


def convert_gemma(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                  vocab=None) -> None:
    W = ModelWriter(out_path, "gemma", qtype)
    _common_kv(W, c)
    _rope_kv(W, c, int(c.head_dim))
    W.akv("attention.key_length", int(c.head_dim))
    W.akv("attention.value_length", int(c.head_dim))
    W.vocab(vocab)
    plus1 = lambda x: x + 1.0   # GemmaModel.write_tensors (norm weights)
    W.maybe(sd, "model.embed_tokens.weight", "token_embd.weight")
    W.maybe(sd, "model.norm.weight", "output_norm.weight", plus1)
    for i in range(int(c.num_hidden_layers)):
        h, g = f"model.layers.{i}.", f"blk.{i}."
        W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight", plus1)
        for p, t in (("q_proj", "attn_q"), ("k_proj", "attn_k"),
                     ("v_proj", "attn_v"), ("o_proj", "attn_output")):
            W.maybe(sd, h + f"self_attn.{p}.weight", g + f"{t}.weight")
        W.maybe(sd, h + "post_attention_layernorm.weight",
                g + "ffn_norm.weight", plus1)
        W.maybe(sd, h + "mlp.gate_proj.weight", g + "ffn_gate.weight")
        W.maybe(sd, h + "mlp.up_proj.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.down_proj.weight", g + "ffn_down.weight")
    W.write()


def convert_persimmon(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                      vocab=None) -> None:
    n_head = int(c.num_attention_heads)
    hd = int(c.hidden_size) // n_head
    W = ModelWriter(out_path, "persimmon", qtype)
    _common_kv(W, c, rms=False)
    # rope covers half the head dim (PersimmonModel converter)
    W.akv("rope.dimension_count", hd // 2)
    W.akv("rope.freq_base", float(getattr(c, "rope_theta", 25000.0)))
    W.vocab(vocab)
    W.maybe(sd, "model.embed_tokens.weight", "token_embd.weight")
    W.maybe(sd, "model.final_layernorm.weight", "output_norm.weight")
    W.maybe(sd, "model.final_layernorm.bias", "output_norm.bias")
    W.maybe(sd, "lm_head.weight", "output.weight")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"model.layers.{i}.", f"blk.{i}."
        W.maybe(sd, h + "input_layernorm.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "input_layernorm.bias", g + "attn_norm.bias")
        W.maybe(sd, h + "self_attn.query_key_value.weight",
                g + "attn_qkv.weight")     # kept per-head interleaved
        W.maybe(sd, h + "self_attn.query_key_value.bias", g + "attn_qkv.bias")
        W.maybe(sd, h + "self_attn.dense.weight", g + "attn_output.weight")
        W.maybe(sd, h + "self_attn.dense.bias", g + "attn_output.bias")
        W.maybe(sd, h + "self_attn.q_layernorm.weight",
                g + "attn_q_norm.weight")
        W.maybe(sd, h + "self_attn.q_layernorm.bias", g + "attn_q_norm.bias")
        W.maybe(sd, h + "self_attn.k_layernorm.weight",
                g + "attn_k_norm.weight")
        W.maybe(sd, h + "self_attn.k_layernorm.bias", g + "attn_k_norm.bias")
        W.maybe(sd, h + "post_attention_layernorm.weight",
                g + "ffn_norm.weight")
        W.maybe(sd, h + "post_attention_layernorm.bias", g + "ffn_norm.bias")
        W.maybe(sd, h + "mlp.dense_h_to_4h.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "mlp.dense_h_to_4h.bias", g + "ffn_up.bias")
        W.maybe(sd, h + "mlp.dense_4h_to_h.weight", g + "ffn_down.weight")
        W.maybe(sd, h + "mlp.dense_4h_to_h.bias", g + "ffn_down.bias")
    W.write()


def convert_bert(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                 vocab=None, pooling: str = "mean") -> None:
    W = ModelWriter(out_path, "bert", qtype)
    _common_kv(W, c, rms=False)
    W.akv("attention.causal", False)
    W.akv("pooling_type", {"none": 0, "mean": 1, "cls": 2}[pooling])
    W.vocab(vocab)
    e = "embeddings."
    W.maybe(sd, e + "word_embeddings.weight", "token_embd.weight")
    W.maybe(sd, e + "token_type_embeddings.weight", "token_types.weight")
    W.maybe(sd, e + "position_embeddings.weight", "position_embd.weight")
    W.maybe(sd, e + "LayerNorm.weight", "token_embd_norm.weight")
    W.maybe(sd, e + "LayerNorm.bias", "token_embd_norm.bias")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"encoder.layer.{i}.", f"blk.{i}."
        for p, t in (("attention.self.query", "attn_q"),
                     ("attention.self.key", "attn_k"),
                     ("attention.self.value", "attn_v"),
                     ("attention.output.dense", "attn_output")):
            W.maybe(sd, h + f"{p}.weight", g + f"{t}.weight")
            W.maybe(sd, h + f"{p}.bias", g + f"{t}.bias")
        W.maybe(sd, h + "attention.output.LayerNorm.weight",
                g + "attn_output_norm.weight")
        W.maybe(sd, h + "attention.output.LayerNorm.bias",
                g + "attn_output_norm.bias")
        W.maybe(sd, h + "intermediate.dense.weight", g + "ffn_up.weight")
        W.maybe(sd, h + "intermediate.dense.bias", g + "ffn_up.bias")
        W.maybe(sd, h + "output.dense.weight", g + "ffn_down.weight")
        W.maybe(sd, h + "output.dense.bias", g + "ffn_down.bias")
        W.maybe(sd, h + "output.LayerNorm.weight", g + "layer_output_norm.weight")
        W.maybe(sd, h + "output.LayerNorm.bias", g + "layer_output_norm.bias")
    W.write()


def convert_mamba(sd: dict, c, out_path: str, qtype=GGMLType.F32,
                  vocab=None) -> None:
    W = ModelWriter(out_path, "mamba", qtype)
    W.kv("general.name", "mamba")
    W.akv("context_length", 2**20)
    W.akv("embedding_length", int(c.hidden_size))
    W.akv("block_count", int(c.num_hidden_layers))
    W.akv("feed_forward_length", 0)
    W.akv("attention.head_count", 0)
    W.akv("attention.head_count_kv", 0)
    W.akv("attention.layer_norm_rms_epsilon",
          float(getattr(c, "layer_norm_epsilon", 1e-5)))
    W.akv("ssm.conv_kernel", int(c.conv_kernel))
    W.akv("ssm.inner_size", int(c.intermediate_size))
    W.akv("ssm.state_size", int(c.state_size))
    W.akv("ssm.time_step_rank", int(c.time_step_rank))
    W.akv("vocab_size", int(c.vocab_size))
    W.vocab(vocab)
    W.maybe(sd, "backbone.embeddings.weight", "token_embd.weight")
    W.maybe(sd, "backbone.norm_f.weight", "output_norm.weight")
    W.maybe(sd, "lm_head.weight", "output.weight")
    for i in range(int(c.num_hidden_layers)):
        h, g = f"backbone.layers.{i}.", f"blk.{i}."
        W.maybe(sd, h + "norm.weight", g + "attn_norm.weight")
        W.maybe(sd, h + "mixer.in_proj.weight", g + "ssm_in.weight")
        W.maybe(sd, h + "mixer.conv1d.weight", g + "ssm_conv1d.weight",
                lambda x: x.squeeze(1))
        W.maybe(sd, h + "mixer.conv1d.bias", g + "ssm_conv1d.bias")
        W.maybe(sd, h + "mixer.x_proj.weight", g + "ssm_x.weight")
        W.maybe(sd, h + "mixer.dt_proj.weight", g + "ssm_dt.weight")
        W.maybe(sd, h + "mixer.dt_proj.bias", g + "ssm_dt.bias")
        W.maybe(sd, h + "mixer.A_log", g + "ssm_a.weight",
                lambda x: -np.exp(x))
        W.maybe(sd, h + "mixer.D", g + "ssm_d.weight")
        W.maybe(sd, h + "mixer.out_proj.weight", g + "ssm_out.weight")
    W.write()


def vocab_from_hf(tok) -> dict:
    """Extract GGUF tokenizer metadata from a loaded HF tokenizer.

    Covers the three vocab families the reference converts
    (convert-hf-to-gguf.py _set_vocab_{sentencepiece,gpt2} and
    BertModel.set_vocab): SPM with scores, byte-level BPE with merges, and
    WordPiece re-written to the phantom-space convention.
    """
    # SPM (sentencepiece-backed, e.g. LlamaTokenizer)
    sp = getattr(tok, "sp_model", None)
    if sp is not None:
        n = sp.get_piece_size()
        tokens = [sp.id_to_piece(i) for i in range(n)]
        scores = [float(sp.get_score(i)) for i in range(n)]
        ttype = []
        for i in range(n):
            if sp.is_unknown(i):
                ttype.append(2)
            elif sp.is_control(i):
                ttype.append(3)
            elif sp.is_byte(i):
                ttype.append(6)
            elif sp.is_unused(i):
                ttype.append(5)
            else:
                ttype.append(1)
        # HF added_tokens beyond the sp_model (chat specials, resized
        # vocabs): the reference converter appends them after the SPM
        # pieces (convert-hf-to-gguf.py _set_vocab_sentencepiece)
        added = getattr(tok, "added_tokens_decoder", None) or {}
        for tid in sorted(int(k) for k in added):
            if tid < len(tokens):
                continue
            while len(tokens) < tid:       # pad any id gaps
                tokens.append(f"<unused_{len(tokens)}>")
                scores.append(-1000.0)
                ttype.append(5)
            at = added[tid]
            tokens.append(str(getattr(at, "content", at)))
            scores.append(0.0)
            special = bool(getattr(at, "special", True))
            ttype.append(3 if special else 4)   # CONTROL / USER_DEFINED
        out = dict(model="llama", tokens=tokens, scores=scores,
                   token_type=ttype)
    else:
        vocab = tok.get_vocab()
        n = max(vocab.values()) + 1
        tokens = ["" for _ in range(n)]
        for t, i in vocab.items():
            tokens[i] = t
        special_ids = set(getattr(tok, "all_special_ids", []) or [])
        is_wpm = any(t.startswith("##") for t in vocab)
        if is_wpm:
            gg = []
            for t in tokens:
                if t.startswith("##"):
                    gg.append(t[2:])
                elif t.startswith("[") and t.endswith("]"):
                    gg.append(t)
                else:
                    gg.append("▁" + t)
            ttype = [3 if i in special_ids else 1 for i in range(n)]
            out = dict(model="bert", tokens=gg, scores=[0.0] * n,
                       token_type=ttype)
        else:
            merges = []
            ranks = getattr(tok, "bpe_ranks", None)
            if ranks:
                merges = [f"{l} {r}" for (l, r), _ in
                          sorted(ranks.items(), key=lambda kv: kv[1])]
            elif hasattr(tok, "backend_tokenizer"):
                import json as _json
                data = _json.loads(tok.backend_tokenizer.to_str())
                raw = data.get("model", {}).get("merges", [])
                merges = [m if isinstance(m, str) else f"{m[0]} {m[1]}"
                          for m in raw]
            ttype = [3 if i in special_ids else 1 for i in range(n)]
            out = dict(model="gpt2", tokens=tokens, scores=[0.0] * n,
                       token_type=ttype, merges=merges)
    for name in ("bos", "eos", "unk", "pad"):
        tid = getattr(tok, f"{name}_token_id", None)
        if tid is None and name == "bos":
            tid = getattr(tok, "cls_token_id", None)
        if tid is None and name == "eos":
            tid = getattr(tok, "sep_token_id", None)
        if tid is not None:
            out[name] = int(tid)
    return out


def convert_hf_clip(sd: dict, c, out_path: str, proj_sd: dict | None = None,
                    skip_last: int = 1, use_gelu: bool = False,
                    proj_type: str = "mlp",
                    image_mean=(0.48145466, 0.4578275, 0.40821073),
                    image_std=(0.26862954, 0.26130258, 0.27577711),
                    image_grid_pinpoints=(), mm_patch_merge_type=None,
                    image_newline=None) -> None:
    """HF CLIPVisionModel (+ llava projector state_dict) -> mmproj GGUF.

    Mirrors the reference's convert-image-encoder-to-gguf.py: keys/tensor
    names from clip.cpp:73-122. skip_last=1 reproduces llava's
    vision_feature_layer=-2 (the reference drops the final ViT block at
    conversion); pass 0 to keep every layer. proj_sd maps llava HF
    multi_modal_projector.linear_1/2 -> mm.0 / mm.2.

    llava-1.6 ("anyres") towers: image_grid_pinpoints (the flat [w0, h0,
    w1, h1, ...] canvases), mm_patch_merge_type ("flat" | "spatial_unpad")
    and image_newline (the (proj_dim,) row separator, `model.image_newline`)
    are written when given, as the reference's llava surgery writes them;
    left at their defaults the file equals the JAX converter's.
    """
    w = GGUFWriter(out_path)
    w.add_kv("general.architecture", "clip")
    w.add_kv("general.name", "clip-vision")
    w.add_kv("clip.has_text_encoder", False)
    w.add_kv("clip.has_vision_encoder", True)
    w.add_kv("clip.has_llava_projector", True)
    w.add_kv("clip.use_gelu", bool(use_gelu))
    w.add_kv("clip.projector_type", proj_type)
    n_blocks = int(c.num_hidden_layers) - skip_last
    w.add_kv("clip.vision.embedding_length", int(c.hidden_size))
    w.add_kv("clip.vision.feed_forward_length", int(c.intermediate_size))
    w.add_kv("clip.vision.block_count", n_blocks)
    w.add_kv("clip.vision.attention.head_count", int(c.num_attention_heads))
    w.add_kv("clip.vision.attention.layer_norm_epsilon",
             float(c.layer_norm_eps))
    w.add_kv("clip.vision.image_size", int(c.image_size))
    w.add_kv("clip.vision.patch_size", int(c.patch_size))
    w.add_kv("clip.vision.image_mean", [float(x) for x in image_mean])
    w.add_kv("clip.vision.image_std", [float(x) for x in image_std])
    if image_grid_pinpoints:
        w.add_kv("clip.vision.image_grid_pinpoints",
                 [int(x) for x in image_grid_pinpoints])
    if mm_patch_merge_type is not None:
        w.add_kv("clip.vision.mm_patch_merge_type", str(mm_patch_merge_type))

    pre = "vision_model."
    f32 = lambda k: np.ascontiguousarray(sd[k], np.float32)  # noqa: E731
    w.add_tensor("v.patch_embd.weight",
                 f32(pre + "embeddings.patch_embedding.weight"))
    w.add_tensor("v.class_embd", f32(pre + "embeddings.class_embedding"))
    w.add_tensor("v.position_embd.weight",
                 f32(pre + "embeddings.position_embedding.weight"))
    # HF attribute is spelled "pre_layrnorm"
    w.add_tensor("v.pre_ln.weight", f32(pre + "pre_layrnorm.weight"))
    w.add_tensor("v.pre_ln.bias", f32(pre + "pre_layrnorm.bias"))
    names = (("attn_q", "self_attn.q_proj"), ("attn_k", "self_attn.k_proj"),
             ("attn_v", "self_attn.v_proj"), ("attn_out", "self_attn.out_proj"),
             ("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
             ("ffn_up", "mlp.fc1"), ("ffn_down", "mlp.fc2"))
    for i in range(n_blocks):
        for gg, hf in names:
            for part in ("weight", "bias"):
                w.add_tensor(f"v.blk.{i}.{gg}.{part}",
                             f32(f"{pre}encoder.layers.{i}.{hf}.{part}"))
    if proj_sd:
        pj = {k: np.ascontiguousarray(v, np.float32)
              for k, v in proj_sd.items()}
        lin = {"linear_1": 0, "linear_2": 2}
        for hf, idx in lin.items():
            for part in ("weight", "bias"):
                key = next((k for k in pj if k.endswith(f"{hf}.{part}")), None)
                if key is not None:
                    w.add_tensor(f"mm.{idx}.{part}", pj[key])
    if image_newline is not None:
        w.add_tensor("model.image_newline",
                     np.ascontiguousarray(image_newline, np.float32))
    w.write()


# dispatch on HF config.model_type
CONVERTERS = {
    "llama": convert_llama_family,
    "mixtral": convert_llama_family,
    "gpt2": convert_gpt2,
    "gptj": convert_gptj,
    "gpt_neox": convert_gptneox,
    "falcon": convert_falcon,
    "gpt_bigcode": convert_gptbigcode,
    "bloom": convert_bloom,
    "mpt": convert_mpt,
    "phi": convert_phi2,
    "stablelm": convert_stablelm,
    "qwen2": convert_qwen2,
    "starcoder2": convert_starcoder2,
    "gemma": convert_gemma,
    "persimmon": convert_persimmon,
    "bert": convert_bert,
    "mamba": convert_mamba,
}


def _numpy(v) -> np.ndarray:
    """A state-dict value (a numpy array or a torch tensor) as f32 numpy."""
    if hasattr(v, "detach"):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_hf(model, out_path: str, qtype: GGMLType = GGMLType.F32,
               vocab: dict | None = None, config=None, **kw) -> None:
    """Convert a loaded HF model (any supported arch) to GGUF; or, with
    `config` (its model_type naming the converter), a state dict given as
    `model`."""
    if config is None:
        sd = {k: _numpy(v) for k, v in model.state_dict().items()}
        config = model.config
    else:
        sd = model
    mt = config.model_type
    if mt not in CONVERTERS:
        raise NotImplementedError(f"HF model_type {mt!r}")
    CONVERTERS[mt](sd, config, out_path, qtype=qtype, vocab=vocab, **kw)
