"""Differentiable causal-LM forward + initialization for training
(counterpart of tpulamm.train.model).

Training-side counterpart of the reference's CPU training stack: ggml
autograd (ggml_build_backward_expand, ggml.h:1956), gradient checkpointing
(ggml.h:1992) and examples/train-text-from-scratch/ (llama-arch init +
AdamW loop). The forward is a function over a dict of dense f32 tensors in
the SAME layout the inference loader produces, so a trained checkpoint
saves straight to GGUF and runs in the decode engine; torch autograd
replaces ggml's reverse graph, torch.utils.checkpoint (a layer at a time)
ggml_build_backward_gradient_checkpointing. Its products are plain torch
ops, as the JAX forward's are plain XLA ops (no kernel of the inference
path runs here).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.ops.layers import rms_norm, silu
from tpulamm_torch.ops.rope import apply_rope


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> dict:
    """Random-init llama-arch params (train-text-from-scratch
    init_model/randomize_model semantics: normal(0, 1/sqrt(dim))). The
    draws come from np.random.default_rng(seed) in the JAX package's order,
    so the tensors equal its arrays bit for bit. device: default "cuda"
    (raises without CUDA)."""
    from tpulamm_torch.runtime.engine import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def w(n, k):
        return torch.from_numpy(
            rng.normal(0, 1.0 / np.sqrt(k), (n, k)).astype(np.float32)).to(
                device=dev, dtype=dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    kvd = cfg.n_kv_heads * cfg.head_dim
    params = {"tok_emb": w(cfg.vocab_size, cfg.dim),
              "out_norm": ones(cfg.dim),
              "output": w(cfg.vocab_size, cfg.dim)}
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": ones(cfg.dim),
            "ffn_norm": ones(cfg.dim),
            "wq": w(cfg.n_heads * cfg.head_dim, cfg.dim),
            "wk": w(kvd, cfg.dim),
            "wv": w(kvd, cfg.dim),
            "wo": w(cfg.dim, cfg.n_heads * cfg.head_dim),
            "w_gate": w(cfg.ffn_dim, cfg.dim),
            "w_up": w(cfg.ffn_dim, cfg.dim),
            "w_down": w(cfg.dim, cfg.ffn_dim),
        })
    params["layers"] = layers
    return params


def _layer_fwd(layer: dict, cfg: ModelConfig, h: torch.Tensor,
               positions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    B, T, _ = h.shape
    hd = cfg.head_dim
    hn = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
    q = (hn @ layer["wq"].T).reshape(B, T, cfg.n_heads, hd)
    k = (hn @ layer["wk"].T).reshape(B, T, cfg.n_kv_heads, hd)
    v = (hn @ layer["wv"].T).reshape(B, T, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope)
    k = apply_rope(k, positions, cfg.rope)
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, T, cfg.n_kv_heads, group, hd)
    # sqrt(hd) rounded to the activations' dtype, as the JAX forward takes it
    scale = float(np.sqrt(np.asarray(hd, np.float32)))
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k) / scale
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(h.dtype)
    attn = torch.einsum("bhgts,bshd->bthgd", probs, v)
    attn = attn.reshape(B, T, cfg.n_heads * hd)
    h = h + attn @ layer["wo"].T
    hn = rms_norm(h, layer["ffn_norm"], cfg.norm_eps)
    gate = hn @ layer["w_gate"].T
    up = hn @ layer["w_up"].T
    return h + (silu(gate) * up) @ layer["w_down"].T


def forward_train(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  remat: bool = False) -> torch.Tensor:
    """tokens (B, T) -> logits (B, T, vocab) f32; full causal attention.

    remat=True recomputes each layer in the backward pass
    (torch.utils.checkpoint, the ggml grad-checkpointing analogue)."""
    B, T = tokens.shape
    dev = params["tok_emb"].device
    tokens = tokens.to(device=dev, dtype=torch.long)
    h = params["tok_emb"][tokens]
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    mask = mask[None, None, None]
    for layer in params["layers"]:
        if remat:
            h = checkpoint(_layer_fwd, layer, cfg, h, positions, mask,
                           use_reentrant=False)
        else:
            h = _layer_fwd(layer, cfg, h, positions, mask)
    h = rms_norm(h, params["out_norm"], cfg.norm_eps)
    return (h @ params["output"].T).to(torch.float32)


def token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per-position next-token negative log-likelihood (B, T-1)."""
    targets = tokens[:, 1:].to(device=logits.device, dtype=torch.long)
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.gather(lp, -1, targets[..., None])[..., 0]


def causal_lm_loss(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy (ggml_cross_entropy_loss equivalent)."""
    logits = forward_train(params, cfg, tokens, remat=remat)
    return token_nll(logits, tokens).mean()


def save_params_gguf(params: dict, cfg: ModelConfig, path: str,
                     vocab: dict | None = None) -> None:
    """Write trained params as a llama-arch GGUF the engine can load (the
    JAX package's file, byte for byte)."""
    from tpulamm_torch.gguf.writer import GGUFWriter
    w = GGUFWriter(path)
    w.add_kv("general.architecture", "llama")
    w.add_kv("general.name", "tpulamm-trained")
    w.add_kv("llama.context_length", cfg.n_ctx_train)
    w.add_kv("llama.embedding_length", cfg.dim)
    w.add_kv("llama.block_count", cfg.n_layers)
    w.add_kv("llama.feed_forward_length", cfg.ffn_dim)
    w.add_kv("llama.rope.dimension_count", cfg.rope.n_rot)
    w.add_kv("llama.attention.head_count", cfg.n_heads)
    w.add_kv("llama.attention.head_count_kv", cfg.n_kv_heads)
    w.add_kv("llama.attention.layer_norm_rms_epsilon", cfg.norm_eps)
    w.add_kv("llama.rope.freq_base", cfg.rope.freq_base)
    w.add_kv("llama.vocab_size", cfg.vocab_size)
    if vocab:
        w.add_kv("tokenizer.ggml.model", vocab.get("model", "llama"))
        w.add_kv("tokenizer.ggml.tokens", list(vocab["tokens"]))
        w.add_kv("tokenizer.ggml.scores",
                 np.asarray(vocab.get("scores",
                                      [0.0] * len(vocab["tokens"])),
                            np.float32))
        w.add_kv("tokenizer.ggml.token_type",
                 np.asarray(vocab.get("token_type",
                                      [1] * len(vocab["tokens"])), np.int32))
    names = {"tok_emb": "token_embd.weight", "out_norm": "output_norm.weight",
             "output": "output.weight"}
    for key, name in names.items():
        w.add_tensor(name, to_numpy(params[key]))
    lnames = {"attn_norm": "attn_norm", "wq": "attn_q", "wk": "attn_k",
              "wv": "attn_v", "wo": "attn_output", "ffn_norm": "ffn_norm",
              "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down"}
    for i, layer in enumerate(params["layers"]):
        for key, name in lnames.items():
            w.add_tensor(f"blk.{i}.{name}.weight", to_numpy(layer[key]))
    w.write()


def to_numpy(t) -> np.ndarray:
    """A tensor (any device) or array -> an f32 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)
