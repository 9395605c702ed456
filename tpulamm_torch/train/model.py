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
path runs here). Under a mesh the same forward runs over a tp group's
rank list (train.train's mesh= path).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.ops.layers import rms_norm, silu
from tpulamm_torch.ops.rope import apply_rope
from tpulamm_torch.parallel.distributed import (fan_out, gather_ranks,
                                                reduce_ranks)


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


def _attention(layer: dict, cfg: ModelConfig, hn: torch.Tensor,
               positions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Causal attention of the normed activations over cfg's heads (a tp
    rank's own heads under a per-rank cfg) -> (B, T, n_heads * head_dim),
    before the output projection."""
    B, T, _ = hn.shape
    hd = cfg.head_dim
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
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(hn.dtype)
    attn = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return attn.reshape(B, T, cfg.n_heads * hd)


def _ffn(layer: dict, hn: torch.Tensor) -> torch.Tensor:
    gate = hn @ layer["w_gate"].T
    up = hn @ layer["w_up"].T
    return (silu(gate) * up) @ layer["w_down"].T


def _layer_fwd(layers: list, cfg: ModelConfig, h: torch.Tensor,
               positions: torch.Tensor, mask: torch.Tensor,
               comm=None) -> torch.Tensor:
    """One layer over the tp ranks of a group (`layers`, one dict each in
    rank order; one dict when the model is not sharded): each rank's
    q / k / v heads and its partial wo product, summed in rank order ("g");
    each rank's w_gate / w_up rows and its partial w_down product, summed,
    where the FFN is sharded (row_ffn "psum"), else the replicated FFN
    once. The normed input of a sharded product goes through "f". With one
    rank both are the identity."""
    n = len(layers)
    hn = rms_norm(h, layers[0]["attn_norm"], cfg.norm_eps)
    h = h + reduce_ranks(
        [_attention(lyr, cfg, x, positions, mask) @ lyr["wo"].T
         for lyr, x in zip(layers, fan_out(hn, n, comm))], comm)
    hn = rms_norm(h, layers[0]["ffn_norm"], cfg.norm_eps)
    if cfg.row_ffn != "psum":
        return h + _ffn(layers[0], hn)
    return h + reduce_ranks([_ffn(lyr, x) for lyr, x in
                             zip(layers, fan_out(hn, n, comm))], comm)


def forward_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                  remat: bool = False, comm=None) -> torch.Tensor:
    """tokens (B, T) -> logits (B, T, vocab) f32; full causal attention.

    params: a dict, or under a mesh the list of one dp group's local tp
    ranks' trees (train.shards.TrainShards), cfg then the per-rank config
    (parallel.mesh.step_config) and comm the collectives of a group that
    spans processes; the vocab-sharded head's parts are gathered in rank
    order. remat=True recomputes each layer in the backward pass
    (torch.utils.checkpoint, the ggml grad-checkpointing analogue)."""
    ranks = params if isinstance(params, list) else [params]
    B, T = tokens.shape
    dev = ranks[0]["tok_emb"].device
    tokens = tokens.to(device=dev, dtype=torch.long)
    h = ranks[0]["tok_emb"][tokens]
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    mask = mask[None, None, None]
    for i in range(len(ranks[0]["layers"])):
        layers = [r["layers"][i] for r in ranks]
        if remat:
            h = checkpoint(_layer_fwd, layers, cfg, h, positions, mask, comm,
                           use_reentrant=False)
        else:
            h = _layer_fwd(layers, cfg, h, positions, mask, comm)
    h = rms_norm(h, ranks[0]["out_norm"], cfg.norm_eps)
    if cfg.head_sharded:
        parts = [x @ r["output"].T
                 for r, x in zip(ranks, fan_out(h, len(ranks), comm))]
        return torch.cat(gather_ranks(parts, comm), dim=-1).to(torch.float32)
    return (h @ ranks[0]["output"].T).to(torch.float32)


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
