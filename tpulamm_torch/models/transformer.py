"""Transformer forward, llama topology (counterpart of
tpulamm.models.transformer).

Pre-norm blocks: norm -> fused QKV projection -> RoPE -> KV store ->
masked softmax attention -> output projection -> residual; norm -> gated
FFN (silu(gate) * up -> down) -> residual; final norm -> lm head. Every
projection of a quantized weight goes through qmatmul (ops.qmm's kernels
on CUDA). The other structural axes of the JAX forward (post-norm,
parallel residual, ALiBi, qk-norm, MoE, learned positions, ...) are later
slices; a config that needs one raises.

Attention: the JAX forward picks its flash kernels on the TPU by the
predicates at transformer.py:169-187 and :249-259. The same predicates
decide here (`flash_choice`) with "on CUDA" in place of "on TPU", on the
ubatch length the JAX engine would pad to (its bucket); where they pick a
kernel, ops.flash_attention runs it at the exact length, masking by qlen.
Elsewhere the einsum path runs, with the q8_0 scale folds in the JAX order.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.ops.ffn_fused import ffn_fused, ffn_fused_eligible
from tpulamm_torch.ops.flash_attention import flash_attention, flash_decode
from tpulamm_torch.ops.layers import layer_norm, masked_softmax, rms_norm, silu
from tpulamm_torch.ops.qmatmul import dense_matmul, qmatmul
from tpulamm_torch.ops.qtensor import QTensor, gather_dequant_rows
from tpulamm_torch.ops.rope import apply_rope, rope_angles
from tpulamm_torch.runtime.kvcache import KVCache, write_kv

Params = dict[str, Any]


def unsupported_features(cfg: ModelConfig) -> list[str]:
    """Structural features of cfg this forward does not run yet."""
    flags = {
        "post_norm": cfg.post_norm, "parallel_residual": cfg.parallel_residual,
        "pos_emb": cfg.pos_emb, "tok_norm": cfg.tok_norm,
        "qk_norm": cfg.qk_norm, "alibi": cfg.max_alibi_bias > 0.0,
        "clamp_kqv": cfg.clamp_kqv > 0.0, "moe": cfg.n_expert > 0,
        "non-causal": not cfg.causal, f"ffn_act={cfg.ffn_act}":
            cfg.ffn_act != "silu", f"arch={cfg.arch}": cfg.arch == "mamba",
    }
    return [name for name, on in flags.items() if on]


def _proj(x: torch.Tensor, w, cfg: ModelConfig, bias=None) -> torch.Tensor:
    if isinstance(w, QTensor):
        y = qmatmul(x, w, compute_dtype=cfg.cdtype, inkq=cfg.int8_inkq)
    else:
        y = dense_matmul(x, w)
    if bias is not None:
        y = (y + bias.to(torch.float32)).to(y.dtype)
    return y


def _norm(x: torch.Tensor, p: Params, name: str,
          cfg: ModelConfig) -> torch.Tensor:
    """llm_build_norm (llama.cpp:5178): RMS or LN with optional bias."""
    if cfg.norm_type == "rms":
        return rms_norm(x, p[name], cfg.norm_eps)
    return layer_norm(x, p[name], p.get(name + "_b"), cfg.norm_eps)


def embed(params: Params, cfg: ModelConfig,
          tokens: torch.Tensor) -> torch.Tensor:
    emb = params["tok_emb"]
    if isinstance(emb, QTensor):
        return gather_dequant_rows(emb, tokens.to(torch.long), dtype=cfg.cdtype)
    return emb[tokens.to(torch.long)].to(cfg.cdtype)


def flash_choice(cfg: ModelConfig, T: int, span: int, on_cuda: bool
                 ) -> str | None:
    """Which flash kernel the JAX dispatch would run for a (T, span)
    attention call on the accelerator, or None for the einsum path
    (transformer.py:169-187 decode predicate, :249-259 general one)."""
    group = cfg.n_heads // cfg.n_kv_heads
    hd_ok = cfg.max_alibi_bias == 0.0 and cfg.head_dim in (64, 128, 256)
    small_q = T * group < 64
    fd_auto = on_cuda and small_q and (
        span >= 8192 or (span >= 6144 and T * group >= 8))
    force = cfg.flash_attn
    fd_on = small_q and hd_ok and (force if force is not None else fd_auto)
    auto = fd_on or (on_cuda and ((T >= 64 and span >= 1024)
                                  or (span >= 6144 and T * group >= 8)))
    if not (hd_ok and (force if force is not None else auto)):
        return None
    return "flash_decode" if (fd_on or small_q) else "flash_attention"


def attention(layer: Params, cfg: ModelConfig, h: torch.Tensor,
              positions: torch.Tensor, cache: KVCache, layer_idx: int,
              slots: int | torch.Tensor | None, cells: torch.Tensor,
              kv_span: int | None = None, angles: tuple | None = None,
              t_bucket: int | None = None) -> tuple:
    """angles: rope_angles(cfg.rope, positions), shared by every layer;
    t_bucket: the padded ubatch length the kernel choice is made on
    (None = T)."""
    B, T, _ = h.shape
    hd = cfg.head_dim
    if layer.get("wqkv_fused") is not None:
        qkv = _proj(h, layer["wqkv_fused"], cfg, layer.get("bqkv_fused"))
        nq = cfg.n_heads * hd
        nkv = cfg.n_kv_heads * hd
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        q = _proj(h, layer["wq"], cfg, layer.get("bq"))
        k = _proj(h, layer["wk"], cfg, layer.get("bk"))
        v = _proj(h, layer["wv"], cfg, layer.get("bv"))
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope, angles)
    k = apply_rope(k, positions, cfg.rope, angles)

    S_full = cache.k[layer_idx].shape[2]
    span = kv_span if kv_span is not None and kv_span < S_full else S_full
    kernel = flash_choice(cfg, T if t_bucket is None else t_bucket, span,
                          h.device.type == "cuda")

    # always an in-place write, whichever path reads the cache below
    write_kv(cache, layer_idx, k, v, slots, cells, positions)

    def rows(arr):
        """This batch's cache rows: slots=None covers the FIRST B rows in
        order and an int slot its one row (views); a tensor of slot ids
        gathers (a copy)."""
        if slots is None:
            return arr if arr.shape[0] == B else arr[:B]
        if isinstance(slots, int):
            return arr[slots:slots + 1]
        return arr[slots.to(torch.long)]

    # span views of the cache: never copied for the kernels (they take
    # strides); the einsum reads them as f32
    kc = rows(cache.k[layer_idx])[:, :, :span]
    vc = rows(cache.v[layer_idx])[:, :, :span]
    kpos = rows(cache.pos)[:, :span]
    ksc = (rows(cache.ks[layer_idx])[:, :, :span] if cache.ks is not None
           else None)
    vsc = (rows(cache.vs[layer_idx])[:, :, :span] if cache.vs is not None
           else None)
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, T, cfg.n_kv_heads, group, hd)

    if kernel is not None:
        qf = qg.permute(0, 2, 1, 3, 4).reshape(B, cfg.n_kv_heads, T * group,
                                               hd)
        # device tensors: no host round trip per layer
        qbase = positions[:, 0].to(torch.int32)
        qlen = (positions >= 0).sum(1).to(torch.int32)
        fn = flash_decode if kernel == "flash_decode" else flash_attention
        o = fn(qf, kc, vc, kpos, qbase, qlen, ksc, vsc,
               scale=float(1.0 / math.sqrt(hd)), g=group, causal=cfg.causal)
        o = o.reshape(B, cfg.n_kv_heads, T, group, hd).permute(0, 2, 1, 3, 4)
        o = o.reshape(B, T, cfg.n_heads * hd).to(cfg.cdtype)
        return _proj(o, layer["wo"], cfg, layer.get("bo")), cache

    # scores (B, Hkv, G, T, S) in f32, as the JAX path computes off the TPU
    torch.backends.cuda.matmul.allow_tf32 = False
    scores = torch.einsum("bthgd,bhsd->bhgts", qg.to(torch.float32),
                          kc.to(torch.float32))
    if ksc is not None:
        # q8_0 K: (q . k_i8) * ks == q . k_dequant, folded before the scale
        scores = scores * ksc[:, :, None, None, :]
    # 1/sqrt(hd) rounded to f32 as JAX computes it; a Python scalar holding
    # that f32 value multiplies on the device without a host copy
    scores = scores * float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    # KQ_mask (llama_set_inputs, llama.cpp:8523): key cell live; causal
    # archs also require key pos <= query pos
    live = kpos[:, None, :] >= 0
    mask = live & (kpos[:, None, :] <= positions[:, :, None])
    probs = masked_softmax(scores, mask[:, None, None, :, :])
    if vsc is not None:
        # q8_0 V: the row scale folds into probs (s is the contracted axis)
        probs = probs * vsc[:, :, None, None, :]
    out = torch.einsum("bhgts,bhsd->bthgd", probs, vc.to(torch.float32))
    out = out.reshape(B, T, cfg.n_heads * hd).to(cfg.cdtype)
    return _proj(out, layer["wo"], cfg, layer.get("bo")), cache


def ffn(layer: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """llm_build_ffn (llama.cpp:5203), gated silu. With cfg.fused_ffn, a
    decode-size batch on CUDA runs the one-launch FFN kernel, as the JAX
    forward does on the TPU with TPULAMM_FUSED_FFN (transformer.py:377-394);
    on the CPU the flag changes nothing."""
    if layer.get("wgateup_fused") is not None:
        B, T, dim = h.shape
        if (cfg.fused_ffn and h.device.type == "cuda"
                and isinstance(layer["w_down"], QTensor)
                and ffn_fused_eligible(layer["wgateup_fused"],
                                       layer["w_down"], B * T)
                and cfg.ffn_act in ("silu", "gelu")):
            y = ffn_fused(h.reshape(B * T, dim), layer["wgateup_fused"],
                          layer["w_down"], act=cfg.ffn_act)
            if layer.get("b_down") is not None:
                y = y + layer["b_down"].to(torch.float32)
            return y.reshape(B, T, dim)
        gu = _proj(h, layer["wgateup_fused"], cfg)
        half = gu.shape[-1] // 2
        gate, up = gu[..., :half], gu[..., half:]
    else:
        up = _proj(h, layer["w_up"], cfg, layer.get("b_up"))
        gate = _proj(h, layer["w_gate"], cfg, layer.get("b_gate"))
    mid = silu(gate.to(torch.float32)) * up.to(torch.float32)
    return _proj(mid.to(cfg.cdtype), layer["w_down"], cfg, layer.get("b_down"))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            slots: int | torch.Tensor | None, cells: torch.Tensor,
            kv_span: int | None = None, t_bucket: int | None = None
            ) -> tuple[torch.Tensor, KVCache]:
    """tokens/positions/cells: (B, T); slots: (B,) slot ids, the slot of a
    one-row batch as an int, or None for the first B slots; t_bucket: the
    length the JAX engine pads this ubatch to, on which the attention
    kernel is chosen (None = T) -> (logits (B, T, vocab) f32, cache updated
    in place)."""
    missing = unsupported_features(cfg)
    if missing:
        raise NotImplementedError(f"forward features not ported yet: "
                                  f"{missing} (ROADMAP queue 1)")
    h = embed(params, cfg, tokens)
    angles = (rope_angles(cfg.rope, positions) if cfg.rope.kind != "none"
              else None)
    if cfg.emb_scale != 1.0:
        h = (h.to(torch.float32) * cfg.emb_scale).to(cfg.cdtype)
    for il, layer in enumerate(params["layers"]):
        hn = _norm(h, layer, "attn_norm", cfg)
        attn_out, cache = attention(layer, cfg, hn, positions, cache, il,
                                    slots, cells, kv_span, angles, t_bucket)
        if cfg.res_scale != 1.0:
            attn_out = attn_out * cfg.res_scale
        h = (h + attn_out).to(cfg.cdtype)
        hn = _norm(h, layer, "ffn_norm", cfg)
        ffn_out = ffn(layer, cfg, hn)
        if cfg.res_scale != 1.0:
            ffn_out = ffn_out * cfg.res_scale
        h = (h + ffn_out).to(cfg.cdtype)
    if params.get("out_norm") is not None:
        h = _norm(h, params, "out_norm", cfg)
    if cfg.logit_scale != 1.0:
        h = (h.to(torch.float32) * cfg.logit_scale).to(cfg.cdtype)
    logits = _proj(h, params["output"], cfg, params.get("output_b"))
    if logits.shape[-1] != cfg.vocab_size:
        # the lm head was tile-padded; padded columns are exact zeros
        logits = logits[..., : cfg.vocab_size]
    return logits.to(torch.float32), cache
