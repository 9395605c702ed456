"""Normalization and activation primitives (counterpart of
tpulamm.ops.layers, with `act` and `alibi_slopes` of
tpulamm.models.transformer); plain torch ops in f32."""

from __future__ import annotations

import math

import numpy as np
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """ggml_rms_norm + mul (llm_build_norm, llama.cpp:5300-5330)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN activation of an architecture (transformer.py:90-101):
    silu, tanh-approximated gelu (ggml_gelu), relu, relu² (persimmon)."""
    if kind == "silu":
        return silu(x)
    if kind == "gelu":
        return gelu(x)
    if kind == "relu":
        return torch.clamp(x, min=0)
    if kind == "relu_sqr":
        r = torch.clamp(x, min=0)
        return r * r
    raise ValueError(kind)


_SLOPES: dict = {}


def alibi_slopes(n_heads: int, max_bias: float,
                 device="cpu") -> torch.Tensor:
    """Per-head ALiBi slopes (n_heads,) f32, exactly ggml's
    (ggml_compute_forward_soft_max_f32, ggml.c:12283-12298). Made once per
    (n_heads, max_bias, device) and kept: a host-to-device copy inside a
    captured decode step is refused, so the step reads the kept tensor."""
    key = (n_heads, float(max_bias), str(torch.device(device)))
    out = _SLOPES.get(key)
    if out is None:
        # m0, m1 rounded to f32 as ggml holds them; the powers taken in
        # f64 and rounded once, which is the correctly rounded powf
        n_head_log2 = 1 << int(math.floor(math.log2(n_heads)))
        m0 = float(np.float32(2.0 ** (-max_bias / n_head_log2)))
        m1 = float(np.float32(2.0 ** (-(max_bias / 2.0) / n_head_log2)))
        h = np.arange(n_heads, dtype=np.float64)
        s = np.where(h < n_head_log2, m0 ** (h + 1.0),
                     m1 ** (2.0 * (h - n_head_log2) + 1.0)).astype(np.float32)
        out = _SLOPES[key] = torch.from_numpy(s).to(device)
    return out


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ggml_soft_max_ext equivalent: masked, f32, numerically stable."""
    s = torch.where(mask, scores.to(torch.float32), float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)
    # guard fully-masked rows (empty cache): exp(-inf - -inf) -> nan
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
