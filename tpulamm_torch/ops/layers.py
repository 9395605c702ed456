"""Normalization and activation primitives (counterpart of
tpulamm.ops.layers); plain torch ops in f32."""

from __future__ import annotations

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


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ggml_soft_max_ext equivalent: masked, f32, numerically stable."""
    s = torch.where(mask, scores.to(torch.float32), float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)
    # guard fully-masked rows (empty cache): exp(-inf - -inf) -> nan
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
