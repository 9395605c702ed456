"""Rotary position embeddings, ggml-compatible (counterpart of
tpulamm.ops.rope).

The two rotation layouts of ggml_rope_custom: NORM rotates consecutive
pairs (x[2i], x[2i+1]) (the LLaMA family), NEOX rotates pairs split by
half (x[i], x[i+n_rot/2]). Linear frequency scaling (freq_scale) and YaRN
(ext_factor/attn_factor/beta_fast/beta_slow) follow rope_yarn() in ggml.c.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RopeParams:
    n_rot: int
    kind: str = "norm"            # "norm" | "neox" | "none"
    freq_base: float = 10000.0
    freq_scale: float = 1.0       # linear scaling (1/factor)
    ext_factor: float = 0.0       # YaRN extrapolation mix factor
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    n_orig_ctx: int = 0           # original training context for YaRN


def _yarn_corr_dim(n_dims: int, n_orig_ctx: int, n_rot: float,
                   base: float) -> float:
    # inverse of theta wavelength reaching n_rot rotations at n_orig_ctx
    return (n_dims * math.log(n_orig_ctx / (n_rot * 2 * math.pi))
            / (2 * math.log(base)))


def _yarn_ramp(lo: float, hi: float, i: torch.Tensor) -> torch.Tensor:
    y = (i - lo) / max(0.001, hi - lo)
    return 1.0 - torch.clamp(y, 0.0, 1.0)


def rope_angles(params: RopeParams, pos: torch.Tensor) -> tuple:
    """pos (...,) -> (cos, sin) of shape (..., n_rot/2), mscale applied."""
    half = params.n_rot // 2
    dim_i = torch.arange(half, dtype=torch.float32, device=pos.device)
    # a device-side fill, not a host tensor copied over (that would sync)
    base = torch.full((), params.freq_base, dtype=torch.float32,
                      device=pos.device)
    inv_freq = torch.pow(base, -2.0 * dim_i / params.n_rot)
    theta_extrap = pos[..., None].to(torch.float32) * inv_freq
    mscale = params.attn_factor
    if params.ext_factor != 0.0 and params.n_orig_ctx > 0:
        lo = math.floor(_yarn_corr_dim(params.n_rot, params.n_orig_ctx,
                                       params.beta_fast, params.freq_base))
        hi = math.ceil(_yarn_corr_dim(params.n_rot, params.n_orig_ctx,
                                      params.beta_slow, params.freq_base))
        lo, hi = max(lo, 0), min(hi, params.n_rot - 1)
        # rope_yarn_ramp compares the pair index against the corr dims
        # directly (ggml.c:12737-12740)
        ramp = _yarn_ramp(lo, hi, dim_i) * params.ext_factor
        theta_interp = params.freq_scale * theta_extrap
        theta = theta_interp * (1 - ramp) + theta_extrap * ramp
        mscale = mscale * (1.0 + 0.1 * math.log(1.0 / params.freq_scale))
    else:
        theta = params.freq_scale * theta_extrap
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope(x: torch.Tensor, pos: torch.Tensor, params: RopeParams,
               angles: tuple | None = None) -> torch.Tensor:
    """x: (..., T, H, D); pos: (..., T) int. Rotates the first n_rot dims.
    angles: rope_angles(params, pos) when the caller already has them."""
    if params.kind == "none":
        return x
    d = x.shape[-1]
    n_rot = params.n_rot
    cos, sin = angles if angles is not None else rope_angles(params, pos)
    cos = cos[..., None, :]                              # broadcast over heads
    sin = sin[..., None, :]
    xr = x[..., :n_rot]
    dtype = x.dtype
    if params.kind == "norm":
        xe = xr[..., 0::2].to(torch.float32)
        xo = xr[..., 1::2].to(torch.float32)
        re = xe * cos - xo * sin
        ro = xe * sin + xo * cos
        rot = torch.stack([re, ro], dim=-1).reshape(xr.shape)
    elif params.kind == "neox":
        h = n_rot // 2
        x1 = xr[..., :h].to(torch.float32)
        x2 = xr[..., h:].to(torch.float32)
        rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    else:
        raise ValueError(params.kind)
    rot = rot.to(dtype)
    if n_rot == d:
        return rot
    return torch.cat([rot, x[..., n_rot:]], dim=-1)
