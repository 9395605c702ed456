"""LLaMA-family forward pass -- thin alias over models.transformer
(counterpart of tpulamm.models.llama): RMSNorm -> fused QKV -> NORM RoPE
-> KV store -> masked softmax attention -> output projection -> residual;
RMSNorm -> SwiGLU FFN (or the MoE branch, :5797-5858) -> residual;
final RMSNorm -> lm head (build_llama, llama.cpp:5708-5882)."""

from __future__ import annotations

from tpulamm_torch.models.transformer import (Params, attention, embed, ffn,  # noqa: F401
                                              forward, moe_ffn)

__all__ = ["Params", "attention", "embed", "ffn", "forward", "moe_ffn"]
