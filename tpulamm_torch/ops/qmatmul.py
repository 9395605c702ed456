"""Quantized matmul dispatch (counterpart of tpulamm.ops.qmatmul).

qmatmul(x, qt) computes x @ dequant(W).T for an mm-layout QTensor W of
shape (N, K): (..., K) -> (..., N) f32. On a CUDA tensor it goes through
ops.qmm.qmm, the hand-written kernels; on a CPU tensor it takes the plain
dequantize-then-dot path, as the JAX package does off the TPU
(qmatmul.py:46-49: dequant to the compute dtype, dot with f32 out).
"""

from __future__ import annotations

import torch

from tpulamm_torch.ops.qmm import qmm
from tpulamm_torch.ops.qtensor import QTensor, dequant_mm


def qmatmul(x: torch.Tensor, qt: QTensor, *,
            compute_dtype=torch.bfloat16, inkq: bool = False) -> torch.Tensor:
    """x: (..., K) activations; qt: (N, K) mm-layout QTensor -> (..., N) f32.
    inkq: on CUDA the int8 path quantizes inside its launch."""
    assert qt.layout == "mm", "qmatmul needs an mm-layout QTensor"
    n, k = qt.mm_dims
    lead = x.shape[:-1]
    xm = x.reshape(-1, k)
    if x.device.type == "cuda":
        out = qmm(xm, qt, compute_dtype, inkq)
    else:
        # torch has no bf16 x bf16 -> f32 dot: round the operands to the
        # compute dtype, then multiply in f32 (what jnp.dot with
        # preferred_element_type=f32 computes)
        w = dequant_mm(qt, dtype=compute_dtype).to(torch.float32)   # (K, N)
        out = xm.to(compute_dtype).to(torch.float32) @ w
    return out.reshape(*lead, n)


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (N, K) -> (..., N) f32 for unquantized weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return x.to(w.dtype).to(torch.float32) @ w.to(torch.float32).T
