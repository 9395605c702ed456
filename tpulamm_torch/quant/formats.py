"""Numpy decode of the dense GGUF tensor types (F32, F16, BF16).

The part of tpulamm.quant.formats the GGUF reader needs. Block-quant
tensors decode through quant.repack (dequantize_rows); the port has no
quantizers.
"""

from __future__ import annotations

import numpy as np

from tpulamm_torch.gguf.constants import GGMLType


def dequantize_f32(raw: np.ndarray, k: int) -> np.ndarray:
    return (np.ascontiguousarray(raw).view("<f4")
            .astype(np.float32).reshape(*raw.shape[:-1], k))


def dequantize_f16(raw: np.ndarray, k: int) -> np.ndarray:
    return (np.ascontiguousarray(raw).view("<f2")
            .astype(np.float32).reshape(*raw.shape[:-1], k))


def dequantize_bf16(raw: np.ndarray, k: int) -> np.ndarray:
    u = (np.ascontiguousarray(raw).view("<u2").astype(np.uint32) << 16)
    return u.view(np.float32).reshape(*raw.shape[:-1], k)


DENSE_DEQUANTIZERS = {
    GGMLType.F32: dequantize_f32,
    GGMLType.F16: dequantize_f16,
    GGMLType.BF16: dequantize_bf16,
}


def dequantize(raw: np.ndarray, qtype: GGMLType, k: int) -> np.ndarray:
    """raw ggml bytes (..., row_bytes) -> f32 (..., k)."""
    fn = DENSE_DEQUANTIZERS.get(qtype)
    if fn is not None:
        return fn(raw, k)
    from tpulamm_torch.quant.repack import SPECS, dequantize_rows
    if qtype not in SPECS:
        raise ValueError(f"unsupported tensor type {qtype!r}")
    lead = raw.shape[:-1]
    out = dequantize_rows(raw.reshape(-1, raw.shape[-1]), qtype, k)
    return out.reshape(*lead, k)
