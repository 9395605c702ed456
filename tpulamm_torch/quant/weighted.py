"""Importance-weighted quantization (imatrix path; counterpart of
tpulamm.quant.weighted).

Parity with ggml's quantize_row_q4_0_impl / quantize_row_q5_0_impl
(ggml-quants.c) and make_qx_quants: per 32-block, search 19 scale
candidates -(nmax + 0.1*is)/max and keep the one maximizing
(Σ w·x·L)² / Σ w·L², with per-element weights
w = qw * sqrt(sigma2 + x²), sigma2 = mean(x²) per row and qw the
per-column importance collected by the imatrix tool. Vectorized over the
blocks of 64 rows at a time (numpy), the row groups in threads, instead of
the reference's per-row C loop.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.quant.formats import (_blocks, _f16_bytes, _out_bytes, _pack_qh,
                                   quantize)

QK = 32


def make_qx_quants(xb: np.ndarray, nmax: int, w: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """xb, w: (..., 32) -> (scale (...,), levels (..., 32) in [0, 2*nmax))."""
    amax = np.abs(xb).max(axis=-1)
    idx = np.abs(xb).argmax(axis=-1)
    mx = np.take_along_axis(xb, idx[..., None], axis=-1)[..., 0]  # signed

    zero = amax == 0.0   # reference: exact !amax test
    mx_safe = np.where(zero, 1.0, mx)

    # candidate order: is=0 first, then -9..-1, 1..9 (strict improvement)
    cand = np.array([0] + list(range(-9, 0)) + list(range(1, 10)), np.float32)
    iscale = -(nmax + 0.1 * cand) / mx_safe[..., None]      # (..., 19)
    l = np.rint(iscale[..., :, None] * xb[..., None, :])    # (..., 19, 32)
    l = np.clip(l, -nmax, nmax - 1)
    sumlx = np.sum(w[..., None, :] * xb[..., None, :] * l, axis=-1)
    suml2 = np.sum(w[..., None, :] * l * l, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.where(suml2 > 0, sumlx * sumlx / suml2, -np.inf)
        scale_c = np.where(suml2 > 0, sumlx / suml2, 0.0)
    best = np.argmax(score, axis=-1)                         # first max wins
    scale = np.take_along_axis(scale_c, best[..., None], -1)[..., 0]
    levels = np.take_along_axis(
        l, best[..., None, None].repeat(QK, -1), axis=-2)[..., 0, :]
    scale = np.where(zero, 0.0, scale).astype(np.float32)
    # all-zero blocks encode as L = 0 (reference memsets L), i.e. the
    # stored level is -nmax before the +nmax bias
    levels = np.where(zero[..., None], -float(nmax), levels) + nmax
    return scale, levels.astype(np.uint8)


def _row_weights(x: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """w = qw * sqrt(sigma2 + x²), sigma2 = mean(x²) per row."""
    sigma2 = np.mean(x * x, axis=-1, keepdims=True)
    return qw * np.sqrt(sigma2 + x * x)


def quantize_q4_0_weighted(x: np.ndarray, qw: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    w = _row_weights(x, np.broadcast_to(qw, x.shape))
    xb = _blocks(x, QK)
    wb = _blocks(w, QK)
    d, L = make_qx_quants(xb, 8, wb)
    out = _out_bytes(xb, 18)
    out[..., 0:2] = _f16_bytes(d)
    out[..., 2:18] = L[..., :16] | (L[..., 16:] << 4)
    return out.reshape(*x.shape[:-1], -1)


def quantize_q5_0_weighted(x: np.ndarray, qw: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    w = _row_weights(x, np.broadcast_to(qw, x.shape))
    xb = _blocks(x, QK)
    wb = _blocks(w, QK)
    d, L = make_qx_quants(xb, 16, wb)
    out = _out_bytes(xb, 22)
    out[..., 0:2] = _f16_bytes(d)
    out[..., 2:6] = _pack_qh(L)
    lo = L & 0x0F
    out[..., 6:22] = lo[..., :16] | (lo[..., 16:] << 4)
    return out.reshape(*x.shape[:-1], -1)


_WEIGHTED = {
    GGMLType.Q4_0: quantize_q4_0_weighted,
    GGMLType.Q5_0: quantize_q5_0_weighted,
}


# rows a task of the weighted search: its (rows, K/32, 19, 32) candidates
# stay a few tens of MB, and the tasks run in threads (numpy releases the
# GIL in them); every block is searched on its own, so the bytes do not
# depend on the split
ROWS_A_TASK = 64


def quantize_weighted(x: np.ndarray, qtype: GGMLType,
                      qw: np.ndarray | None) -> np.ndarray:
    """Weighted when supported and qw given; plain reference RTN otherwise
    (the reference's quantize_row_*_impl do the same fallback)."""
    if qw is None or qtype not in _WEIGHTED:
        return quantize(x, qtype)
    fn = _WEIGHTED[qtype]
    rows = np.asarray(x).reshape(-1, x.shape[-1])
    starts = range(0, rows.shape[0], ROWS_A_TASK)
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        parts = list(ex.map(
            lambda i: fn(rows[i:i + ROWS_A_TASK], qw), starts))
    return np.concatenate(parts).reshape(*x.shape[:-1], -1)
