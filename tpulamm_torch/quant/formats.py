"""Bit-exact numpy codecs for the ggml block-quant formats (counterpart of
tpulamm.quant.formats).

These follow the reference encode/decode rules of
llama.cpp-b2430/ggml-quants.c, exactly but for one order of summation
(below):

- quantize_row_q4_0_reference  (:1002)  d = max/-8, xi = MIN(15, trunc(x/d + 8.5))
- quantize_row_q4_1_reference  (:1044)  d = (max-min)/15, m = min
- quantize_row_q5_0_reference  (:1085)  d = max/-16, 5th bits packed into u32 qh
- quantize_row_q5_1_reference  (:1133)  d = (max-min)/31, m = min
- quantize_row_q8_0_reference  (:1182)  d = amax/127, qs = roundf(x/d)
- quantize_row_q8_1_reference  (:1396)  + s = d * sum(qs)
- quantize_row_q2_K_reference  (:2039)  K-quant superblock, make_qkx2_quants search
- quantize_row_q8_K_reference  (:3981)  f32 d = -max/127, per-16 bsums
- the matching dequantize_row_* functions (:1650-2160)

Conventions preserved:
- scales are computed in f32 and *stored* as IEEE fp16 (numpy float16 casts
  round-to-nearest-even, same as GGML_FP32_TO_FP16); the quantization step uses
  the *unrounded* f32 scale, exactly like the reference.
- nearest_int() in the reference is round-half-to-even == np.rint.
- roundf() is round-half-away-from-zero.
- (int8_t) float casts are truncation toward zero == np.trunc.
- The "first maximum wins" scan semantics (strict < compare) == np.argmax.
- Not preserved: make_qkx2_quants sums its 16 weighted terms in sequence;
  _make_qkx2_quants sums them with np.sum, in numpy's pairwise order, so a
  rare Q2_K scale differs from ggml's in its last bit. The host codec
  (csrc/tl_codec.cpp, sum16) follows numpy's order, to equal these bytes.

All codecs are vectorized over blocks; x has shape (..., k) with k a multiple
of the block size. Quantized bytes are returned as uint8 arrays with shape
(..., k // block_elems * block_bytes) — the exact on-disk GGUF byte layout.

These numpy functions are the plain versions: `quantize` and `dequantize`
code the block formats through the host codec (quant.native,
csrc/tl_codec.cpp), which the tests hold to them byte for byte, and only
the dense types (F32, F16, BF16) through numpy here.
"""

from __future__ import annotations

import numpy as np

from tpulamm_torch.gguf.constants import GGML_TYPE_SIZES, GGMLType
from tpulamm_torch.quant import native

QK = 32      # block size for Q4_0/Q4_1/Q5_0/Q5_1/Q8_0/Q8_1
QK_K = 256   # super-block size for K-quants


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return np.sign(x) * np.floor(np.abs(x) + np.float32(0.5))


def _signed_absmax(x: np.ndarray) -> np.ndarray:
    """Per-row value with the largest |.|, first occurrence wins (f32)."""
    idx = np.argmax(np.abs(x), axis=-1)
    return np.take_along_axis(x, idx[..., None], axis=-1)[..., 0]


def _safe_inv(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    return inv.astype(np.float32)


def _blocks(x: np.ndarray, qk: int) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.shape[-1] % qk != 0:
        raise ValueError(f"last dim {x.shape[-1]} not a multiple of {qk}")
    return x.reshape(*x.shape[:-1], x.shape[-1] // qk, qk)


def _out_bytes(x_blocks: np.ndarray, block_bytes: int) -> np.ndarray:
    lead = x_blocks.shape[:-2]
    nb = x_blocks.shape[-2]
    return np.zeros((*lead, nb, block_bytes), dtype=np.uint8)


def _f16_bytes(v: np.ndarray) -> np.ndarray:
    """f32 -> fp16 (RNE) -> 2 le bytes, appended as last axis."""
    return v.astype(np.float16)[..., None].view(np.uint8)


def _read_f16(raw: np.ndarray, off: int) -> np.ndarray:
    """Read an fp16 at byte offset `off` of each block -> f32."""
    b = np.ascontiguousarray(raw[..., off:off + 2])
    return b.view(np.float16)[..., 0].astype(np.float32)


# ---------------------------------------------------------------------------
# Q4_0
# ---------------------------------------------------------------------------

def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, QK)
    mx = _signed_absmax(xb)
    d = (mx / np.float32(-8.0)).astype(np.float32)
    idv = _safe_inv(d)
    q = xb * idv[..., None] + np.float32(8.5)
    q = np.minimum(np.trunc(q), 15).astype(np.int64)
    q = np.clip(q, 0, 15).astype(np.uint8)
    out = _out_bytes(xb, 18)
    out[..., 0:2] = _f16_bytes(d)
    out[..., 2:18] = q[..., :16] | (q[..., 16:] << 4)
    return out.reshape(*x.shape[:-1], -1)


def dequantize_q4_0(raw: np.ndarray, k: int) -> np.ndarray:
    raw = raw.reshape(*raw.shape[:-1], k // QK, 18)
    d = _read_f16(raw, 0)
    qs = raw[..., 2:18]
    lo = (qs & 0x0F).astype(np.int32) - 8
    hi = (qs >> 4).astype(np.int32) - 8
    vals = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    y = vals * d[..., None]
    return y.reshape(*raw.shape[:-2], k)


# ---------------------------------------------------------------------------
# Q4_1
# ---------------------------------------------------------------------------

def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, QK)
    mn = xb.min(axis=-1)
    mx = xb.max(axis=-1)
    d = ((mx - mn) / np.float32(15.0)).astype(np.float32)
    idv = _safe_inv(d)
    q = (xb - mn[..., None]) * idv[..., None] + np.float32(0.5)
    q = np.clip(np.minimum(np.trunc(q), 15), 0, 15).astype(np.uint8)
    out = _out_bytes(xb, 20)
    out[..., 0:2] = _f16_bytes(d)
    out[..., 2:4] = _f16_bytes(mn)
    out[..., 4:20] = q[..., :16] | (q[..., 16:] << 4)
    return out.reshape(*x.shape[:-1], -1)


def dequantize_q4_1(raw: np.ndarray, k: int) -> np.ndarray:
    raw = raw.reshape(*raw.shape[:-1], k // QK, 20)
    d = _read_f16(raw, 0)
    m = _read_f16(raw, 2)
    qs = raw[..., 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    vals = np.concatenate([lo, hi], axis=-1)
    y = vals * d[..., None] + m[..., None]
    return y.reshape(*raw.shape[:-2], k)


# ---------------------------------------------------------------------------
# Q5_0 / Q5_1
# ---------------------------------------------------------------------------

def _pack_qh(q: np.ndarray) -> np.ndarray:
    """Pack bit 4 of 32 5-bit values into a le u32 (4 bytes): bit j of qh is
    bit 4 of element j."""
    bits = ((q >> 4) & 1).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    qh = (bits << shifts).sum(axis=-1, dtype=np.uint32)
    return qh[..., None].view(np.uint8)


def _unpack_qh(raw4: np.ndarray) -> np.ndarray:
    """4 le bytes -> (..., 32) array of the 5th bits (0/1 uint8)."""
    qh = np.ascontiguousarray(raw4).view(np.uint32)[..., 0]
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh[..., None] >> shifts) & 1).astype(np.uint8)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, QK)
    mx = _signed_absmax(xb)
    d = (mx / np.float32(-16.0)).astype(np.float32)
    idv = _safe_inv(d)
    q = xb * idv[..., None] + np.float32(16.5)
    q = np.clip(np.minimum(np.trunc(q), 31), 0, 31).astype(np.uint8)
    out = _out_bytes(xb, 22)
    out[..., 0:2] = _f16_bytes(d)
    out[..., 2:6] = _pack_qh(q)
    lo = q & 0x0F
    out[..., 6:22] = lo[..., :16] | (lo[..., 16:] << 4)
    return out.reshape(*x.shape[:-1], -1)


def dequantize_q5_0(raw: np.ndarray, k: int) -> np.ndarray:
    raw = raw.reshape(*raw.shape[:-1], k // QK, 22)
    d = _read_f16(raw, 0)
    h = _unpack_qh(raw[..., 2:6])
    qs = raw[..., 6:22]
    lo = (qs & 0x0F).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    vals = np.concatenate([lo, hi], axis=-1) | (h.astype(np.int32) << 4)
    y = (vals - 16).astype(np.float32) * d[..., None]
    return y.reshape(*raw.shape[:-2], k)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, QK)
    mn = xb.min(axis=-1)
    mx = xb.max(axis=-1)
    d = ((mx - mn) / np.float32(31.0)).astype(np.float32)
    idv = _safe_inv(d)
    q = (xb - mn[..., None]) * idv[..., None] + np.float32(0.5)
    q = np.clip(np.trunc(q), 0, 31).astype(np.uint8)
    out = _out_bytes(xb, 24)
    out[..., 0:2] = _f16_bytes(d)
    out[..., 2:4] = _f16_bytes(mn)
    out[..., 4:8] = _pack_qh(q)
    lo = q & 0x0F
    out[..., 8:24] = lo[..., :16] | (lo[..., 16:] << 4)
    return out.reshape(*x.shape[:-1], -1)


def dequantize_q5_1(raw: np.ndarray, k: int) -> np.ndarray:
    raw = raw.reshape(*raw.shape[:-1], k // QK, 24)
    d = _read_f16(raw, 0)
    m = _read_f16(raw, 2)
    h = _unpack_qh(raw[..., 4:8])
    qs = raw[..., 8:24]
    lo = (qs & 0x0F).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    vals = np.concatenate([lo, hi], axis=-1) | (h.astype(np.int32) << 4)
    y = vals.astype(np.float32) * d[..., None] + m[..., None]
    return y.reshape(*raw.shape[:-2], k)


# ---------------------------------------------------------------------------
# Q8_0 / Q8_1
# ---------------------------------------------------------------------------

def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, QK)
    amax = np.abs(xb).max(axis=-1)
    d = (amax / np.float32(127.0)).astype(np.float32)
    idv = _safe_inv(d)
    q = _roundf(xb * idv[..., None]).astype(np.int8)
    out = _out_bytes(xb, 34)
    out[..., 0:2] = _f16_bytes(d)
    out[..., 2:34] = q.view(np.uint8)
    return out.reshape(*x.shape[:-1], -1)


def dequantize_q8_0(raw: np.ndarray, k: int) -> np.ndarray:
    raw = raw.reshape(*raw.shape[:-1], k // QK, 34)
    d = _read_f16(raw, 0)
    q = raw[..., 2:34].view(np.int8).astype(np.float32)
    y = q * d[..., None]
    return y.reshape(*raw.shape[:-2], k)


def quantize_q8_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, QK)
    amax = np.abs(xb).max(axis=-1)
    d = (amax / np.float32(127.0)).astype(np.float32)
    idv = _safe_inv(d)
    q = _roundf(xb * idv[..., None]).astype(np.int8)
    s = q.astype(np.int32).sum(axis=-1).astype(np.float32) * d
    out = _out_bytes(xb, 36)
    out[..., 0:2] = _f16_bytes(d)
    out[..., 2:4] = _f16_bytes(s)
    out[..., 4:36] = q.view(np.uint8)
    return out.reshape(*x.shape[:-1], -1)


def dequantize_q8_1(raw: np.ndarray, k: int) -> np.ndarray:
    raw = raw.reshape(*raw.shape[:-1], k // QK, 36)
    d = _read_f16(raw, 0)
    q = raw[..., 4:36].view(np.int8).astype(np.float32)
    y = q * d[..., None]
    return y.reshape(*raw.shape[:-2], k)


# ---------------------------------------------------------------------------
# Q2_K (256-elem super-blocks, 16 sub-blocks of 16, 4-bit sub scales/mins)
# ---------------------------------------------------------------------------

def _make_qkx2_quants(x: np.ndarray, weights: np.ndarray, nmax: int,
                      rmin: float, rdelta: float, nstep: int) -> tuple:
    """Vectorized make_qkx2_quants (ggml-quants.c:1851-1903, use_mad=True).

    x, weights: (..., n). Returns (scale, the_min, L) with L uint8 (..., n).
    """
    f32 = np.float32
    n = x.shape[-1]
    mn = x.min(axis=-1)
    mx = x.max(axis=-1)
    sum_w = weights.sum(axis=-1, dtype=f32)
    sum_x = (weights * x).sum(axis=-1, dtype=f32)
    mn = np.minimum(mn, f32(0.0))
    degenerate = mx == mn

    def _span(cur):  # guard div-by-0; degenerate groups are masked out below
        return np.where(degenerate, f32(1.0), mx - cur)

    iscale = f32(nmax) / _span(mn)
    scale = 1.0 / iscale
    L = np.clip(np.rint(iscale[..., None] * (x - mn[..., None])), 0, nmax)
    diff = scale[..., None] * L + mn[..., None] - x
    best_mad = (weights * np.abs(diff)).sum(axis=-1, dtype=f32)
    cur_min = mn

    for step in range(nstep + 1):
        # NOTE: the reference mutates `min` on acceptance, so each grid step
        # uses the most recently accepted min (ggml-quants.c:1884-1899)
        isc = (f32(rmin) + f32(rdelta) * f32(step) + f32(nmax)) / _span(cur_min)
        l = np.clip(np.rint(isc[..., None] * (x - cur_min[..., None])), 0, nmax)
        sum_l = (weights * l).sum(axis=-1, dtype=f32)
        sum_l2 = (weights * l * l).sum(axis=-1, dtype=f32)
        sum_xl = (weights * l * x).sum(axis=-1, dtype=f32)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = (sum_w * sum_xl - sum_x * sum_l) / D
            this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D
            alt_scale = np.where(sum_l2 != 0, sum_xl / sum_l2, f32(0.0))
        pos_min = this_min > 0
        this_scale = np.where(pos_min, alt_scale, this_scale)
        this_min = np.where(pos_min, f32(0.0), this_min)
        diff = this_scale[..., None] * l + this_min[..., None] - x
        mad = (weights * np.abs(diff)).sum(axis=-1, dtype=f32)
        better = (D > 0) & (mad < best_mad)
        L = np.where(better[..., None], l, L)
        best_mad = np.where(better, mad, best_mad)
        scale = np.where(better, this_scale, scale)
        cur_min = np.where(better, this_min, cur_min)

    scale = np.where(degenerate, f32(0.0), scale).astype(f32)
    the_min = np.where(degenerate, -mn, -cur_min).astype(f32)
    return scale, the_min, L.astype(np.uint8)


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    xb = _blocks(x, QK_K)                      # (..., nb, 256)
    xg = xb.reshape(*xb.shape[:-1], 16, 16)    # 16 groups of 16
    weights = np.abs(xg)
    scales, mins, L = _make_qkx2_quants(xg, weights, 3, -0.5, 0.1, 15)

    max_scale = scales.max(axis=-1)
    max_min = mins.max(axis=-1)

    has_scale = max_scale > 0
    isc = np.where(has_scale, f32(15.0) / np.where(has_scale, max_scale, 1), f32(0.0))
    sc4 = np.where(has_scale[..., None],
                   np.rint(isc[..., None] * scales), f32(0.0)).astype(np.uint8)
    d = np.where(has_scale, max_scale / f32(15.0), f32(0.0)).astype(f32)

    has_min = max_min > 0
    imn = np.where(has_min, f32(15.0) / np.where(has_min, max_min, 1), f32(0.0))
    mn4 = np.where(has_min[..., None],
                   np.rint(imn[..., None] * mins), f32(0.0)).astype(np.uint8)
    dmin = np.where(has_min, max_min / f32(15.0), f32(0.0)).astype(f32)

    scales_b = (sc4 & 0xF) | (mn4 << 4)        # (..., nb, 16) uint8

    # requantize with the fp16-rounded d/dmin and 4-bit sub-scales
    d16 = d.astype(np.float16).astype(f32)
    dmin16 = dmin.astype(np.float16).astype(f32)
    dd = d16[..., None] * (scales_b & 0xF).astype(f32)          # (..., nb, 16)
    dm = dmin16[..., None] * (scales_b >> 4).astype(f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = np.rint((xg + dm[..., None]) / dd[..., None])
    lq = np.clip(np.nan_to_num(lq, nan=0.0, posinf=0.0, neginf=0.0), 0, 3)
    L = np.where((dd != 0)[..., None], lq, L).astype(np.uint8)

    Lf = L.reshape(*xb.shape[:-1], 256)
    out = _out_bytes(xb, 84)
    out[..., 0:16] = scales_b
    # qs packing: ggml-quants.c:2106-2112
    for h in range(2):                          # 128-element halves
        base = 128 * h
        seg = lambda o: Lf[..., base + o: base + o + 32]
        out[..., 16 + 32 * h: 16 + 32 * (h + 1)] = (
            seg(0) | (seg(32) << 2) | (seg(64) << 4) | (seg(96) << 6))
    out[..., 80:82] = _f16_bytes(d)
    out[..., 82:84] = _f16_bytes(dmin)
    return out.reshape(*x.shape[:-1], -1)


def dequantize_q2_k(raw: np.ndarray, k: int) -> np.ndarray:
    raw = raw.reshape(*raw.shape[:-1], k // QK_K, 84)
    scales_b = raw[..., 0:16]
    qs = raw[..., 16:80]
    d = _read_f16(raw, 80)
    dmin = _read_f16(raw, 82)

    # element e (0..255): half = e//128, r = e%128, shift = 2*(r//32), l = r%32
    # byte = qs[32*half + l]; scale idx = 8*half + 2*(r//32) + l//16
    e = np.arange(256)
    half = e // 128
    r = e % 128
    shift = 2 * (r // 32)
    byte_idx = 32 * half + (r % 32)
    sc_idx = 8 * half + 2 * (r // 32) + (r % 32) // 16

    crumbs = (qs[..., byte_idx] >> shift) & 3               # (..., nb, 256)
    sc = scales_b[..., sc_idx]
    dl = d[..., None] * (sc & 0xF).astype(np.float32)
    ml = dmin[..., None] * (sc >> 4).astype(np.float32)
    y = dl * crumbs.astype(np.float32) - ml
    return y.reshape(*raw.shape[:-2], k)


# ---------------------------------------------------------------------------
# Q8_K (activation-side format in the reference; included for completeness)
# ---------------------------------------------------------------------------

def quantize_q8_k(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    xb = _blocks(x, QK_K)
    mx = _signed_absmax(xb)
    amax = np.abs(mx)
    zero = amax == 0
    with np.errstate(divide="ignore"):
        iscale = np.where(zero, f32(0.0), f32(-127.0) / mx)
    q = np.minimum(np.rint(iscale[..., None] * xb), 127).astype(np.int8)
    q = np.where(zero[..., None], np.int8(0), q)
    d = np.where(zero, f32(0.0), _safe_inv(iscale)).astype(f32)
    bsums = q.reshape(*q.shape[:-1], 16, 16).astype(np.int32).sum(axis=-1)
    out = _out_bytes(xb, 292)
    out[..., 0:4] = d[..., None].view(np.uint8)
    out[..., 4:260] = q.view(np.uint8)
    out[..., 260:292] = bsums.astype("<i2").view(np.uint8).reshape(*out.shape[:-1], 32)
    return out.reshape(*x.shape[:-1], -1)


def dequantize_q8_k(raw: np.ndarray, k: int) -> np.ndarray:
    raw = raw.reshape(*raw.shape[:-1], k // QK_K, 292)
    d = np.ascontiguousarray(raw[..., 0:4]).view(np.float32)[..., 0]
    q = raw[..., 4:260].view(np.int8).astype(np.float32)
    y = q * d[..., None]
    return y.reshape(*raw.shape[:-2], k)


# ---------------------------------------------------------------------------
# F32 / F16 passthrough + dispatch tables
# ---------------------------------------------------------------------------

def quantize_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype="<f4").view(np.uint8)


def dequantize_f32(raw: np.ndarray, k: int) -> np.ndarray:
    return (np.ascontiguousarray(raw).view("<f4")
            .astype(np.float32).reshape(*raw.shape[:-1], k))


def quantize_f16(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype("<f2")).view(np.uint8)


def dequantize_f16(raw: np.ndarray, k: int) -> np.ndarray:
    return (np.ascontiguousarray(raw).view("<f2")
            .astype(np.float32).reshape(*raw.shape[:-1], k))


QUANTIZERS = {
    GGMLType.F32: quantize_f32,
    GGMLType.F16: quantize_f16,
    GGMLType.Q4_0: quantize_q4_0,
    GGMLType.Q4_1: quantize_q4_1,
    GGMLType.Q5_0: quantize_q5_0,
    GGMLType.Q5_1: quantize_q5_1,
    GGMLType.Q8_0: quantize_q8_0,
    GGMLType.Q8_1: quantize_q8_1,
    GGMLType.Q2_K: quantize_q2_k,
    GGMLType.Q8_K: quantize_q8_k,
}

def dequantize_bf16(raw: np.ndarray, k: int) -> np.ndarray:
    u = (np.ascontiguousarray(raw).view("<u2").astype(np.uint32) << 16)
    return u.view(np.float32).reshape(*raw.shape[:-1], k)


DEQUANTIZERS = {
    GGMLType.F32: dequantize_f32,
    GGMLType.F16: dequantize_f16,
    GGMLType.BF16: dequantize_bf16,
    GGMLType.Q4_0: dequantize_q4_0,
    GGMLType.Q4_1: dequantize_q4_1,
    GGMLType.Q5_0: dequantize_q5_0,
    GGMLType.Q5_1: dequantize_q5_1,
    GGMLType.Q8_0: dequantize_q8_0,
    GGMLType.Q8_1: dequantize_q8_1,
    GGMLType.Q2_K: dequantize_q2_k,
    GGMLType.Q8_K: dequantize_q8_k,
}

# weight formats users can quantize models to (parity with reference's 7)
WEIGHT_TYPES = (GGMLType.F32, GGMLType.Q2_K, GGMLType.Q4_0, GGMLType.Q4_1,
                GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0)


def quantize(x: np.ndarray, qtype: GGMLType) -> np.ndarray:
    """f32 array (..., k) -> raw bytes in ggml on-disk layout: the block
    formats through the host codec, F32 and F16 through numpy."""
    if qtype in native.CODEC_TYPES:
        return native.quantize(x, qtype)
    fn = QUANTIZERS.get(qtype)
    if fn is None:
        raise ValueError(f"unsupported tensor type {qtype!r} (supported: "
                         f"{sorted(t.name for t in QUANTIZERS)})")
    return fn(x)


def dequantize(raw: np.ndarray, qtype: GGMLType, k: int) -> np.ndarray:
    """raw ggml bytes (..., row_bytes) -> f32 (..., k)."""
    if qtype in native.CODEC_TYPES:
        return native.dequantize(raw, qtype, k)
    fn = DEQUANTIZERS.get(qtype)
    if fn is None:
        raise ValueError(f"unsupported tensor type {qtype!r} (supported: "
                         f"{sorted(t.name for t in DEQUANTIZERS)})")
    return fn(raw, k)


def row_bytes(qtype: GGMLType, k: int) -> int:
    bs, tb = GGML_TYPE_SIZES[qtype]
    assert k % bs == 0
    return k // bs * tb
