"""Load-time repacking: GGUF block layout -> quantized planes for the kernels.

Copy of tpulamm.quant.repack (numpy path only). The planes are the ones the
JAX package streams to its TPU kernels; the CUDA kernels in
tpulamm_torch/csrc read them as they are. In the mm layout N is the last
axis, so neighbouring GPU threads read neighbouring bytes of one plane row.

mm layout ("transposed", used by the fused dequant-matmul kernels; K is the
contraction dim, N the output dim; all planes have N on the last/lane axis):

  qs      uint8 (K/2, N)   nibbles: within each 256-row K-chunk c, the byte at
                           row 128c + r holds element 256c+r in its low nibble
                           and element 256c+128+r in its high nibble
  qh      uint8 (K/8, N)   (Q5_x) 5th bits: byte at row 32c + s holds bit t =
                           element 256c + s + 32t
  q2      uint8 (K/4, N)   (Q2_K) crumbs: byte at row 64c + s holds crumb t =
                           element 256c + s + 64t  (shift 2t)
  q8      int8  (K, N)     (Q8_0) plain transposed int8
  scales  f32   (K/g, N)   per-group scale (g=32; not Q2_K)
  mins    f32   (K/g, N)   (Q4_1/Q5_1: m)
  scd     uint8 (K/16, N)  (Q2_K) the RAW GGUF scale byte of group g:
                           (sc & 0xF) | (mn << 4); decoded in-kernel as
                           scale = d*(b&0xF), min = -dmin*(b>>4). Dense
                           f32 effective scales would inflate Q2_K's
                           device bytes from 0.33 to 0.75 B/elem.
  dm      uint16 (8K/256, N)  (Q2_K) fp16 BITS of the super-block scales:
                           row 8c = d, row 8c+1 = dmin of chunk c, rows
                           8c+2..8c+7 zero (kept so the planes match the
                           JAX package's byte for byte)

rows layout (row-major, used for quantized embedding-table gather):

  qs      uint8 (N, K/2)   byte j holds elements j (lo) and j+K/2 (hi)
  qh      uint8 (N, K/8)   byte j holds bit t = element j + (K/8)*t
  q2      uint8 (N, K/4)   byte j holds crumb t = element j + (K/4)*t
  q8      int8  (N, K)
  scales  f32   (N, K/g)
  mins    f32   (N, K/g)

Dequantization everywhere is w = (q - zero) * scale + min, with a per-format
constant `zero` (8 for Q4_0, 16 for Q5_0, else 0) — equivalent by construction
to the reference dequantize_row_* (ggml-quants.c:1650-2160).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpulamm_torch.gguf.constants import GGMLType


@dataclass(frozen=True)
class QFormatSpec:
    qtype: GGMLType
    group: int          # elements per scale group along K
    zero: float         # constant subtracted from the raw integer values
    has_min: bool
    bits: int           # bits per raw integer value (2, 4, 5, or 8)


SPECS: dict[GGMLType, QFormatSpec] = {
    GGMLType.Q4_0: QFormatSpec(GGMLType.Q4_0, 32, 8.0, False, 4),
    GGMLType.Q4_1: QFormatSpec(GGMLType.Q4_1, 32, 0.0, True, 4),
    GGMLType.Q5_0: QFormatSpec(GGMLType.Q5_0, 32, 16.0, False, 5),
    GGMLType.Q5_1: QFormatSpec(GGMLType.Q5_1, 32, 0.0, True, 5),
    GGMLType.Q8_0: QFormatSpec(GGMLType.Q8_0, 32, 0.0, False, 8),
    GGMLType.Q2_K: QFormatSpec(GGMLType.Q2_K, 16, 0.0, True, 2),
}
# NOTE: Q2_K's on-disk semantics are w = d*sc*q - dmin*mn; the repacked
# planes store scales = d*sc and mins = -(dmin*mn) so that every format
# dequantizes uniformly as w = (q - zero) * scale + min.


# ---------------------------------------------------------------------------
# step 1: GGUF bytes -> integer values + f32 scale/min arrays (all row-major)
# ---------------------------------------------------------------------------

def extract_ints(raw: np.ndarray, qtype: GGMLType, k: int):
    """raw (N, row_bytes) -> (vals (N,K) int, scales (N,K/g) f32, mins|None).

    For Q2_K the returned scales/mins are the *effective* per-16 values
    d*(sc&0xF) and dmin*(sc>>4); vals are the 2-bit crumbs and
    w = val*scale - min  (i.e. zero=0, min plane negated at use site).
    """
    n = raw.shape[0]
    if qtype == GGMLType.Q4_0:
        blk = raw.reshape(n, k // 32, 18)
        d = blk[..., 0:2].copy().view(np.float16).astype(np.float32)[..., 0]
        qs = blk[..., 2:18]
        vals = np.concatenate([qs & 0x0F, qs >> 4], axis=-1)
        return vals.reshape(n, k), d, None
    if qtype == GGMLType.Q4_1:
        blk = raw.reshape(n, k // 32, 20)
        d = blk[..., 0:2].copy().view(np.float16).astype(np.float32)[..., 0]
        m = blk[..., 2:4].copy().view(np.float16).astype(np.float32)[..., 0]
        qs = blk[..., 4:20]
        vals = np.concatenate([qs & 0x0F, qs >> 4], axis=-1)
        return vals.reshape(n, k), d, m
    if qtype in (GGMLType.Q5_0, GGMLType.Q5_1):
        bb = 22 if qtype == GGMLType.Q5_0 else 24
        off = 2 if qtype == GGMLType.Q5_0 else 4
        blk = raw.reshape(n, k // 32, bb)
        d = blk[..., 0:2].copy().view(np.float16).astype(np.float32)[..., 0]
        m = None
        if qtype == GGMLType.Q5_1:
            m = blk[..., 2:4].copy().view(np.float16).astype(np.float32)[..., 0]
        qh = np.ascontiguousarray(blk[..., off:off + 4]).view(np.uint32)[..., 0]
        shifts = np.arange(32, dtype=np.uint32)
        hbits = ((qh[..., None] >> shifts) & 1).astype(np.uint8)
        qs = blk[..., off + 4:off + 20]
        nib = np.concatenate([qs & 0x0F, qs >> 4], axis=-1)
        vals = nib | (hbits << 4)
        return vals.reshape(n, k), d, m
    if qtype == GGMLType.Q8_0:
        blk = raw.reshape(n, k // 32, 34)
        d = blk[..., 0:2].copy().view(np.float16).astype(np.float32)[..., 0]
        vals = blk[..., 2:34].view(np.int8)
        return vals.reshape(n, k), d, None
    if qtype == GGMLType.Q2_K:
        blk = raw.reshape(n, k // 256, 84)
        sc = blk[..., 0:16]
        qs = blk[..., 16:80]
        d = blk[..., 80:82].copy().view(np.float16).astype(np.float32)[..., 0]
        dmin = blk[..., 82:84].copy().view(np.float16).astype(np.float32)[..., 0]
        e = np.arange(256)
        half, r = e // 128, e % 128
        byte_idx = 32 * half + (r % 32)
        shift = 2 * (r // 32)
        sc_idx = 8 * half + 2 * (r // 32) + (r % 32) // 16
        crumbs = (qs[..., byte_idx] >> shift) & 3            # (N, nb, 256)
        # scale index of element e happens to be exactly e//16 (the nested
        # half/shift/l ordering of ggml's layout linearizes to natural order),
        # so the effective per-16-group scales are already in K order
        eff_d = d[..., None] * (sc & 0xF).astype(np.float32)   # (N, nb, 16)
        eff_m = dmin[..., None] * (sc >> 4).astype(np.float32)
        return (crumbs.reshape(n, k), eff_d.reshape(n, -1), eff_m.reshape(n, -1))
    raise ValueError(f"unsupported qtype {qtype!r}")


# ---------------------------------------------------------------------------
# step 2: integer values -> planes
# ---------------------------------------------------------------------------

def _mm_nibble_plane(vals: np.ndarray) -> np.ndarray:
    """(N, K) 4-bit vals -> (K/2, N) packed per the mm layout."""
    n, k = vals.shape
    v = vals.reshape(n, k // 256, 2, 128)
    byte = (v[:, :, 0, :] | (v[:, :, 1, :] << 4)).astype(np.uint8)
    return np.ascontiguousarray(byte.transpose(1, 2, 0).reshape(k // 2, n))


def _mm_hbit_plane(vals: np.ndarray) -> np.ndarray:
    """(N, K) 5-bit vals -> 5th-bit plane (K/8, N)."""
    n, k = vals.shape
    bits = ((vals >> 4) & 1).reshape(n, k // 256, 8, 32)  # [., c, t, s]
    t = np.arange(8, dtype=np.uint8)[None, None, :, None]
    byte = (bits.astype(np.uint8) << t).sum(axis=2, dtype=np.uint8)  # (n, c, 32)
    return np.ascontiguousarray(byte.transpose(1, 2, 0).reshape(k // 8, n))


def _mm_crumb_plane(vals: np.ndarray) -> np.ndarray:
    """(N, K) 2-bit vals -> crumb plane (K/4, N)."""
    n, k = vals.shape
    c = vals.reshape(n, k // 256, 4, 64)                   # [., c, t, s]
    t = (2 * np.arange(4, dtype=np.uint8))[None, None, :, None]
    byte = (c.astype(np.uint8) << t).sum(axis=2, dtype=np.uint8)
    return np.ascontiguousarray(byte.transpose(1, 2, 0).reshape(k // 4, n))


def _q2k_compact_scale_planes(raw: np.ndarray, k: int) -> dict[str, np.ndarray]:
    """Q2_K mm scale planes in COMPACT form (see module docstring)."""
    n = raw.shape[0]
    nb = k // 256
    blk = raw.reshape(n, nb, 84)
    scd = blk[..., 0:16]                                 # (N, nb, 16)
    dm2 = np.ascontiguousarray(blk[..., 80:84]).view(np.uint16)  # (N, nb, 2)
    dm = np.zeros((n, nb, 8), np.uint16)
    dm[..., :2] = dm2
    return {
        "scd": np.ascontiguousarray(
            scd.reshape(n, -1).T),                       # (K/16, N) u8
        "dm": np.ascontiguousarray(
            dm.reshape(n, -1).T),                        # (8K/256, N) u16
    }


def repack_mm(raw: np.ndarray, qtype: GGMLType, k: int) -> dict[str, np.ndarray]:
    """GGUF rows (N, row_bytes) -> mm-layout planes for the matmul kernels."""
    spec = SPECS[qtype]
    if k % 256 != 0:
        raise ValueError(f"mm repack needs K % 256 == 0, got {k}")
    raw = raw.reshape(raw.shape[0], -1)
    vals, scales, mins = extract_ints(raw, qtype, k)
    if qtype == GGMLType.Q2_K:
        out = {"q2": _mm_crumb_plane(vals)}
        out.update(_q2k_compact_scale_planes(raw, k))
        return out
    out: dict[str, np.ndarray] = {}
    if spec.bits == 4:
        out["qs"] = _mm_nibble_plane(vals)
    elif spec.bits == 5:
        out["qs"] = _mm_nibble_plane(vals & 0x0F)
        out["qh"] = _mm_hbit_plane(vals)
    elif spec.bits == 8:
        out["q8"] = np.ascontiguousarray(vals.T)
    out["scales"] = np.ascontiguousarray(scales.T.astype(np.float32))
    if mins is not None:
        out["mins"] = np.ascontiguousarray(mins.T.astype(np.float32))
    return out


def repack_rows(raw: np.ndarray, qtype: GGMLType, k: int) -> dict[str, np.ndarray]:
    """GGUF rows -> row-major planes for quantized embedding gather."""
    spec = SPECS[qtype]
    vals, scales, mins = extract_ints(raw, qtype, k)
    if qtype == GGMLType.Q2_K:
        mins = -mins
    n = vals.shape[0]
    out: dict[str, np.ndarray] = {}
    if spec.bits in (4, 5):
        nib = (vals & 0x0F).reshape(n, 2, k // 2)
        out["qs"] = (nib[:, 0] | (nib[:, 1] << 4)).astype(np.uint8)
        if spec.bits == 5:
            bits = ((vals >> 4) & 1).reshape(n, 8, k // 8)
            t = np.arange(8, dtype=np.uint8)[None, :, None]
            out["qh"] = (bits.astype(np.uint8) << t).sum(axis=1, dtype=np.uint8)
    elif spec.bits == 2:
        c = vals.reshape(n, 4, k // 4)
        t = (2 * np.arange(4, dtype=np.uint8))[None, :, None]
        out["q2"] = (c.astype(np.uint8) << t).sum(axis=1, dtype=np.uint8)
    elif spec.bits == 8:
        out["q8"] = np.ascontiguousarray(vals)
    out["scales"] = np.ascontiguousarray(scales.astype(np.float32))
    if mins is not None:
        out["mins"] = np.ascontiguousarray(mins.astype(np.float32))
    return out
