"""Load-time repacking: GGUF block layout -> quantized planes for the kernels.

Counterpart of tpulamm.quant.repack (its numpy path), written in torch
ops on a uint8 tensor of the GGUF bytes: the repack runs where the bytes
are, so a load onto the card uploads the raw blocks and repacks them
there, where the host's numpy took most of a model load. The planes are
the JAX package's bit for bit (tests/test_torch_qtensor.py); the CUDA
kernels in tpulamm_torch/csrc read them as they are. In the mm layout N is
the last axis, so neighbouring GPU threads read neighbouring bytes of one
plane row.

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
  dm      int16 (8K/256, N) (Q2_K) fp16 BITS of the super-block scales:
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

import torch

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

def _f16(b: torch.Tensor) -> torch.Tensor:
    """(..., 2) uint8 little-endian fp16 bytes -> (...) f32."""
    return b.contiguous().view(torch.float16)[..., 0].to(torch.float32)


def _bits(b: torch.Tensor) -> torch.Tensor:
    """(..., m) uint8 -> (..., 8m) its bits, little-endian (bit i of the
    m-byte word is bit i % 8 of byte i // 8)."""
    t = torch.arange(8, dtype=torch.uint8, device=b.device)
    return ((b[..., :, None] >> t) & 1).reshape(*b.shape[:-1], -1)


def _or_shifted(parts: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """OR over `dim` of parts[.., t, ..] << (width * t), as uint8."""
    out = None
    for t in range(parts.shape[dim]):
        v = parts.select(dim, t).to(torch.uint8) << (width * t)
        out = v if out is None else out | v
    return out


def extract_ints(raw: torch.Tensor, qtype: GGMLType, k: int):
    """raw (N, row_bytes) uint8 -> (vals (N,K) int, scales (N,K/g) f32,
    mins|None).

    For Q2_K the returned scales/mins are the *effective* per-16 values
    d*(sc&0xF) and dmin*(sc>>4); vals are the 2-bit crumbs and
    w = val*scale - min  (i.e. zero=0, min plane negated at use site).
    """
    n = raw.shape[0]
    if qtype in (GGMLType.Q4_0, GGMLType.Q4_1):
        bb, off = (18, 2) if qtype == GGMLType.Q4_0 else (20, 4)
        blk = raw.reshape(n, k // 32, bb)
        d = _f16(blk[..., 0:2])
        m = _f16(blk[..., 2:4]) if qtype == GGMLType.Q4_1 else None
        qs = blk[..., off:off + 16]
        vals = torch.cat([qs & 0x0F, qs >> 4], dim=-1)
        return vals.reshape(n, k), d, m
    if qtype in (GGMLType.Q5_0, GGMLType.Q5_1):
        bb = 22 if qtype == GGMLType.Q5_0 else 24
        off = 2 if qtype == GGMLType.Q5_0 else 4
        blk = raw.reshape(n, k // 32, bb)
        d = _f16(blk[..., 0:2])
        m = _f16(blk[..., 2:4]) if qtype == GGMLType.Q5_1 else None
        hbits = _bits(blk[..., off:off + 4])               # (N, nb, 32)
        qs = blk[..., off + 4:off + 20]
        nib = torch.cat([qs & 0x0F, qs >> 4], dim=-1)
        vals = nib | (hbits << 4)
        return vals.reshape(n, k), d, m
    if qtype == GGMLType.Q8_0:
        blk = raw.reshape(n, k // 32, 34)
        d = _f16(blk[..., 0:2])
        vals = blk[..., 2:34].contiguous().view(torch.int8)
        return vals.reshape(n, k), d, None
    if qtype == GGMLType.Q2_K:
        blk = raw.reshape(n, k // 256, 84)
        sc = blk[..., 0:16]
        qs = blk[..., 16:80]
        d = _f16(blk[..., 80:82])
        dmin = _f16(blk[..., 82:84])
        e = torch.arange(256, device=raw.device)
        half, r = e // 128, e % 128
        byte_idx = 32 * half + (r % 32)
        shift = (2 * (r // 32)).to(torch.uint8)
        crumbs = (qs[..., byte_idx] >> shift) & 3            # (N, nb, 256)
        # scale index of element e happens to be exactly e//16 (the nested
        # half/shift/l ordering of ggml's layout linearizes to natural order),
        # so the effective per-16-group scales are already in K order
        eff_d = d[..., None] * (sc & 0xF).to(torch.float32)   # (N, nb, 16)
        eff_m = dmin[..., None] * (sc >> 4).to(torch.float32)
        return (crumbs.reshape(n, k), eff_d.reshape(n, -1), eff_m.reshape(n, -1))
    raise ValueError(f"unsupported qtype {qtype!r}")


# ---------------------------------------------------------------------------
# step 2: integer values -> planes
# ---------------------------------------------------------------------------

def _mm_nibble_plane(vals: torch.Tensor) -> torch.Tensor:
    """(N, K) 4-bit vals -> (K/2, N) packed per the mm layout."""
    n, k = vals.shape
    v = vals.reshape(n, k // 256, 2, 128)
    byte = v[:, :, 0, :] | (v[:, :, 1, :] << 4)
    return byte.permute(1, 2, 0).reshape(k // 2, n).contiguous()


def _mm_hbit_plane(vals: torch.Tensor) -> torch.Tensor:
    """(N, K) 5-bit vals -> 5th-bit plane (K/8, N)."""
    n, k = vals.shape
    bits = ((vals >> 4) & 1).reshape(n, k // 256, 8, 32)  # [., c, t, s]
    byte = _or_shifted(bits, 2, 1)                        # (n, c, 32)
    return byte.permute(1, 2, 0).reshape(k // 8, n).contiguous()


def _mm_crumb_plane(vals: torch.Tensor) -> torch.Tensor:
    """(N, K) 2-bit vals -> crumb plane (K/4, N)."""
    n, k = vals.shape
    c = vals.reshape(n, k // 256, 4, 64)                   # [., c, t, s]
    byte = _or_shifted(c, 2, 2)
    return byte.permute(1, 2, 0).reshape(k // 4, n).contiguous()


def _q2k_compact_scale_planes(raw: torch.Tensor,
                              k: int) -> dict[str, torch.Tensor]:
    """Q2_K mm scale planes in COMPACT form (see module docstring)."""
    n = raw.shape[0]
    nb = k // 256
    blk = raw.reshape(n, nb, 84)
    scd = blk[..., 0:16]                                 # (N, nb, 16)
    dm2 = blk[..., 80:84].contiguous().view(torch.int16)  # (N, nb, 2)
    dm = torch.zeros((n, nb, 8), dtype=torch.int16, device=raw.device)
    dm[..., :2] = dm2
    return {
        "scd": scd.reshape(n, -1).T.contiguous(),        # (K/16, N) u8
        "dm": dm.reshape(n, -1).T.contiguous(),          # (8K/256, N) bits
    }


def repack_mm(raw: torch.Tensor, qtype: GGMLType,
              k: int) -> dict[str, torch.Tensor]:
    """GGUF rows (N, row_bytes) uint8 -> mm-layout planes for the matmul
    kernels, on raw's device."""
    spec = SPECS[qtype]
    if k % 256 != 0:
        raise ValueError(f"mm repack needs K % 256 == 0, got {k}")
    raw = raw.reshape(raw.shape[0], -1)
    vals, scales, mins = extract_ints(raw, qtype, k)
    if qtype == GGMLType.Q2_K:
        out = {"q2": _mm_crumb_plane(vals)}
        out.update(_q2k_compact_scale_planes(raw, k))
        return out
    out: dict[str, torch.Tensor] = {}
    if spec.bits == 4:
        out["qs"] = _mm_nibble_plane(vals)
    elif spec.bits == 5:
        out["qs"] = _mm_nibble_plane(vals & 0x0F)
        out["qh"] = _mm_hbit_plane(vals)
    elif spec.bits == 8:
        out["q8"] = vals.T.contiguous()
    out["scales"] = scales.T.contiguous()
    if mins is not None:
        out["mins"] = mins.T.contiguous()
    return out


def repack_rows(raw: torch.Tensor, qtype: GGMLType,
                k: int) -> dict[str, torch.Tensor]:
    """GGUF rows uint8 -> row-major planes for quantized embedding gather,
    on raw's device."""
    spec = SPECS[qtype]
    raw = raw.reshape(raw.shape[0], -1)
    vals, scales, mins = extract_ints(raw, qtype, k)
    if qtype == GGMLType.Q2_K:
        mins = -mins
    n = vals.shape[0]
    out: dict[str, torch.Tensor] = {}
    if spec.bits in (4, 5):
        nib = (vals & 0x0F).reshape(n, 2, k // 2)
        out["qs"] = nib[:, 0] | (nib[:, 1] << 4)
        if spec.bits == 5:
            bits = ((vals >> 4) & 1).reshape(n, 8, k // 8)
            out["qh"] = _or_shifted(bits, 1, 1)
    elif spec.bits == 2:
        out["q2"] = _or_shifted(vals.reshape(n, 4, k // 4), 1, 2)
    elif spec.bits == 8:
        out["q8"] = vals.contiguous()
    out["scales"] = scales.contiguous()
    if mins is not None:
        out["mins"] = mins.contiguous()
    return out
