"""QTensor: a block-quantized weight living on a device as packed planes.

Counterpart of tpulamm.ops.qtensor. The planes are the ones quant.repack
produces (see its module docstring), held as torch tensors: uint8 for the
code planes, int8 for q8, f32 for scales/mins, and for Q2_K's compact
planes uint8 `scd` and the fp16 bits of `dm` as int16 (torch has no
arithmetic on uint16; the bits are the same).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.quant.repack import SPECS, repack_mm, repack_rows


def plane_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """numpy plane -> torch tensor on `device` (uint16 bits become int16)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:           # e.g. a view of another framework's
        arr = arr.copy()                  # buffer: torch needs its own copy
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    return torch.from_numpy(arr).to(device)


@dataclass
class QTensor:
    """Quantized 2-D weight of logical shape (N, K) = (out, in) features.

    layout "mm":   planes for the dequant-matmul kernels (qmatmul computes
                   x @ W.T, i.e. (..., K) -> (..., N)); N is the last axis.
    layout "rows": planes for row gather (embedding tables).
    """

    qtype: GGMLType
    shape: tuple[int, int]
    layout: str
    planes: dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def spec(self):
        return SPECS[self.qtype]

    @property
    def device(self) -> torch.device:
        return next(iter(self.planes.values())).device

    @property
    def mm_dims(self) -> tuple[int, int]:
        """(N, K) derived from the plane shapes."""
        assert self.layout == "mm"
        s = self.planes.get("scales")
        if s is None:                       # Q2_K compact layout
            s = self.planes["scd"]
        return s.shape[1], s.shape[0] * self.spec.group

    @property
    def n_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.planes.values())

    def to(self, device) -> "QTensor":
        return QTensor(qtype=self.qtype, shape=self.shape, layout=self.layout,
                       planes={k: v.to(device) for k, v in self.planes.items()})

    @classmethod
    def from_gguf_raw(cls, raw: np.ndarray, qtype: GGMLType,
                      shape: tuple[int, int], layout: str = "mm",
                      device="cpu") -> "QTensor":
        n, k = shape
        fn = repack_mm if layout == "mm" else repack_rows
        planes = fn(raw.reshape(n, -1), qtype, k)
        return cls(qtype=qtype, shape=(n, k), layout=layout,
                   planes={name: plane_from_numpy(p, device)
                           for name, p in planes.items()})

    @staticmethod
    def concat_n(qts: list["QTensor"]) -> "QTensor":
        """Concatenate mm-layout QTensors along N (a plane concat on the
        last axis). Fuses QKV / gate+up projections into one launch."""
        first = qts[0]
        assert all(q.layout == "mm" and q.qtype == first.qtype
                   and q.shape[1] == first.shape[1] for q in qts)
        planes = {name: torch.cat([q.planes[name] for q in qts], dim=-1)
                  for name in first.planes}
        n = sum(q.shape[0] for q in qts)
        return QTensor(qtype=first.qtype, shape=(n, first.shape[1]),
                       layout="mm", planes=planes)

    def slice_n(self, lo: int, hi: int) -> "QTensor":
        """Slice along N (quant blocks run along K, so any N range is
        block-aligned)."""
        assert self.layout == "mm" and 0 <= lo < hi <= self.shape[0]
        planes = {name: p[..., lo:hi].contiguous()
                  for name, p in self.planes.items()}
        return QTensor(qtype=self.qtype, shape=(hi - lo, self.shape[1]),
                       layout="mm", planes=planes)

    def pad_n(self, n_new: int) -> "QTensor":
        """Zero-pad along N. Padded columns dequantize to exactly 0 (their
        scales are 0), so callers slice the matmul output back down."""
        n, k = self.shape
        if n_new == n:
            return self
        assert self.layout == "mm" and n_new > n
        planes = {}
        for name, p in self.planes.items():
            out = torch.zeros((p.shape[0], n_new), dtype=p.dtype,
                              device=p.device)
            out[:, :n] = p
            planes[name] = out
        return QTensor(qtype=self.qtype, shape=(n_new, k), layout="mm",
                       planes=planes)


def unpack_mm_values(planes: dict, qtype: GGMLType, k: int) -> torch.Tensor:
    """mm planes -> integer values (K, N) as int32 (the plain unpack every
    kernel performs per tile, over the whole array)."""
    spec = SPECS[qtype]
    if spec.bits in (4, 5):
        v = planes["qs"].to(torch.int32)                # (K/2, N)
        n = v.shape[1]
        c = v.reshape(k // 256, 128, n)
        vals = torch.cat([c & 0xF, (c >> 4) & 0xF], dim=1).reshape(k, n)
        if spec.bits == 5:
            h = planes["qh"].to(torch.int32).reshape(k // 256, 32, n)
            hb = torch.cat([(h >> t) & 1 for t in range(8)], dim=1)
            vals = vals | (hb.reshape(k, n) << 4)
        return vals
    if spec.bits == 2:
        v = planes["q2"].to(torch.int32)
        v = v.reshape(k // 256, 64, v.shape[1])
        vals = torch.cat([(v >> (2 * t)) & 3 for t in range(4)], dim=1)
        return vals.reshape(k, -1)
    if spec.bits == 8:
        return planes["q8"].to(torch.int32)
    raise ValueError(qtype)


def f16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """int16 tensor of fp16 bit patterns -> f32 values."""
    return bits.view(torch.float16).to(torch.float32)


def mm_scale_planes(planes: dict, qtype: GGMLType):
    """-> (scales (K/g, N) f32, mins | None) from mm planes, decoding
    Q2_K's compact scd/dm form (scale = d*(b&0xF), min = -dmin*(b>>4))."""
    if qtype == GGMLType.Q2_K and "scd" in planes:
        scd = planes["scd"].to(torch.int32)                    # (K/16, N)
        dm = f16_bits_to_f32(planes["dm"])
        ng, n = scd.shape
        dm3 = dm.reshape(ng // 16, 8, n)
        d = torch.repeat_interleave(dm3[:, 0], 16, dim=0)       # (K/16, N)
        dmin = torch.repeat_interleave(dm3[:, 1], 16, dim=0)
        return ((scd & 0xF).to(torch.float32) * d,
                (scd >> 4).to(torch.float32) * (-dmin))
    scales = planes["scales"].to(torch.float32)
    mins = planes["mins"].to(torch.float32) if "mins" in planes else None
    return scales, mins


def dequant_mm(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """mm-layout QTensor -> dense (K, N) tensor (the plain path)."""
    n, k = qt.mm_dims
    spec = qt.spec
    vals = unpack_mm_values(qt.planes, qt.qtype, k).to(torch.float32)
    sc, mn = mm_scale_planes(qt.planes, qt.qtype)
    scales = torch.repeat_interleave(sc, spec.group, dim=0)
    w = (vals - spec.zero) * scales
    if spec.has_min:
        w = w + torch.repeat_interleave(mn, spec.group, dim=0)
    return w.to(dtype)


def unpack_rows_values(planes: dict, qtype: GGMLType, k: int) -> torch.Tensor:
    """rows planes (already gathered: (..., plane_k)) -> int values (..., K)."""
    spec = SPECS[qtype]
    if spec.bits in (4, 5):
        v = planes["qs"].to(torch.int32)
        vals = torch.cat([v & 0xF, (v >> 4) & 0xF], dim=-1)
        if spec.bits == 5:
            h = planes["qh"].to(torch.int32)
            hb = torch.cat([(h >> t) & 1 for t in range(8)], dim=-1)
            vals = vals | (hb << 4)
        return vals
    if spec.bits == 2:
        v = planes["q2"].to(torch.int32)
        return torch.cat([(v >> (2 * t)) & 3 for t in range(4)], dim=-1)
    if spec.bits == 8:
        return planes["q8"].to(torch.int32)
    raise ValueError(qtype)


def gather_dequant_rows(qt: QTensor, idx: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """Gather rows `idx` (any shape) of a rows-layout QTensor -> (..., K).
    The table stays packed on the device; only the gathered rows decode."""
    assert qt.layout == "rows"
    n, k = qt.shape
    spec = qt.spec
    gathered = {name: plane[idx] for name, plane in qt.planes.items()}
    vals = unpack_rows_values(gathered, qt.qtype, k).to(torch.float32)
    scales = torch.repeat_interleave(gathered["scales"].to(torch.float32),
                                     spec.group, dim=-1)
    w = (vals - spec.zero) * scales
    if spec.has_min:
        w = w + torch.repeat_interleave(gathered["mins"].to(torch.float32),
                                        spec.group, dim=-1)
    return w.to(dtype)
