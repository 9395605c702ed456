"""GGUF binary writer (v3).

Parity with the reference writer API in ggml.c (gguf_set_val_*, gguf_add_tensor,
gguf_write_to_file — ggml.c:21000-21300) and gguf-py/gguf/gguf_writer.py. Used
by the quantize tool and by tests to synthesize models.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

from tpulamm_torch.gguf.constants import (GGML_TYPE_SIZES, GGUF_DEFAULT_ALIGNMENT,
                                    GGUF_MAGIC, GGUF_VERSION, GGMLType,
                                    GGUFValueType)


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B", GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H", GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I", GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f", GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q", GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def _infer_vtype(v) -> GGUFValueType:
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return GGUFValueType.BOOL
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        if iv < 0:
            return GGUFValueType.INT32 if iv >= -(2**31) else GGUFValueType.INT64
        return GGUFValueType.UINT32 if iv < 2**32 else GGUFValueType.UINT64
    if isinstance(v, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF type for {type(v)}")


_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
    np.dtype(np.bool_): GGUFValueType.BOOL,
}


class GGUFWriter:
    def __init__(self, path: str, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, object]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, np.ndarray]] = []

    # -- metadata -------------------------------------------------------------
    def add_kv(self, key: str, value, vtype: GGUFValueType | None = None):
        if vtype is None:
            vtype = _infer_vtype(value)
        self._kv.append((key, vtype, value))

    def add_typed(self, key: str, value, vtype: GGUFValueType):
        self._kv.append((key, vtype, value))

    # -- tensors ----------------------------------------------------------------
    def add_tensor(self, name: str, data: np.ndarray,
                   shape: Sequence[int] | None = None,
                   ggml_type: GGMLType | None = None):
        """Add a tensor.

        If `data` is float32/float16 and ggml_type is None, stores it as-is.
        For quantized payloads pass raw uint8 `data` plus logical `shape` and
        `ggml_type`.
        """
        if ggml_type is None:
            if data.dtype == np.float32:
                ggml_type = GGMLType.F32
            elif data.dtype == np.float16:
                ggml_type = GGMLType.F16
            else:
                raise TypeError("pass ggml_type for non-float tensors")
            shape = data.shape
            payload = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        else:
            payload = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
            if shape is None:
                raise ValueError("quantized tensors need an explicit shape")
        shape = tuple(int(s) for s in shape)
        bs, tb = GGML_TYPE_SIZES[ggml_type]
        expect = int(np.prod(shape)) // bs * tb
        if payload.nbytes != expect:
            raise ValueError(f"{name}: payload {payload.nbytes}B != expected "
                             f"{expect}B for {ggml_type.name} {shape}")
        self._tensors.append((name, shape, ggml_type, payload))

    # -- serialization ---------------------------------------------------------
    def _write_value(self, out, vtype: GGUFValueType, v):
        out.append(struct.pack("<I", int(vtype)))
        self._write_raw_value(out, vtype, v)

    def _write_raw_value(self, out, vtype: GGUFValueType, v):
        if vtype == GGUFValueType.STRING:
            out.append(_pack_str(v))
        elif vtype == GGUFValueType.ARRAY:
            if isinstance(v, np.ndarray):
                etype = _NP_TO_VTYPE[v.dtype]
                out.append(struct.pack("<IQ", int(etype), v.size))
                out.append(np.ascontiguousarray(v).tobytes())
            else:
                etype = (_infer_vtype(v[0]) if len(v) else GGUFValueType.UINT32)
                # promote mixed int arrays conservatively
                if etype in (GGUFValueType.UINT32, GGUFValueType.INT32) and \
                        any(isinstance(e, (int, np.integer)) and int(e) < 0 for e in v):
                    etype = GGUFValueType.INT32
                out.append(struct.pack("<IQ", int(etype), len(v)))
                for e in v:
                    self._write_raw_value(out, etype, e)
        else:
            out.append(struct.pack(_SCALAR_FMT[vtype], v))

    def write(self):
        out: list[bytes] = []
        out.append(struct.pack("<IIqq", GGUF_MAGIC, GGUF_VERSION,
                               len(self._tensors), len(self._kv)))
        for key, vtype, v in self._kv:
            out.append(_pack_str(key))
            self._write_value(out, vtype, v)

        # tensor infos with running aligned offsets
        offset = 0
        offsets = []
        for name, shape, ttype, payload in self._tensors:
            offsets.append(offset)
            offset += payload.nbytes
            offset = (offset + self.alignment - 1) // self.alignment * self.alignment
        for (name, shape, ttype, payload), off in zip(self._tensors, offsets):
            ne = tuple(reversed(shape))
            out.append(_pack_str(name))
            out.append(struct.pack("<I", len(ne)))
            out.append(struct.pack(f"<{len(ne)}Q", *ne))
            out.append(struct.pack("<IQ", int(ttype), off))

        header = b"".join(out)
        pad = (-len(header)) % self.alignment

        with open(self.path, "wb") as f:
            f.write(header)
            f.write(b"\x00" * pad)
            pos = 0
            for (name, shape, ttype, payload), off in zip(self._tensors, offsets):
                f.write(b"\x00" * (off - pos))
                f.write(payload.tobytes())
                pos = off + payload.nbytes
