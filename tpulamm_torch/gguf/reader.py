"""GGUF binary reader (mmap-backed, zero-copy tensor views).

Parity with the reference reader gguf_init_from_file (llama.cpp-b2430/ggml.c:
20552-20588: header {magic, version, n_tensors, n_kv}, typed KV metadata,
tensor infos {name, n_dims, ne[], type, offset}, aligned data section) and the
pure-Python gguf-py/gguf/gguf_reader.py.

Tensors are exposed as numpy uint8 views over the mmap (no copies); shapes are
reported in numpy order (row-major, i.e. reversed GGUF `ne`), with quantization
blocks running along the last axis.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field

import numpy as np

from tpulamm_torch.gguf.constants import (GGML_TYPE_SIZES, GGUF_DEFAULT_ALIGNMENT,
                                    GGUF_MAGIC, GGMLType, GGUFValueType)

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.BOOL: np.bool_,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]        # numpy order (reversed ne)
    ggml_type: GGMLType
    offset: int                   # relative to data section start
    n_bytes: int = 0
    data: np.ndarray | None = field(default=None, repr=False)  # uint8 view

    @property
    def ne(self) -> tuple[int, ...]:
        """GGUF/ggml dim order (ne[0] fastest-varying)."""
        return tuple(reversed(self.shape))

    @property
    def n_elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def as_rows(self) -> np.ndarray:
        """uint8 view shaped (n_rows, row_bytes); rows = all leading dims."""
        if self.ggml_type not in GGML_TYPE_SIZES:
            raise ValueError(
                f"tensor {self.name}: quantization type "
                f"{self.ggml_type!r} is not supported (supported: "
                f"{sorted(t.name for t in GGML_TYPE_SIZES)})")
        k = self.shape[-1]
        bs, tb = GGML_TYPE_SIZES[self.ggml_type]
        rb = k // bs * tb
        return self.data.reshape(-1, rb)

    def to_f32(self) -> np.ndarray:
        from tpulamm_torch.quant.formats import dequantize
        k = self.shape[-1]
        out = dequantize(self.as_rows(), self.ggml_type, k)
        return out.reshape(self.shape)


class GGUFReader:
    """Parses a GGUF file; metadata in .metadata, tensors in .tensors."""

    def __init__(self, path: str | os.PathLike, use_mmap: bool = True):
        self.path = os.fspath(path)
        self._file = open(self.path, "rb")
        if use_mmap:
            self._mm: bytes | mmap.mmap = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ)
        else:
            self._mm = self._file.read()
        self._buf = np.frombuffer(self._mm, dtype=np.uint8)
        self._pos = 0

        magic, version = self._unpack("<I"), self._unpack("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: bad GGUF magic 0x{magic:08x}")
        if version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {version}")
        self.version = version

        n_tensors = self._unpack("<q")
        n_kv = self._unpack("<q")

        self.metadata: dict[str, object] = {}
        for _ in range(n_kv):
            key = self._read_str()
            self.metadata[key] = self._read_value(GGUFValueType(self._unpack("<I")))

        self.alignment = int(self.metadata.get("general.alignment",
                                               GGUF_DEFAULT_ALIGNMENT))

        self.tensors: dict[str, GGUFTensorInfo] = {}
        order: list[GGUFTensorInfo] = []
        for _ in range(n_tensors):
            name = self._read_str()
            n_dims = self._unpack("<I")
            ne = [self._unpack("<Q") for _ in range(n_dims)]
            ttype = GGMLType(self._unpack("<I"))
            offset = self._unpack("<Q")
            shape = tuple(reversed(ne)) if ne else (1,)
            info = GGUFTensorInfo(name=name, shape=shape, ggml_type=ttype,
                                  offset=offset)
            self.tensors[name] = info
            order.append(info)

        data_start = self._align(self._pos)
        self.data_offset = data_start
        for info in order:
            if info.ggml_type not in GGML_TYPE_SIZES:
                # valid GGUF type id we don't implement (K-quants beyond
                # Q2_K, IQ*): keep the metadata readable (tokenizer/config
                # tools), fail with a clear error only on data access
                info.n_bytes = 0
                info.data = None
                continue
            bs, tb = GGML_TYPE_SIZES[info.ggml_type]
            if info.shape[-1] % bs != 0:
                raise ValueError(f"tensor {info.name}: inner dim {info.shape[-1]}"
                                 f" not a multiple of block size {bs}")
            info.n_bytes = info.n_elems // bs * tb
            start = data_start + info.offset
            info.data = self._buf[start:start + info.n_bytes]

    # -- binary plumbing ----------------------------------------------------
    def _align(self, pos: int) -> int:
        a = self.alignment
        return (pos + a - 1) // a * a

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        (v,) = struct.unpack_from(fmt, self._mm, self._pos)
        self._pos += size
        return v

    def _read_str(self) -> str:
        n = self._unpack("<Q")
        s = bytes(self._mm[self._pos:self._pos + n])
        self._pos += n
        return s.decode("utf-8", errors="replace")

    def _read_value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self._read_str()
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(self._unpack("<I"))
            n = self._unpack("<Q")
            if etype == GGUFValueType.STRING:
                return [self._read_str() for _ in range(n)]
            if etype == GGUFValueType.ARRAY:
                return [self._read_value(GGUFValueType.ARRAY) for _ in range(n)]
            dt = np.dtype(_SCALAR_NP[etype]).newbyteorder("<")
            arr = np.frombuffer(self._mm, dtype=dt, count=n, offset=self._pos)
            self._pos += int(arr.nbytes)
            return arr
        return self._unpack(_SCALAR_FMT[vtype])

    # -- public helpers ------------------------------------------------------
    def get(self, key: str, default=None):
        return self.metadata.get(key, default)

    def close(self):
        if isinstance(self._mm, mmap.mmap):
            try:
                self._mm.close()
            except BufferError:
                pass  # numpy views still alive; mmap is freed when they die
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
