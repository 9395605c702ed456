"""The host codec: ggml block quantize / dequantize in C++ (csrc/tl_codec.cpp)
over a thread pool of rows, bound with ctypes (counterpart of
tpulamm.quant.native, without its repack entry points: the port's loader
repacks in quant.repack).

The source is built at first use with g++ into tpulamm_torch/build/; the
library name carries a hash of the source and of the flags, and a build
writes a file of its own and renames it into place, so processes that
build at once never load a half-written library. The flags leave out
-ffast-math and turn off FP contraction: the bytes depend on IEEE
rounding. A failed build raises with the compiler's message. There is no
quiet fallback: the numpy quantizers of quant.formats are the plain
versions the tests hold the codec to, and nothing else calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from tpulamm_torch.gguf.constants import GGML_TYPE_SIZES, GGMLType
from tpulamm_torch.ops.kernels import BUILD_DIR, CSRC

SOURCE = CSRC / "tl_codec.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared",
             "-ffp-contract=off"]

CODEC_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
               GGMLType.Q8_0, GGMLType.Q8_1, GGMLType.Q2_K, GGMLType.Q8_K)

_lib: ctypes.CDLL | None = None


def lib_path():
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtl_codec-{digest.hexdigest()[:12]}.so"


def build() -> None:
    """Compile the codec unless the library of this source is built."""
    out = lib_path()
    if out.exists():
        return
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host codec (csrc/tl_codec.cpp) "
                           "needs a C++ compiler (set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded codec, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(lib_path()))
        for fn in (lib.tl_quantize, lib.tl_dequantize):
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _threads() -> int:
    return os.cpu_count() or 1


def _check(qtype: GGMLType, k: int) -> tuple[int, int]:
    if qtype not in CODEC_TYPES:
        raise ValueError(f"the codec has no {qtype!r} (it codes "
                         f"{[t.name for t in CODEC_TYPES]})")
    bs, tb = GGML_TYPE_SIZES[qtype]
    if k % bs:
        raise ValueError(f"last dim {k} not a multiple of {bs}")
    return bs, tb


def quantize(x: np.ndarray, qtype: GGMLType) -> np.ndarray:
    """f32 (..., k) -> raw bytes (..., k // block * block_bytes)."""
    x = np.ascontiguousarray(x, np.float32)
    k = x.shape[-1]
    bs, tb = _check(qtype, k)
    rows = x.reshape(-1, k)
    out = np.empty((rows.shape[0], k // bs * tb), np.uint8)
    rc = library().tl_quantize(int(qtype), rows.ctypes.data,
                               out.ctypes.data, rows.shape[0], k, _threads())
    if rc != 0:
        raise RuntimeError(f"tl_quantize({qtype.name}) returned {rc}")
    return out.reshape(*x.shape[:-1], -1)


def dequantize(raw: np.ndarray, qtype: GGMLType, k: int) -> np.ndarray:
    """raw bytes (..., row_bytes) -> f32 (..., k)."""
    bs, tb = _check(qtype, k)
    rows = np.ascontiguousarray(raw, np.uint8).reshape(-1, k // bs * tb)
    out = np.empty((rows.shape[0], k), np.float32)
    rc = library().tl_dequantize(int(qtype), rows.ctypes.data,
                                 out.ctypes.data, rows.shape[0], k, _threads())
    if rc != 0:
        raise RuntimeError(f"tl_dequantize({qtype.name}) returned {rc}")
    return out.reshape(*raw.shape[:-1], k)
