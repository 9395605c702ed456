"""Build and load the hand-written CUDA kernels (tpulamm_torch/csrc).

Each source is compiled by its own `nvcc` process into a shared library
with a plain C interface, which ctypes loads. Sources build at first use
into tpulamm_torch/build/; the library name carries a hash of the source
and of every csrc header it includes, so an edited kernel or header is
rebuilt and a stale library is never loaded. `build()` starts every
compile at once and waits for them all.

Every pointer and the stream cross as ctypes.c_void_p (a bare Python int
would be cut to 32 bits); each C function returns cudaGetLastError(), and
`check()` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# library name -> (source file, {C function: argument types})
_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
LIBS: dict[str, tuple[str, dict[str, list]]] = {
    "qmm": ("qmm.cu", {
        "tl_qmm_f32": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    }),
    "qmm_int8": ("qmm_int8.cu", {
        "tl_quantize_acts": [_P, _P, _P, _P, _I, _I, _I, _P],
        "tl_qmm_int8": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _P],        # M N K ks grid
        "tl_qmm_int8_inkq": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
    }),
    "flash_attention": ("flash_attention.cu", {
        "tl_flash": [_I, _I, _P,
                     _P, _I, _L, _L, _L,            # k, type, strides
                     _P, _I, _L, _L, _L,            # v, type, strides
                     _P, _L, _P, _P,                # kpos, stride, qbase, qlen
                     _P, _L, _L, _P, _L, _L,        # ks, strides, vs, strides
                     _I, _I, _I, _I, _I, _I, _F,    # B Hkv TG S G causal scale
                     _I, _I, _P, _P, _P, _P, _P],   # chunking, ws, out, stream
    }),
    "ffn_fused": ("ffn_fused.cu", {
        "tl_ffn_fused_blocks": [_I, _IP],
        "tl_ffn_fused": [_I, _I, _P,
                         _P, _P, _P, _P,                # gate|up planes
                         _P, _P, _P, _P,                # down planes
                         _P, _P, _P, _P,                # mid out partial bar
                         _I, _I, _I, _I, _I, _I, _I, _P],
    }),
    "mega_decode": ("mega_decode.cu", {
        "tl_mega_blocks": [_L, _IP],                    # kmax, &blocks
        "tl_mega_scratch": [_P, _I, _P],                # &MegaArgs, blocks, &n
        "tl_mega_decode": [_P, _I, _P],                 # &MegaArgs, blocks
    }),
    "stream_reduce": ("stream_reduce.cu", {
        "tl_stream_reduce": [_P, _P, _P, _P, _L, _I, _I, _P],
    }),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """The .cu file of library `name`, then every csrc header it includes,
    directly or through another header, in the order first seen."""
    todo, seen = [CSRC / LIBS[name][0]], []
    while todo:
        path = todo.pop(0)
        if path not in seen:
            seen.append(path)
            todo += [CSRC / h for h in _INCLUDE.findall(path.read_text())]
    return seen


def lib_path(name: str) -> Path:
    digest = hashlib.sha1()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet,
    one nvcc process per source, all started together. Returns, for each
    library built, the seconds from the start until its compile was seen
    to finish; compiler output (with ptxas -v) goes to build/<name>.log."""
    names = list(LIBS) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{n}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBS[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                    tmp, out, log)
    failed, secs = [], {}
    for n, (p, tmp, out, log) in procs.items():
        rc = p.wait()
        secs[n] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append(n)
            continue
        os.replace(tmp, out)
    if failed:
        msgs = "\n".join((BUILD_DIR / f"{n}.log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in LIBS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
