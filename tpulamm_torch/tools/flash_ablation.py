"""Where the time of the flash kernels goes: build copies of
csrc/flash_attention.cu with one step of a kernel removed and
time them beside the source as it is, on the card, at the long-context
path's shapes (B = 1, Hkv = 32, hd = 128, G = 1, S = 16385; prefill at
T = 512, decode at T = 1; q8 and bf16 K/V).

    python -m tpulamm_torch.tools.flash_ablation

The ablated kernels compute wrong results; only their times are read.
Each build runs in its own nvcc process, all at once; the times are the
median of 20 launches with the L2 flushed (tools/timing.py), in the order
as-is, ablations, ablations reversed, as-is, and each line gives both
readings. Needs a GPU.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from tpulamm_torch.ops import flash_attention as FA
from tpulamm_torch.ops import kernels
from tpulamm_torch.tools.timing import device_label, time_ms

# name -> (what is removed, [(text in the source, replacement)])
ABLATIONS = {
    "no_convert": ("the int8 -> bf16 conversion of K and V tiles", [
        ("if constexpr (VQ8) p_convert<HD>(slot + L::O_V, sm + L::O_VC, tid);",
         ""),
        ("          p_convert<HD>(ring + ((i + 1) % ST) * L::SLOT + L::O_K,\n"
         "                        sm + L::O_KC, tid);", "          ;")]),
    "no_exp": ("the exponentials of the softmax", [
        ("p[e] = ex2(s[4 * j + e] - (e < 2 ? muA : muB));",
         "p[e] = s[4 * j + e] - (e < 2 ? muA : muB);")]),
    "no_pv": ("the PV products", [
        ("for (int u = 0; u < P_BN / 16; ++u)\n        wgmma_pv",
         "for (int u = 0; u < 0; ++u)\n        wgmma_pv")]),
    "decode_loads_only": ("the decode kernel's products and softmax (its "
                          "loads, waits and fold remain)", [
        ("for (int u = split; u < D_BN / 16; u += nsplit) {",
         "for (int u = split; u < 0; u += nsplit) {")]),
}
SHAPES = [("flash_attention", 512, "q8"), ("flash_attention", 512, "bf16"),
          ("flash_decode", 1, "q8"), ("flash_decode", 1, "bf16")]


def ablated_sources(lib: str, subs) -> dict[str, str]:
    """The source of library `lib` and the csrc headers it includes, by
    file name, with each (text, replacement) of `subs` made in the files
    that hold the text."""
    texts = {p.name: p.read_text() for p in kernels.sources(lib)}
    for old, new in subs:
        hit = [f for f, t in texts.items() if old in t]
        if not hit:
            raise RuntimeError(f"{lib}: the source no longer holds {old!r}")
        for f in hit:
            texts[f] = texts[f].replace(old, new)
    return texts


def build(names, ablations=None, lib: str = "flash_attention"
          ) -> dict[str, ctypes.CDLL]:
    """as_is and each named ablation of library `lib` (default: this
    tool's kernels and ABLATIONS) as a library of its own under build/:
    the ablated sources written to a directory of the ablation and
    compiled there, one nvcc process each, all at once."""
    ablations = ABLATIONS if ablations is None else ablations
    procs = {}
    for name in names:
        d = kernels.BUILD_DIR / f"ablate_{lib}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        subs = ablations.get(name, ("", []))[1]
        for f, t in ablated_sources(lib, subs).items():
            (d / f).write_text(t)
        so = d / f"lib{lib}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(d), "-o",
               str(so), str(d / kernels.LIBS[lib][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (p, so) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        (so.parent / "nvcc.log").write_text(out)
        dll = ctypes.CDLL(str(so))
        for fn, argtypes in kernels.LIBS[lib][1].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = ctypes.c_int
        libs[name] = dll
    return libs


def inputs(T: int, kind: str, device, S: int = 16385, Hkv: int = 32,
           hd: int = 128, seed: int = 0) -> dict:
    """One batch row: cells 0..S-2 live at positions 0..S-2, the trash
    cell empty, the T queries at the last T positions."""
    g = torch.Generator(device=device).manual_seed(seed)
    kpos = torch.arange(S, dtype=torch.int32, device=device)[None].clone()
    kpos[0, -1] = -1
    c = {"q": torch.randn((1, Hkv, T, hd), generator=g, device=device),
         "kpos": kpos,
         "qbase": torch.tensor([S - 1 - T], dtype=torch.int32, device=device),
         "qlen": torch.tensor([T], dtype=torch.int32, device=device),
         "ks": None, "vs": None}
    if kind == "q8":
        for n in ("k", "v"):
            c[n] = torch.randint(-127, 128, (1, Hkv, S, hd), generator=g,
                                 device=device, dtype=torch.int8)
            c[n + "s"] = 0.005 + 0.015 * torch.rand((1, Hkv, S), generator=g,
                                                    device=device)
    else:
        for n in ("k", "v"):
            c[n] = torch.randn((1, Hkv, S, hd), generator=g, device=device,
                               dtype=torch.bfloat16)
    return c


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: needs a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"device: {device_label(device)}")
    names = ["as_is", *ABLATIONS]
    libs = build(names)
    order = names + names[:0:-1] + names[:1]
    for kernel, T, kind in SHAPES:
        c = inputs(T, kind, device)
        fn = getattr(FA, kernel)
        kw = dict(scale=float(1.0 / np.sqrt(128)), g=1)
        got = {}
        for name in order:
            kernels._loaded["flash_attention"] = libs[name]
            got.setdefault(name, []).append(time_ms(
                lambda: fn(c["q"], c["k"], c["v"], c["kpos"], c["qbase"],
                           c["qlen"], c["ks"], c["vs"], **kw), device))
        kernels._loaded.pop("flash_attention")
        print(f"{kernel} {kind} T={T} S=16385 (ms): " + " | ".join(
            f"{n} {np.mean(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
            for n, v in got.items()), flush=True)
    for name, (what, _) in ABLATIONS.items():
        print(f"{name}: without {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
