"""Where the time of the flash kernels goes: build copies of
csrc/flash_attention.cu with one step of a kernel removed, or built
another way, and time them beside the source as it is, on the card, at
the long-context path's shapes: at --hd 128 (the default) B = 1,
Hkv = 32, G = 1, S = 16385; at --hd 256 Gemma-7B's B = 1, Hkv = 16,
G = 1, S = 8193 and a Gemma-2B decode (Hkv = 1, G = 8). Prefill at
T = 512, decode at T = 1; q8 and bf16 K/V.

    python -m tpulamm_torch.tools.flash_ablation [--hd 128|256]

The ablated kernels compute wrong results; only their times are read.
`legacy_256` is not an ablation: built with TL_FLASH_LEGACY_256 it runs
head dim 256 on the older mma.sync body, as before the hd-256 kernels
(the "before" of their times; at other head dims it equals as-is).
Each build runs in its own nvcc process, all at once; the times are the
median of 20 launches with the L2 flushed (tools/timing.py), in the order
as-is, variants, variants reversed, as-is, and each line gives both
readings. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from tpulamm_torch.ops import flash_attention as FA
from tpulamm_torch.ops import kernels
from tpulamm_torch.tools.flash_times import inputs
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
        ("for (int u = 0; u < BN / 16; ++u)\n        wgmma_pv",
         "for (int u = 0; u < 0; ++u)\n        wgmma_pv")]),
    "decode_loads_only": ("the decode kernel's products and softmax (its "
                          "loads, waits and fold remain)", [
        ("for (int u = split; u < D_BN / 16; u += nsplit) {",
         "for (int u = split; u < 0; u += nsplit) {")]),
    "no_combine": ("flash_decode's combine of the chunks' partials", [
        ("  return (int)combine(acc_ws, m_ws, l_ws, out, n_chunks, B, Hkv, "
         "TG, hd, st);\n}", "  return 0;\n}")]),
    "prefill_whole": ("the prefill's parts: each row block walks all its "
                      "live tiles", [
        ("new_body(hd, a) && hd == P_PARTS_HD && n_chunks > 1 ? n_chunks : 1;",
         "1;")]),
}
# builds made with a define rather than an edit: name -> (what, nvcc flags)
VARIANTS = {
    "legacy_256": ("head dim 256 on the older body (legacy::flash_kernel)",
                   ["-DTL_FLASH_LEGACY_256"]),
}
# head dim -> [(kernel, T, kind, Hkv, G, S)]
SHAPES = {
    128: [("flash_attention", 512, "q8", 32, 1, 16385),
          ("flash_attention", 512, "bf16", 32, 1, 16385),
          ("flash_decode", 1, "q8", 32, 1, 16385),
          ("flash_decode", 1, "bf16", 32, 1, 16385)],
    256: [("flash_attention", 512, "q8", 16, 1, 8193),
          ("flash_attention", 512, "bf16", 16, 1, 8193),
          ("flash_decode", 1, "q8", 16, 1, 8193),
          ("flash_decode", 1, "bf16", 16, 1, 8193),
          ("flash_decode", 1, "q8", 1, 8, 8193)],
}


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


def build(names, ablations=None, lib: str = "flash_attention",
          variants=None) -> dict[str, ctypes.CDLL]:
    """as_is and each named ablation of library `lib` (default: this
    tool's kernels and ABLATIONS) as a library of its own under build/:
    the ablated sources written to a directory of the ablation and
    compiled there, one nvcc process each, all at once; a name of
    `variants` (default: VARIANTS when lib is this tool's) compiles the
    source as it is with its extra nvcc flags."""
    ablations = ABLATIONS if ablations is None else ablations
    if variants is None:
        variants = VARIANTS if lib == "flash_attention" else {}
    procs = {}
    for name in names:
        d = kernels.BUILD_DIR / f"ablate_{lib}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        subs = ablations.get(name, ("", []))[1]
        for f, t in ablated_sources(lib, subs).items():
            (d / f).write_text(t)
        so = d / f"lib{lib}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS,
               *variants.get(name, ("", []))[1], "-I", str(d), "-o",
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flash_ablation")
    ap.add_argument("--hd", type=int, default=128, choices=sorted(SHAPES),
                    help="head dim of the shapes timed (default 128)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ablation: needs a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"device: {device_label(device)}")
    names = ["as_is", *ABLATIONS, *VARIANTS]
    libs = build(names)
    order = names + names[:0:-1] + names[:1]
    for kernel, T, kind, Hkv, G, S in SHAPES[args.hd]:
        c = inputs(T, kind, device, S=S, Hkv=Hkv, hd=args.hd, G=G)
        fn = getattr(FA, kernel)
        kw = dict(scale=float(1.0 / np.sqrt(args.hd)), g=G)
        got = {}
        for name in order:
            kernels._loaded["flash_attention"] = libs[name]
            FA._residency.cache_clear()         # each build's own kernel
            got.setdefault(name, []).append(time_ms(
                lambda: fn(c["q"], c["k"], c["v"], c["kpos"], c["qbase"],
                           c["qlen"], c["ks"], c["vs"], **kw), device))
        kernels._loaded.pop("flash_attention")
        FA._residency.cache_clear()
        print(f"{kernel} {kind} hd={args.hd} Hkv={Hkv} G={G} T={T} S={S} "
              "(ms): " + " | ".join(
                  f"{n} {np.mean(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
                  for n, v in got.items()), flush=True)
    for name, (what, _) in ABLATIONS.items():
        print(f"{name}: without {what}")
    for name, (what, _) in VARIANTS.items():
        print(f"{name}: {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
