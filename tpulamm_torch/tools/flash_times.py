"""The flash wrappers' times at the long-context shapes of head dims 64
and 128, as the tpulamm_torch on sys.path builds them: one line a shape,
the median ms of 20 launches with the L2 flushed (tools/timing.py), and
a digest of the output's bytes.

    python -m tpulamm_torch.tools.flash_times

It calls only the wrappers and tools/timing.py, which an older checkout
has too, so two checkouts compare on one card: run this file from each in
turn (`PYTHONPATH=CHECKOUT python tpulamm_torch/tools/flash_times.py`),
in the order a, b, b, a; equal digests are equal bits. Needs a GPU.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from tpulamm_torch.ops import flash_attention as FA
from tpulamm_torch.tools.timing import device_label, time_ms

# (kernel, hd, Hkv, G, T, S), each in q8 and bf16: LLaMA-7B at 16k (32 KV
# heads), 32 query heads over 8 KV heads (Mistral-7B), 64 over 8
# (LLaMA-2-70B), TinyLlama's 32 over 4 at hd 64; the LLaMA-7B prefill
SHAPES = [("flash_decode", 128, 32, 1, 1, 16385),
          ("flash_decode", 128, 8, 4, 1, 16385),
          ("flash_decode", 128, 8, 8, 1, 8193),
          ("flash_decode", 64, 4, 8, 1, 8193),
          ("flash_attention", 128, 32, 1, 512, 16385)]
KINDS = ("q8", "bf16")


def inputs(T: int, kind: str, device, S: int = 16385, Hkv: int = 32,
           hd: int = 128, seed: int = 0, G: int = 1) -> dict:
    """One batch row: cells 0..S-2 live at positions 0..S-2, the trash
    cell empty, the T queries (G rows each) at the last T positions."""
    g = torch.Generator(device=device).manual_seed(seed)
    kpos = torch.arange(S, dtype=torch.int32, device=device)[None].clone()
    kpos[0, -1] = -1
    c = {"q": torch.randn((1, Hkv, T * G, hd), generator=g, device=device),
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


def run(kernel: str, c: dict, hd: int, G: int) -> torch.Tensor:
    return getattr(FA, kernel)(c["q"], c["k"], c["v"], c["kpos"], c["qbase"],
                               c["qlen"], c["ks"], c["vs"],
                               scale=float(1.0 / np.sqrt(hd)), g=G)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()[:12]


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("flash_times: needs a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"device: {device_label(device)}")
    for kernel, hd, Hkv, G, T, S in SHAPES:
        for kind in KINDS:
            c = inputs(T, kind, device, S=S, Hkv=Hkv, hd=hd, G=G)
            ms = time_ms(lambda: run(kernel, c, hd, G), device)
            print(f"{kernel} {kind} hd={hd} Hkv={Hkv} G={G} T={T} S={S}: "
                  f"{ms:.4f} ms, digest {digest(run(kernel, c, hd, G))}",
                  flush=True)
            del c
    return 0


if __name__ == "__main__":
    sys.exit(main())
