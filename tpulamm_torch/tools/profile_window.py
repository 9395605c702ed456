"""How often torch.profiler loses a decode block's one device-to-host copy:
profile a `decode_batch_fast` block many times, the profile closed right
after the block's synchronize and held open a tail after it, and count
the copies in the profile's device records and at the dispatcher.

    python -m tpulamm_torch.tools.profile_window [--layers 8] [--tries 40]
                                                 [--tails 0,0.05]

The model is LLaMA-7B width (dim 4096, ffn 11008, 32 heads, vocab 32000)
cut to --layers, random Q4_0 blocks from a seed, 4 slots with 128-token
prompts, blocks of 32 steps (the batched bench's shape). The tails take
turns, so a drift of the host reaches each alike. Each line gives a
tail's device-record counts, its misses (profiles with no copy recorded)
and the counts the host asked for (HostDtoH). Needs a GPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def count_dtoh(prof) -> int:
    """Device-to-host copies in a torch.profiler run's device records."""
    return sum(e.count for e in prof.key_averages() if "DtoH" in e.key)


class HostDtoH(TorchDispatchMode):
    """Counts, at the dispatcher, the device-to-host copies the host asks
    for: an op that makes or fills a CPU tensor from a CUDA one, and a
    scalar read of a CUDA tensor. Every such call passes here; a copy
    inside a replayed graph is no call, and only the profiler's device
    records see it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += ins[0].is_cuda
        elif func is torch.ops.aten.copy_.default:
            self.n += (not ins[0].is_cuda) and ins[1].is_cuda
        elif isinstance(out, torch.Tensor) and not out.is_cuda:
            self.n += any(a.is_cuda for a in ins)
        return out


def profile_block(eng, toks: dict, start: dict, n_steps: int,
                  tail: float) -> tuple[int, int]:
    """One profiled block from the slots' start: (copies in the device
    records, copies the host asked for)."""
    from torch.profiler import ProfilerActivity, profile
    for s in toks:
        eng.rollback(s, start[s])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        with HostDtoH() as host:
            eng.decode_batch_fast(toks, n_steps)
        torch.cuda.synchronize()
        if tail:
            time.sleep(tail)
    return count_dtoh(prof), host.n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--tries", type=int, default=40,
                    help="profiles a tail")
    ap.add_argument("--tails", default="0,0.05",
                    help="seconds the profile stays open after the block")
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_window: needs a GPU", file=sys.stderr)
        return 1
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.tools.synth import write_llama_gguf
    from tpulamm_torch.tools.timing import device_label
    device = torch.device("cuda")
    print(f"device: {device_label(device)}")
    tails = [float(t) for t in args.tails.split(",")]
    got = {t: [] for t in tails}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.gguf")
        write_llama_gguf(path, args.layers, np.random.default_rng(5),
                         dim=4096, ffn=11008, n_head=32, vocab=32000)
        eng = Engine(path, n_slots=4, n_ctx=512, device=device)
        rng = np.random.default_rng(0)
        for s in range(4):
            eng.prefill(s, list(rng.integers(3, 31000, 128)))
        toks = {s: 2 for s in range(4)}
        eng.decode_batch_fast(toks, args.steps)     # captures the graph
        start = {s: int(eng.n_past[s]) - args.steps for s in toks}
        for _ in range(args.tries):
            for t in tails:
                got[t].append(profile_block(eng, toks, start, args.steps, t))
        del eng
    for t in tails:
        dev = [d for d, _ in got[t]]
        host = sorted({h for _, h in got[t]})
        print(f"tail {t} s: {sum(d == 0 for d in dev)} of {len(dev)} "
              f"profiles recorded no copy; device records {dev}; host "
              f"asked for {host} a block of {args.steps} steps "
              f"({args.layers} layers, 4 slots)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
