"""Timing and device labels shared by the port's measurement tools (the
counterpart of the scan-slope timing of tpulamm's bench.py and
tools/decode_roofline.slope_time).

On CUDA: CUDA events around each call and the median of `reps` calls,
after one warm-up call. With `flush`, the 50 MB L2 is overwritten before
each call (a decode step finds every weight cold), and a spin kernel ahead
of the flush keeps the card busy while the host enqueues the call, so a
wrapper's host time does not count as device time. Zeroing the buffer
leaves the L2 full of dirty lines, whose write-back a call that reads
more than the L2 holds pays (up to 50 MB at 3.35 TB/s, ~15 us); `clean`
reads the buffer instead. No scan and no slope:
eager launches need no hoist-proofing. On the CPU (the tests, `--device
cpu`): the host's wall clock, which is no device metric.
"""

from __future__ import annotations

import shutil
import subprocess
import time

import numpy as np
import torch

SPIN_CYCLES = 2_000_000            # ~1 ms of the card's clock
FLUSH_BYTES = 256 << 20            # > the H100's 50 MB L2

_flush_buf: dict = {}


def time_samples(fn, device: torch.device, reps: int = 20,
                 flush: bool = True, clean: bool = False) -> list[float]:
    """ms of each of `reps` calls of fn (CPU: max(2, reps // 10) calls).
    clean: flush the L2 by reading the buffer instead of zeroing it, so
    the call finds it full of clean lines and pays no write-back (as a
    kernel does inside a decode step)."""
    if device.type != "cuda":
        out = []
        for _ in range(max(2, reps // 10)):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    buf = _flush_buf.get(device)
    if flush and buf is None:
        buf = _flush_buf[device] = torch.empty(FLUSH_BYTES // 4,
                                               dtype=torch.float32,
                                               device=device)
    fn()                                                     # warm-up
    ev = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        if flush and clean:
            torch.sum(buf)
        elif flush:
            buf.zero_()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        fn()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize(device)
    return [a.elapsed_time(b) for a, b in ev]


def time_ms(fn, device: torch.device, reps: int = 20,
            flush: bool = True, clean: bool = False) -> float:
    """Median ms of time_samples."""
    return float(np.median(time_samples(fn, device, reps, flush, clean)))


def nvidia_smi() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them, or "not available"."""
    if shutil.which("nvidia-smi") is None:
        return "not available"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return lines[0] if lines else "not available"


def device_label(device: torch.device) -> str:
    """What the numbers of a run were taken on: the card's torch name and
    its nvidia-smi name and power limit, or the CPU."""
    if device.type != "cuda":
        return "cpu (host wall clock: no device metric)"
    return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {nvidia_smi()})"
