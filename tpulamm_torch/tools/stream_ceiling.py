"""The card's practical HBM streaming ceiling (counterpart of
tpulamm.tools.stream_ceiling).

Every speed figure of the port scores bytes against the data sheet's
3.35 TB/s, which no real kernel reaches. This probe measures the best rate
an embarrassingly streamable kernel achieves: a block-wise column sum of a
multi-GB buffer (one read per byte, trivial compute, no writes that
matter), for three tile sizes. A decode step's effective bandwidth is to be
judged against the best of them (tools/decode_roofline.py --bw-gbs).

- `make_reduce(total_rows, cols, block_rows)` returns `run(b, x)`: (8,
  cols) f32, every row b + the column sum of the first
  (total_rows // block_rows) * block_rows rows of x (the tail is skipped).
  On a CUDA tensor it launches csrc/stream_reduce.cu (`LAUNCHES` counts
  those launches and nothing else) or raises; on a CPU tensor it takes
  `reduce_ref`, the plain version.
- `probe(x)` times it at each block size; `main` allocates the buffer on
  the card from a seeded torch.Generator and prints ms, GB/s and the share
  of 3.35 TB/s beside the card's name and power limit.

    python -m tpulamm_torch.tools.stream_ceiling [gb] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import torch

from tpulamm_torch.tools.timing import device_label, time_ms

LAUNCHES = {"stream_reduce": 0}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BLOCK_ROWS = (512, 1024, 2048)
COLS = 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reduce_ref(x: torch.Tensor, b: torch.Tensor, block_rows: int
               ) -> torch.Tensor:
    """Plain version: per-tile column sums, their sum, plus b, as 8 rows."""
    n_tiles = x.shape[0] // block_rows
    tiles = x[:n_tiles * block_rows].reshape(n_tiles, block_rows,
                                             x.shape[1]).sum(1)
    s = b.reshape(1, 1).to(torch.float32) + tiles.sum(0, keepdim=True)
    return s.expand(8, -1).contiguous()


def make_reduce(total_rows: int, cols: int, block_rows: int):
    """run(b, x) for an x of (total_rows, cols) f32 and a one-element b."""
    if cols % 4 != 0:
        raise ValueError(f"cols={cols}: the kernel reads float4 groups, "
                         "cols must be a multiple of 4")
    if block_rows < 1:
        raise ValueError(f"block_rows={block_rows} must be positive")
    n_tiles = total_rows // block_rows

    def run(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != (total_rows, cols) or x.dtype != torch.float32:
            raise ValueError(f"x {tuple(x.shape)} {x.dtype}: need "
                             f"({total_rows}, {cols}) float32")
        if b.numel() != 1:
            raise ValueError("b must hold one value")
        if x.device.type == "cpu":
            return reduce_ref(x, b, block_rows)
        if b.device != x.device:
            raise ValueError(f"x on {x.device}, b on {b.device}: the kernel "
                             "needs both on one CUDA device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("x must be contiguous and 16-byte aligned")
        from tpulamm_torch.ops import kernels
        lib = kernels.library("stream_reduce")
        bf = b.to(torch.float32).reshape(1).contiguous()
        partial = torch.empty((n_tiles, cols), dtype=torch.float32,
                              device=x.device)
        out = torch.empty((8, cols), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        kernels.check(lib.tl_stream_reduce(x.data_ptr(), bf.data_ptr(),
                                           partial.data_ptr(), out.data_ptr(),
                                           n_tiles, block_rows, cols, stream),
                      "stream_reduce")
        LAUNCHES["stream_reduce"] += 1
        return out
    return run


def read_bytes(total_rows: int, cols: int, block_rows: int) -> int:
    """The bytes of x one call reads (whole tiles only)."""
    return total_rows // block_rows * block_rows * cols * 4


def probe(x: torch.Tensor) -> list[dict]:
    """{block_rows, ms, gbs, pct} for each block size: the median of 20
    launches (no L2 flush: the buffer is many times the L2)."""
    b = torch.zeros((1, 1), dtype=torch.float32, device=x.device)
    rows = []
    for br in BLOCK_ROWS:
        run = make_reduce(x.shape[0], x.shape[1], br)
        ms = time_ms(lambda: run(b, x), x.device, flush=False)
        nbytes = read_bytes(x.shape[0], x.shape[1], br)
        rows.append({"block_rows": br, "ms": ms, "gbs": nbytes / ms / 1e6,
                     "pct": 100.0 * nbytes / (ms * 1e-3) / HBM_BYTES_PER_S})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpulamm-torch-stream-ceiling")
    p.add_argument("gb", nargs="?", type=float, default=2.0,
                   help="buffer size in GiB (default 2)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "version and times the host)")
    args = p.parse_args(argv)
    from tpulamm_torch.runtime.engine import resolve_device
    dev = resolve_device(args.device)
    # a multiple of the largest block size, so every probe reads it all
    total_rows = int(args.gb * 2**30 / (COLS * 4)) // BLOCK_ROWS[-1] * \
        BLOCK_ROWS[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((total_rows, COLS), generator=gen, device=dev)
    label = device_label(dev)
    print(f"buffer {total_rows * COLS * 4 / 2**30:.2f} GiB f32 "
          f"({total_rows}x{COLS}) on {label}", flush=True)
    rows = probe(x)
    for r in rows:
        blk_mb = r["block_rows"] * COLS * 4 / 2**20
        print(f"block_rows={r['block_rows']} ({blk_mb:.0f} MB a tile): "
              f"{r['ms']:.4f} ms  {r['gbs']:.1f} GB/s "
              f"({r['pct']:.1f}% of 3.35 TB/s)", flush=True)
    best = max(rows, key=lambda r: r["gbs"])
    print(f"streaming ceiling: {best['gbs']:.1f} GB/s "
          f"({best['pct']:.1f}% of 3.35 TB/s, block_rows="
          f"{best['block_rows']}) on {label}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
