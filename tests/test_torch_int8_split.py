"""The work split of the int8 gemv (ops/qmm.py int8_plan, _gemv_scratch)
on the CPU, against a model of csrc/qmm_int8.cu's loops (qmm_int8_kernel,
Geo, Unit, Walk): block b takes units b, b + grid, ...; unit u is column
group p = u % groups (tiles 8p .. 8p + 7) over chunks [kch r / ks,
kch (r + 1) / ks) of K range r = u / groups; warp w takes every step of
tile 8p + w, if there is one. At the five LLaMA-7B projections and the
tests' small shapes, at M = 1, 8 and 16, every (column tile, step)
position is covered exactly once, each unit's window fits, and the
scratch holds what the C entry reads."""

from collections import Counter

import pytest
import torch

from tpulamm_torch.ops import qmm as Q

SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096), "gate_up": (22016, 4096),
          "down": (4096, 11008), "lm_head": (32768, 4096),
          "small": (1024, 768), "one_chunk": (128, 256)}
SMS = 132                                   # H100 SXM


def covered(n, k, ks, grid, spc):
    """(tile, step) -> times the kernel's loops visit it; the largest
    unit's chunks; units a block takes, at least and at most."""
    tiles, kch = n // 128, k // 256
    groups = -(-tiles // Q.INT8_GROUP_TILES)
    seen, widest, per_block = Counter(), 0, []
    for b in range(grid):
        units = range(b, groups * ks, grid)
        per_block.append(len(units))
        for u in units:
            r, p = divmod(u, groups)
            c0, c1 = kch * r // ks, kch * (r + 1) // ks
            widest = max(widest, c1 - c0)
            for w in range(8):
                tile = 8 * p + w
                if tile < tiles:
                    for s in range(spc * c0, spc * c1):
                        seen[(tile, s)] += 1
    return seen, widest, (min(per_block), max(per_block))


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("label", list(SHAPES))
@pytest.mark.parametrize("spc", [4, 8])        # steps a chunk: Q4/Q5/Q2_K, Q8_0
def test_every_position_once(label, m, spc):
    n, k = SHAPES[label]
    ks, grid = Q.int8_plan(m, n, k, SMS)
    assert 1 <= grid <= SMS and 1 <= ks <= k // 256
    seen, widest, (lo, hi) = covered(n, k, ks, grid, spc)
    assert len(seen) == (n // 128) * (k // 256) * spc
    assert set(seen.values()) == {1}
    assert widest <= Q.INT8_WIN_CHUNKS[Q.int8_rows(m)]
    assert hi - lo <= 1                        # the waves are spread evenly


@pytest.mark.parametrize("m", [1, 2, 8, 9, 16])
@pytest.mark.parametrize("label", ["down", "lm_head", "small"])
def test_scratch_is_what_the_entry_reads(label, m):
    n, k = SHAPES[label]
    x = torch.zeros((m, k))
    ks, grid, out, partial, cnt = Q._gemv_scratch(x, n, k, m, SMS)
    assert (ks, grid) == Q.int8_plan(m, n, k, SMS)
    assert out.shape == (m, n) and out.dtype == torch.float32
    if ks > 1:
        assert partial.shape == (ks, m, n) and partial.dtype == torch.float32
    else:
        assert partial is out
    assert cnt.dtype == torch.int32 and cnt.numel() >= n // 128
    assert not cnt.any()


def test_rows_a_launch_carries():
    assert [Q.int8_rows(m) for m in range(1, 17)] == [1] + [8] * 7 + [16] * 8
