"""The work split of the fused FFN (ops/ffn_fused.py ffn_plan, _scratch)
on the CPU, against a model of csrc/ffn_fused.cu's loops (Win, Cursor,
ffn_phase, slot_sum): block b takes window v = ((b + 1) nwin - 1) / blocks,
whose chunks are [kch v / nwin, kch (v + 1) / nwin) and blocks [blocks v /
nwin, blocks (v + 1) / nwin); the window's positions (group, chunk, step),
group first, are cut into min(its blocks, positions) equal ranges; warp w
of a block takes every step of tile 8p + w (columns 1024p + 128w ..) where
the product has them.
At the LLaMA-7B and TinyLlama-1.1B FFNs and the tests' small ones, at
M = 1, 4, 8 and 16, every (column tile, step) position of both phases is
covered exactly once, each range's window fits, the sums' slots are
distinct, the slots the combine adds for a group are the blocks that
write them, and the scratch holds what the C entry reads."""

from collections import Counter, defaultdict

import pytest
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import ffn_fused as F

SHAPES = {"llama7b": (4096, 11008), "tinyllama": (2048, 5632),
          "small": (512, 768), "tiny": (256, 512)}
SMS = 132                                   # H100 SXM: one block an SM
MS = [1, 4, 8, 16]
# 4 steps a chunk and the largest windows; the smallest windows; 8 steps
FORMATS = [GGMLType.Q4_0, GGMLType.Q5_1, GGMLType.Q8_0]


def phase_geo(plan, dim, ffn, phase):
    """(groups, K chunks, windows, has_tile(p, w)) of a phase."""
    if phase == "a":
        return (plan["groups_a"], dim // 256, plan["nwin_a"],
                lambda p, w: 1024 * p + 128 * w < 2 * ffn)
    return (plan["groups_b"], ffn // 256, plan["nwin_b"],
            lambda p, w: 1024 * p + 128 * w < dim)


def window(kch, groups, nwin, blocks, spc, v):
    c0, c1 = kch * v // nwin, kch * (v + 1) // nwin
    b0, b1 = blocks * v // nwin, blocks * (v + 1) // nwin
    line = spc * (c1 - c0)
    length = groups * line
    return c0, c1, b0, line, length, min(b1 - b0, length)


def block_at(pos, length, nbk):
    """csrc/ffn_fused.cu Win::block_at."""
    return ((pos + 1) * nbk + length - 1) // length - 1


def staged(c0, c1, line, spc, p0, p1):
    """The chunks the range [p0, p1) stages (ffn_phase's Span): its own
    within one group, a group's last chunks and the next one's first, or
    else the whole window."""
    (pf, rf), (pl, rl) = divmod(p0, line), divmod(p1 - 1, line)
    cf, cl = c0 + rf // spc, c0 + rl // spc
    if pf == pl:
        return list(range(cf, cl + 1))
    if pl == pf + 1 and cl < cf:
        return list(range(cf, c1)) + list(range(c0, cl + 1))
    return list(range(c0, c1))


def walk(m, dim, ffn, blocks, qtype, phase):
    """The kernel's loops: (tile, chunk, step) -> visits; slot -> the
    (block, group) pairs that write it; group -> blocks whose range meets
    it; group -> the slots ffn_combine adds; the widest window a range
    stages."""
    plan = F.ffn_plan(m, dim, ffn, blocks, qtype, qtype)
    spc = F.steps_per_chunk(qtype)
    groups, kch, nwin, has_tile = phase_geo(plan, dim, ffn, phase)
    seen, writers, meets = Counter(), defaultdict(set), defaultdict(set)
    widest = 0
    for b in range(blocks):
        v = ((b + 1) * nwin - 1) // blocks
        c0, c1, b0, line, length, nbk = window(kch, groups, nwin, blocks,
                                               spc, v)
        assert b0 <= b < blocks * (v + 1) // nwin
        i = b - b0
        if i >= nbk:
            continue
        p0, p1 = length * i // nbk, length * (i + 1) // nbk
        assert p0 < p1                               # no empty range
        span = staged(c0, c1, line, spc, p0, p1)
        widest = max(widest, len(span))
        for pos in range(p0, p1):
            p, r = divmod(pos, line)
            c, s = c0 + r // spc, r % spc
            assert c in span
            assert block_at(pos, length, nbk) == i
            meets[p].add(b)
            writers[b0 + i + v * groups + p].add((b, p))
            for w in range(8):
                if has_tile(p, w):
                    seen[(8 * p + w, c, s)] += 1
    added = {}
    for p in range(groups):
        added[p] = []
        for v in range(nwin):
            c0, _, b0, line, length, nbk = window(kch, groups, nwin, blocks,
                                                  spc, v)
            lo = block_at(p * line, length, nbk)
            hi = block_at((p + 1) * line - 1, length, nbk)
            added[p] += [b0 + i + v * groups + p for i in range(lo, hi + 1)]
    return plan, seen, writers, meets, added, widest


@pytest.mark.parametrize("phase", ["a", "b"])
@pytest.mark.parametrize("qtype", FORMATS, ids=lambda q: q.name)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("label", list(SHAPES))
def test_every_position_once(label, m, qtype, phase):
    dim, ffn = SHAPES[label]
    plan, seen, writers, meets, added, widest = walk(m, dim, ffn, SMS, qtype,
                                                     phase)
    spc = F.steps_per_chunk(qtype)
    groups, kch, _, has_tile = phase_geo(plan, dim, ffn, phase)
    tiles = [8 * p + w for p in range(groups) for w in range(8)
             if has_tile(p, w)]
    assert len(seen) == len(tiles) * kch * spc
    assert set(seen.values()) == {1}
    assert {t for t, _, _ in seen} == set(tiles)
    assert widest <= F.window_chunks(qtype, plan["rows"])
    # a slot holds one block's sums for one group, within the scratch
    assert all(len(ws) == 1 for ws in writers.values())
    assert max(writers) < plan["slots"]
    # the combine adds, for each group, the slots its blocks wrote, in K
    # order (window by window, block by block)
    for p in range(groups):
        assert sorted(added[p]) == added[p]
        assert {b for s in added[p] for b, q in writers[s] if q == p} == meets[p]
        assert all(writers[s] == {(b, p) for b, q in writers[s]}
                   for s in added[p])


@pytest.mark.parametrize("label", list(SHAPES))
def test_tiles_cover_the_columns_once(label):
    """Tile 8p + w holds columns 1024p + 128w .. + 128 of its product
    (phase A: the 2 ffn gate | up columns)."""
    dim, ffn = SHAPES[label]
    plan = F.ffn_plan(1, dim, ffn, SMS)
    for n, groups in ((2 * ffn, plan["groups_a"]), (dim, plan["groups_b"])):
        cols = Counter(1024 * p + 128 * w + j for p in range(groups)
                       for w in range(8) if 1024 * p + 128 * w < n
                       for j in range(128))
        assert sorted(cols) == list(range(n)) and set(cols.values()) == {1}


@pytest.mark.parametrize("m", [1, 2, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("label", list(SHAPES))
def test_scratch_is_what_the_entry_reads(label, m):
    dim, ffn = SHAPES[label]
    plan = F.ffn_plan(m, dim, ffn, SMS)
    assert plan["rows"] == F.ffn_rows(m) >= m
    for nwin, k in ((plan["nwin_a"], dim), (plan["nwin_b"], ffn)):
        assert 1 <= nwin <= min(SMS, k // 256)
    assert plan["slots"] == SMS + max(plan["nwin_a"] * plan["groups_a"],
                                      plan["nwin_b"] * plan["groups_b"])
    x = torch.zeros((m, dim))
    gu, out, partial, bar = F._scratch(x, plan, dim, ffn)
    assert gu.shape == (m, 2 * ffn) and out.shape == (m, dim)
    assert partial.shape == (plan["slots"], m, F.GROUP_COLS)
    for t in (gu, out, partial):
        assert t.dtype == torch.float32 and t.is_contiguous()
    assert bar.dtype == torch.int32 and bar.shape == (2,) and not bar.any()
    assert F._scratch(x, plan, dim, ffn)[3] is bar     # one a device


def test_rows_a_launch_carries():
    assert [F.ffn_rows(m) for m in range(1, 17)] == (
        [1] + [4] * 3 + [8] * 4 + [16] * 8)


def test_window_capacities():
    """A window holds at least 3 chunks beside at least 2 ring steps in
    every format and row class, and the 7B FFN at Q4_0 needs one window a
    phase at every M (its ranges are short)."""
    for rows in (1, 4, 8, 16):
        for qtype in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0,
                      GGMLType.Q5_1, GGMLType.Q8_0, GGMLType.Q2_K):
            cap = F.window_chunks(qtype, rows)
            assert 3 <= cap <= 64
            assert F._win_bytes(rows, cap) + 2 * F._step_bytes(qtype) \
                <= F._SMEM_DYN
        plan = F.ffn_plan(rows, 4096, 11008, SMS)
        assert plan["nwin_a"] == plan["nwin_b"] == 1


def test_too_few_blocks_for_the_windows():
    with pytest.raises(ValueError, match="cannot split K"):
        F.ffn_plan(16, 4096, 11008, 1, GGMLType.Q5_1, GGMLType.Q5_1)
