"""The gated FFN of a few rows in one launch: the CUDA kernel, its plain
version and the dispatch guard. Counterpart of tpulamm.ops.pallas_ffn.

    out (m, dim) f32 = (act(x @ Wg) * (x @ Wu)) @ Wd,   m <= 16

Wg | Wu is the fused (2 ffn, dim) mm QTensor (gate columns first), Wd the
(dim, ffn) one, each in any of the six formats. x, the gate and up sums and
the intermediate stay f32, as in the JAX kernel.

`ffn_fused` launches csrc/ffn_fused.cu (replaces `ffn_fused` / `_ffn_call`)
for a CUDA tensor and takes `ffn_fused_ref` for a CPU one; `ffn_plan`
sizes its split. `LAUNCHES` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops.layers import gelu, silu
from tpulamm_torch.ops.qmm import _f32_aligned, _plane_ptrs
from tpulamm_torch.ops.qtensor import QTensor, dequant_mm
from tpulamm_torch.quant.repack import SPECS

TK = 256                          # K elements of one plane chunk
MAX_M = 16
ACTS = {"silu": 0, "gelu": 1}     # anything else runs relu, as _act_fn does
LAUNCHES = {"ffn_fused": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _act_fn(a: torch.Tensor, act: str) -> torch.Tensor:
    """pallas_ffn.py:67: silu, gelu (tanh), else relu."""
    if act == "silu":
        return silu(a)
    if act == "gelu":
        return gelu(a)
    return torch.clamp(a, min=0.0)


def _tn1_for(ffn: int) -> int | None:
    """Largest multiple of 128 that divides ffn and is <= 2048."""
    for t in range(2048, 127, -128):
        if ffn % t == 0:
            return t
    return None


def ffn_fused_eligible(gu_qt, down_qt, m: int) -> bool:
    """Static dispatch guard: decode-size batch, tileable shapes."""
    if not (isinstance(gu_qt, QTensor) and isinstance(down_qt, QTensor)):
        return False
    if gu_qt.layout != "mm" or down_qt.layout != "mm":
        return False
    n_gu, k1 = gu_qt.mm_dims
    ffn = n_gu // 2
    return (m <= 16 and _tn1_for(ffn) is not None and k1 % TK == 0
            and down_qt.mm_dims[0] % 128 == 0)


def _dims(x: torch.Tensor, gu_qt: QTensor, down_qt: QTensor):
    n_gu, k1 = gu_qt.mm_dims
    ffn = n_gu // 2
    dim, k2 = down_qt.mm_dims
    if k2 != ffn or k1 != dim or n_gu != 2 * ffn:
        raise ValueError(f"gate|up {gu_qt.mm_dims} and down {down_qt.mm_dims} "
                         "do not make an FFN")
    if x.dim() != 2 or x.shape[1] != dim:
        raise ValueError(f"x {tuple(x.shape)} does not match dim={dim}")
    return x.shape[0], dim, ffn


def ffn_fused_ref(x: torch.Tensor, gu_qt: QTensor, down_qt: QTensor, *,
                  act: str = "silu") -> torch.Tensor:
    """Plain version, the JAX kernel's arithmetic: x as f32 against the f32
    dequantized weights (as qmm_ref), mid = act(gate) * up kept f32, then
    mid @ Wd. (m, dim) -> (m, dim) f32."""
    _, _, ffn = _dims(x, gu_qt, down_qt)
    torch.backends.cuda.matmul.allow_tf32 = False       # a full-f32 reference
    gu = x.to(torch.float32) @ dequant_mm(gu_qt, torch.float32)
    mid = _act_fn(gu[:, :ffn], act) * gu[:, ffn:]
    return mid @ dequant_mm(down_qt, torch.float32)


GROUP_COLS = 1024                # neighbouring columns a block step reads

# The shared memory of a block (csrc/ffn_fused.cu, mirrored here so that
# the split is planned, and tested, without the card): a window of K
# chunks of x and a ring of steps, whose bytes depend on the format.
_SMEM_DYN = 232448 - 1024
_XCH_MAX = 64
_ROWB = 1040                     # a code row of a step, padded


def _step_bytes(qtype: GGMLType) -> int:
    """Bytes of one ring step of `qtype` (Step<QT>::BYTES)."""
    spec = SPECS[qtype]
    rows = 16 if qtype == GGMLType.Q2_K else 32
    if spec.bits == 5:
        rows += 32                                     # the qh rows
    if qtype == GGMLType.Q2_K:
        return rows * _ROWB + 8192
    ng = 1 if qtype == GGMLType.Q8_0 else 2
    return rows * _ROWB + ng * 4096 * (2 if spec.has_min else 1)


def _win_bytes(rows: int, nch: int) -> int:
    wrows = 2 * rows if rows > 1 else 2
    return (wrows * (nch * 512 + 16) + nch * 16 * rows * 4 + 15) // 16 * 16


def window_chunks(qtype: GGMLType, rows: int) -> int:
    """K chunks a window holds for `qtype` at `rows` rows a launch
    (csrc/ffn_fused.cu xch): beside a ring of 3 steps, or of 2 where 3
    leave fewer than 4."""
    def fit(r):
        x = _XCH_MAX
        while x > 0 and _win_bytes(rows, x) + r * _step_bytes(qtype) > _SMEM_DYN:
            x -= 1
        return x
    return fit(3) if fit(3) >= 4 else fit(2)


def steps_per_chunk(qtype: GGMLType) -> int:
    """Ring steps of a 256-element chunk: 32 code rows each (Q2_K 16)."""
    return 8 if qtype == GGMLType.Q8_0 else 4


def windows_fit(kch: int, groups: int, nwin: int, blocks: int, spc: int,
                cap: int) -> bool:
    """Whether nwin K windows keep every block's range within `cap`
    chunks (csrc/ffn_fused.cu windows_fit): window v takes chunks [kch v /
    nwin, kch (v + 1) / nwin) and blocks [blocks v / nwin, ...); a range of
    L positions reads at most min(the window's chunks, (L - 1) // spc + 2)
    of them."""
    if not 1 <= nwin <= min(blocks, kch):
        return False
    for v in range(nwin):
        nch = kch * (v + 1) // nwin - kch * v // nwin
        nb = blocks * (v + 1) // nwin - blocks * v // nwin
        length = groups * spc * nch
        nbk = min(nb, length)
        ell = -(-length // nbk)
        if min(nch, (ell - 1) // spc + 2) > cap:
            return False
    return True


def ffn_rows(m: int) -> int:
    """Rows one launch carries for m rows: 1, 4, 8 or 16."""
    return 1 if m == 1 else (4 if m <= 4 else (8 if m <= 8 else 16))


def ffn_plan(m: int, dim: int, ffn: int, blocks: int,
             qt_gu: GGMLType = GGMLType.Q4_0,
             qt_dn: GGMLType = GGMLType.Q4_0) -> dict:
    """The split of one launch (csrc/ffn_fused.cu) of `blocks` blocks.
    Each phase's positions (column group of 1024, K chunk, step) are cut
    into as few K windows as keep every block's range within a window's
    chunks (windows_fit), and a window's positions, group first, into
    equal ranges, one a block. Returns rows, nwin_a / nwin_b, groups_a /
    groups_b, and the slots of `partial` (a block's sums for one group, m
    x 1024 f32; blocks + windows x groups of either phase)."""
    rows = ffn_rows(m)
    groups_a = -(-2 * ffn // GROUP_COLS)
    groups_b = -(-dim // GROUP_COLS)
    nwin = []
    for k, groups, qt in ((dim, groups_a, qt_gu), (ffn, groups_b, qt_dn)):
        kch, cap, spc = k // 256, window_chunks(qt, rows), steps_per_chunk(qt)
        n = next((n for n in range(1, min(blocks, kch) + 1)
                  if windows_fit(kch, groups, n, blocks, spc, cap)), None)
        if n is None:
            raise ValueError(f"ffn_fused: {blocks} blocks cannot split K "
                             f"{k} into windows of {cap} chunks")
        nwin.append(n)
    nwin_a, nwin_b = nwin
    return {"rows": rows, "nwin_a": nwin_a, "nwin_b": nwin_b,
            "groups_a": groups_a, "groups_b": groups_b,
            "slots": blocks + max(nwin_a * groups_a, nwin_b * groups_b)}


@functools.lru_cache(maxsize=None)
def _blocks(dev: torch.device, rows: int) -> int:
    """The cooperative grid of the kernel for `rows` rows a launch (one
    block an SM); sets the kernel's shared memory on the device first."""
    from tpulamm_torch.ops import kernels
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        kernels.check(kernels.library("ffn_fused").tl_ffn_fused_blocks(
            rows, ctypes.byref(n)), "ffn_fused: cooperative launch")
    return n.value


_bars: dict[torch.device, torch.Tensor] = {}


def _scratch(x: torch.Tensor, plan: dict, dim: int, ffn: int):
    """(gu, out, partial, bar) of one launch, from torch on x's device: gu
    (m, 2 ffn) f32 (x Wg | x Wu); out (m, dim) f32; partial (slots, m,
    1024) f32; the grid barrier's 2 words, zeroed once and shared by the
    launches of a device (each leaves them zeroed)."""
    m, dev = x.shape[0], x.device
    bar = _bars.get(dev)
    if bar is None:
        bar = _bars[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    gu = torch.empty((m, 2 * ffn), dtype=torch.float32, device=dev)
    out = torch.empty((m, dim), dtype=torch.float32, device=dev)
    partial = torch.empty((plan["slots"], m, GROUP_COLS), dtype=torch.float32,
                          device=dev)
    return gu, out, partial, bar


def ffn_fused(x: torch.Tensor, gu_qt: QTensor, down_qt: QTensor, *,
              act: str = "silu") -> torch.Tensor:
    """(act(x @ Wg) * (x @ Wu)) @ Wd for x (m <= 16, dim) -> (m, dim) f32
    through csrc/ffn_fused.cu: one cooperative launch, the two products on
    the tensor cores over every SM, their split sums added after grid
    barriers."""
    m, dim, ffn = _dims(x, gu_qt, down_qt)
    if m > MAX_M:
        raise ValueError(f"ffn_fused takes M <= {MAX_M}, got {m}")
    if x.device.type == "cpu":
        return ffn_fused_ref(x, gu_qt, down_qt, act=act)
    dev = x.device
    if dev.type != "cuda" or gu_qt.device != dev or down_qt.device != dev:
        raise ValueError(f"x on {dev}, planes on {gu_qt.device} and "
                         f"{down_qt.device}: the kernel needs them all on one "
                         "CUDA device")
    if ffn % TK or dim % TK:
        raise ValueError(f"dim {dim} and ffn {ffn} must be multiples of {TK}")
    gu_ptrs, dn_ptrs = _plane_ptrs(gu_qt), _plane_ptrs(down_qt)
    if any(p % 16 for p in gu_ptrs + dn_ptrs):
        raise ValueError("ffn_fused: every plane must be 16-byte aligned")
    from tpulamm_torch.ops import kernels
    lib = kernels.library("ffn_fused")
    rows = ffn_rows(m)
    blocks = _blocks(dev, rows)
    plan = ffn_plan(m, dim, ffn, blocks, gu_qt.qtype, down_qt.qtype)
    xf = _f32_aligned(x)
    gu, out, partial, bar = _scratch(x, plan, dim, ffn)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.check(lib.tl_ffn_fused(
        int(gu_qt.qtype), int(down_qt.qtype), xf.data_ptr(), *gu_ptrs,
        *dn_ptrs, gu.data_ptr(), out.data_ptr(), partial.data_ptr(),
        bar.data_ptr(), m, dim, ffn, ACTS.get(act, 2),
        plan["nwin_a"], plan["nwin_b"], blocks, stream), "ffn_fused")
    LAUNCHES["ffn_fused"] += 1
    return out
