"""The gated FFN of a few rows in one launch: the CUDA kernel, its plain
version and the dispatch guard. Counterpart of tpulamm.ops.pallas_ffn.

    out (m, dim) f32 = (act(x @ Wg) * (x @ Wu)) @ Wd,   m <= 16

Wg | Wu is the fused (2 ffn, dim) mm QTensor (gate columns first), Wd the
(dim, ffn) one, each in any of the six formats. x, the gate and up sums and
the intermediate stay f32, as in the JAX kernel.

`ffn_fused` launches csrc/ffn_fused.cu (replaces `ffn_fused` / `_ffn_call`)
for a CUDA tensor and takes `ffn_fused_ref` for a CPU one. `LAUNCHES`
counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpulamm_torch.ops.layers import gelu, silu
from tpulamm_torch.ops.qmm import _plane_ptrs
from tpulamm_torch.ops.qtensor import QTensor, dequant_mm

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


_scratch: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


@functools.lru_cache(maxsize=None)
def _blocks(dev: torch.device, mt: int) -> int:
    """The cooperative grid of the kernel for row tiles of `mt` rows."""
    from tpulamm_torch.ops import kernels
    n = ctypes.c_int(0)
    kernels.check(kernels.library("ffn_fused").tl_ffn_fused_blocks(
        mt, ctypes.byref(n)), "ffn_fused: cooperative launch")
    return n.value


def _split(blocks: int, tiles: int, k: int) -> int:
    """K splits of a phase: enough items to give every block one, at most
    one 512-element slice each."""
    return max(1, min(-(-k // 512), -(-blocks // tiles)))


def ffn_fused(x: torch.Tensor, gu_qt: QTensor, down_qt: QTensor, *,
              act: str = "silu") -> torch.Tensor:
    """(act(x @ Wg) * (x @ Wu)) @ Wd for x (m <= 16, dim) -> (m, dim) f32
    through csrc/ffn_fused.cu: one cooperative launch, the two products
    split over every resident block with a grid barrier between them."""
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
    from tpulamm_torch.ops import kernels
    lib = kernels.library("ffn_fused")
    mt = 1 if m == 1 else 4
    blocks = _blocks(dev, mt)
    row_tiles = -(-m // mt)
    ks_a = _split(blocks, ffn // 128 * row_tiles, dim)
    ks_b = _split(blocks, dim // 128 * row_tiles, ffn)
    # counters (one per column tile and row tile) and the barrier's two
    # words: zeroed once, and every launch leaves them zeroed
    tiles = max(ffn, dim) // 128 * row_tiles
    if dev not in _scratch or _scratch[dev][0].numel() < tiles:
        _scratch[dev] = (torch.zeros(max(tiles, 4096), dtype=torch.int32,
                                     device=dev),
                         torch.zeros(2, dtype=torch.int32, device=dev))
    counters, bar = _scratch[dev]
    xf = x.to(torch.float32).contiguous()
    mid = torch.empty((m, ffn), dtype=torch.float32, device=dev)
    out = torch.empty((m, dim), dtype=torch.float32, device=dev)
    partial = torch.empty(max(ks_a * 2 * m * ffn, ks_b * m * dim),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.check(lib.tl_ffn_fused(
        int(gu_qt.qtype), int(down_qt.qtype), xf.data_ptr(),
        *_plane_ptrs(gu_qt), *_plane_ptrs(down_qt), mid.data_ptr(),
        out.data_ptr(), partial.data_ptr(), counters.data_ptr(),
        bar.data_ptr(), m, dim, ffn, ACTS.get(act, 2), ks_a, ks_b, blocks,
        stream), "ffn_fused")
    LAUNCHES["ffn_fused"] += 1
    return out
