"""Quantized matmul over packed planes: the two CUDA kernels, their plain
versions, and the path choice. Counterpart of tpulamm.ops.pallas_qmm.

- `qmm_ref` / `qmm_cuda`: f32-grade dequant-matmul (csrc/qmm.cu, on the
  tensor cores with x split into two bf16 passes, replaces `_qmm_call`),
  the path of every prefill projection.
- `quantize_acts` + `qmm_int8_ref` / `qmm_int8_cuda`: int8-activation gemv
  (csrc/qmm_int8.cu replaces `_qmm_int8_call` and `_quantize_acts`), the
  default for decode.
- `qmm_int8_inkq_cuda`: the same gemv with the activation quantization
  inside its one launch (csrc/qmm_int8.cu `tl_qmm_int8_inkq` replaces
  `_qmm_int8_call_inkq`); bit-identical to `qmm_int8_cuda`.
- `qmm`: the path choice of `qmm_pallas` (pallas_qmm.py:648-763).

A wrapper takes its plain version only for a tensor that lies on the CPU;
on a CUDA tensor it launches its kernel or raises. `LAUNCHES` counts the
kernel launches of each wrapper (nothing else adds to it).
"""

from __future__ import annotations

import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops.qtensor import (QTensor, dequant_mm, mm_scale_planes,
                                       unpack_mm_values)
from tpulamm_torch.quant.repack import SPECS

LAUNCHES = {"qmm": 0, "qmm_int8": 0, "qmm_int8_inkq": 0}

INT8_MAX_M = 16          # decode regime: int8 activations up to 16 rows


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _plane_ptrs(qt: QTensor) -> tuple[int, int, int, int]:
    """(qa, qb, sa, sb) device pointers in the order the C entry points
    take them: code plane, Q5 high bits, scales (Q2_K scd), mins (Q2_K dm);
    0 where a format has no such plane."""
    p = qt.planes

    def ptr(name):
        t = p.get(name)
        if t is None:
            return 0
        if not t.is_contiguous():
            raise ValueError(f"plane {name} must be contiguous")
        return t.data_ptr()
    if qt.qtype == GGMLType.Q2_K:
        return ptr("q2"), 0, ptr("scd"), ptr("dm")
    code = "q8" if qt.qtype == GGMLType.Q8_0 else "qs"
    return ptr(code), ptr("qh"), ptr("scales"), ptr("mins")


def _check_shapes(x: torch.Tensor, qt: QTensor) -> tuple[int, int, int]:
    if qt.layout != "mm" or qt.qtype not in SPECS:
        raise ValueError("qmm needs an mm-layout block-quant QTensor")
    n, k = qt.mm_dims
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match K={k}")
    if k % 256 != 0 or n % 128 != 0:
        raise ValueError(f"(N, K) = ({n}, {k}): need N % 128 == 0 and "
                         "K % 256 == 0")
    return x.shape[0], n, k


def _on_cuda(x: torch.Tensor, qt: QTensor) -> None:
    if x.device.type != "cuda" or qt.device != x.device:
        raise ValueError(f"x on {x.device}, planes on {qt.device}: the "
                         "kernel needs both on one CUDA device")


# ---------------------------------------------------------------------------
# f32 dequant-matmul
# ---------------------------------------------------------------------------

def qmm_ref(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Plain version: full dequant to f32, then an f32 matmul. (M, K) ->
    (M, N) f32."""
    torch.backends.cuda.matmul.allow_tf32 = False       # a full-f32 reference
    return x.to(torch.float32) @ dequant_mm(qt, torch.float32)


QMM_TILE = 128          # csrc/qmm.cu: a block's output tile is 128 x 128
_sm_counts: dict[torch.device, int] = {}


def qmm_splits(m: int, n: int, k: int, sms: int) -> int:
    """K ranges of one qmm.cu launch: 1 where the output tiles fill the
    SMs; else enough to fill them, each range at least 4 stages of 64 K.
    The ranges' partials are added in a fixed order."""
    tiles = -(-m // QMM_TILE) * (n // QMM_TILE)
    if tiles >= sms:
        return 1
    return max(1, min(sms // tiles, k // 64 // 4))


def qmm_ws_bytes(m: int, n: int, k: int, splits: int) -> int:
    """Workspace of one qmm.cu launch: x_hi and x_lo (bf16, rows padded to
    the tile), the min term's rows of group sums (16 bf16 a row and 64 K)
    and, where splits > 1, the partials."""
    mpad = -(-m // QMM_TILE) * QMM_TILE
    return mpad * k * 4 + mpad * k // 2 + (splits * m * n * 4
                                           if splits > 1 else 0)


def qmm_cuda(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (M, K) @ dequant(qt) -> (M, N) f32 through csrc/qmm.cu (the
    tensor-core kernel; its prologue and split sum are part of the call)."""
    m, n, k = _check_shapes(x, qt)
    if x.device.type == "cpu":
        return qmm_ref(x, qt)
    _on_cuda(x, qt)
    from tpulamm_torch.ops import kernels
    lib = kernels.library("qmm")
    ptrs = _plane_ptrs(qt)
    if any(p % 16 for p in ptrs):
        raise ValueError("qmm: every plane must be 16-byte aligned")
    xf = _f32_aligned(x)
    splits = qmm_splits(m, n, k, _sm_count(x.device))
    ws = torch.empty(qmm_ws_bytes(m, n, k, splits), dtype=torch.uint8,
                     device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernels.check(lib.tl_qmm_f32(int(qt.qtype), xf.data_ptr(), *ptrs,
                                 out.data_ptr(), ws.data_ptr(), m, n, k,
                                 splits, stream), "qmm")
    LAUNCHES["qmm"] += 1
    return out


# ---------------------------------------------------------------------------
# int8-activation gemv
# ---------------------------------------------------------------------------

def quantize_acts(x: torch.Tensor, group: int):
    """Per-(row, group) symmetric int8 activations (plain version of the
    prologue). x (M, K) -> (qx int8 (M, K), sx f32 (M, G), gsum f32 (M, G)):
    s = amax/127 (1 where 0), qx = round-half-even(x / s) clipped to +-127,
    gsum the exact f32 group sum. Row-major; the JAX prologue returns the
    same values group-major."""
    m, k = x.shape
    xg = x.to(torch.float32).reshape(m, k // group, group)
    amax = xg.abs().amax(dim=-1)
    s = amax * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    s = torch.where(s > 0, s, torch.ones_like(s))
    qx = torch.clamp(torch.round(xg / s[..., None]), -127, 127)
    return qx.to(torch.int8).reshape(m, k), s, xg.sum(-1)


def _int8_planes(qt: QTensor, k: int):
    """(raw codes (K, N) int32, sw (G, N), off (G, N) | None) for the
    rescale: off = min - zero * sw where the format needs it."""
    spec = qt.spec
    sw, mins = mm_scale_planes(qt.planes, qt.qtype)
    off = None
    if spec.zero != 0 or spec.has_min:
        off = -spec.zero * sw
        if spec.has_min:
            off = off + mins
    return unpack_mm_values(qt.planes, qt.qtype, k), sw, off


def qmm_int8_ref(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Plain version of the int8 path: quantize_acts, per-group integer
    dots (exact: f64 holds every partial sum), then
    sum_g (idot * sw) * sx + gsum @ off. (M, K) -> (M, N) f32."""
    m, n, k = _check_shapes(x, qt)
    ga = qt.spec.group
    g = k // ga
    qx, sx, gsum = quantize_acts(x, ga)
    vals, sw, off = _int8_planes(qt, k)
    idot = torch.bmm(qx.to(torch.float64).reshape(m, g, ga).transpose(0, 1),
                     vals.to(torch.float64).reshape(g, ga, n))   # (G, M, N)
    part = (idot.to(torch.float32) * sw[:, None, :]) * sx.T[:, :, None]
    out = part.sum(0)
    if off is not None:
        torch.backends.cuda.matmul.allow_tf32 = False
        out = out + gsum @ off
    return out


def _launch_quantize_acts(lib, x: torch.Tensor, group: int):
    from tpulamm_torch.ops import kernels
    m, k = x.shape
    qx = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, k // group), dtype=torch.float32, device=x.device)
    gsum = torch.empty_like(sx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernels.check(lib.tl_quantize_acts(x.data_ptr(), qx.data_ptr(),
                                       sx.data_ptr(), gsum.data_ptr(), m, k,
                                       group, stream), "quantize_acts")
    return qx, sx, gsum


def quantize_acts_cuda(x: torch.Tensor, group: int):
    """The prologue kernel alone (for holding its codes against the plain
    version); not counted as a qmm_int8 launch."""
    if x.device.type == "cpu":
        return quantize_acts(x, group)
    from tpulamm_torch.ops import kernels
    lib = kernels.library("qmm_int8")
    return _launch_quantize_acts(lib, _f32_aligned(x), group)


_counters: dict[torch.device, torch.Tensor] = {}
# K chunks (256 elements) of one unit's window at 1, <= 8 and <= 16 rows
# (csrc/qmm_int8.cu win_chunks)
INT8_WIN_CHUNKS = {1: 64, 8: 20, 16: 10}
INT8_GROUP_TILES = 8         # column tiles of a unit: one a warp of a block


def int8_rows(m: int) -> int:
    """Rows one gemv launch carries for M rows: 1, 8 or 16."""
    return 1 if m == 1 else (8 if m <= 8 else 16)


def int8_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(ks, grid) of one gemv launch (csrc/qmm_int8.cu). Its units are
    (column group, K range) pairs: 8 neighbouring 128-column tiles over ks
    ranges of whole chunks, each within the window; a block takes units
    b, b + grid, .... ks is the one of least cost: the waves of units
    times the chunks of the widest unit (plus half a chunk for a unit's
    start and end), plus the split sum, whose last warp of a tile reads ks
    partials of its rows; the weights follow a sweep of every ks on an H100
    (tools/int8_ablation.py --sweep). grid spreads the waves evenly, at most
    one block an SM."""
    tiles, kch = n // 128, k // 256
    groups = -(-tiles // INT8_GROUP_TILES)
    rows = int8_rows(m)
    best = None
    for ks in range(-(-kch // INT8_WIN_CHUNKS[rows]), kch + 1):
        units = groups * ks
        waves = -(-units // sms)
        cost = waves * (-(-kch // ks) + 0.5) + (ks - 1) * rows / 256
        if best is None or cost < best[0] - 1e-9:
            best = (cost, ks, -(-units // waves))
    return best[1], best[2]


def _sm_count(device: torch.device) -> int:
    sms = _sm_counts.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device] = sms
    return sms


def _gemv_scratch(x: torch.Tensor, n: int, k: int, m: int, sms: int):
    """(ks, grid, out, partial, counters) of one gemv launch: out (M, N)
    f32; partial (ks, M, N) f32 when ks > 1 (else out); N / 128 zeroed
    counters, shared by the launches of a device (each leaves them
    zeroed). All from torch on x's device."""
    ks, grid = int8_plan(m, n, k, sms)
    tiles = n // 128
    cnt = _counters.get(x.device)
    if cnt is None or cnt.numel() < tiles:
        cnt = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=x.device)
        _counters[x.device] = cnt
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = (torch.empty((ks, m, n), dtype=torch.float32, device=x.device)
               if ks > 1 else out)
    return ks, grid, out, partial, cnt


def _int8_inputs(x: torch.Tensor, qt: QTensor) -> tuple:
    """x as contiguous 16-byte aligned f32 (the kernels read float4s) and
    the planes' pointers, each checked 16-byte aligned (the gemv's 16-byte
    copies)."""
    ptrs = _plane_ptrs(qt)
    if any(p % 16 for p in ptrs):
        raise ValueError("qmm_int8: every plane must be 16-byte aligned")
    return _f32_aligned(x), ptrs


def _f32_aligned(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32).contiguous()
    return xf.clone() if xf.data_ptr() % 16 else xf


def qmm_int8_cuda(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """int8-activation x (M <= 16, K) @ dequant(qt) -> (M, N) f32 through
    csrc/qmm_int8.cu (two launches: prologue, gemv)."""
    m, n, k = _check_shapes(x, qt)
    if m > INT8_MAX_M:
        raise ValueError(f"int8 gemv takes M <= {INT8_MAX_M}, got {m}")
    if x.device.type == "cpu":
        return qmm_int8_ref(x, qt)
    _on_cuda(x, qt)
    from tpulamm_torch.ops import kernels
    lib = kernels.library("qmm_int8")
    xf, (qa, qb, sa, sb) = _int8_inputs(x, qt)
    qx, sx, gsum = _launch_quantize_acts(lib, xf, qt.spec.group)
    ks, grid, out, partial, cnt = _gemv_scratch(x, n, k, m,
                                                _sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernels.check(lib.tl_qmm_int8(int(qt.qtype), qx.data_ptr(), sx.data_ptr(),
                                  gsum.data_ptr(), qa, qb, sa, sb,
                                  out.data_ptr(), partial.data_ptr(),
                                  cnt.data_ptr(), m, n, k, ks, grid, stream),
                  "qmm_int8")
    LAUNCHES["qmm_int8"] += 1
    return out


# The in-kernel quantization computes the plain version's function exactly
# (the same codes, scales and sums), so its plain version is the same one.
qmm_int8_inkq_ref = qmm_int8_ref


def qmm_int8_inkq_cuda(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """qmm_int8_cuda's product in one launch: each block of the gemv
    quantizes the activations of the K ranges it reads
    (csrc/qmm_int8.cu, tl_qmm_int8_inkq). Bit-identical to qmm_int8_cuda."""
    m, n, k = _check_shapes(x, qt)
    if m > INT8_MAX_M:
        raise ValueError(f"int8 gemv takes M <= {INT8_MAX_M}, got {m}")
    if x.device.type == "cpu":
        return qmm_int8_inkq_ref(x, qt)
    _on_cuda(x, qt)
    from tpulamm_torch.ops import kernels
    lib = kernels.library("qmm_int8")
    xf, (qa, qb, sa, sb) = _int8_inputs(x, qt)
    ks, grid, out, partial, cnt = _gemv_scratch(x, n, k, m,
                                                _sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernels.check(lib.tl_qmm_int8_inkq(int(qt.qtype), xf.data_ptr(), qa, qb,
                                       sa, sb, out.data_ptr(),
                                       partial.data_ptr(), cnt.data_ptr(),
                                       m, n, k, ks, grid, stream),
                  "qmm_int8_inkq")
    LAUNCHES["qmm_int8_inkq"] += 1
    return out


# ---------------------------------------------------------------------------
# path choice
# ---------------------------------------------------------------------------

def _widest_divisor_tile(n: int, cap: int = 8192) -> int:
    """Largest multiple-of-128 divisor of N that is <= cap (0 if none)."""
    for d in range(cap // 128, 0, -1):
        if n % (d * 128) == 0:
            return d * 128
    return 0


INT8_MODES = ("1", "0", "force")


def use_int8(m: int, n: int, compute_dtype, mode: str = "1") -> bool:
    """qmm_pallas's choice under its TPULAMM_INT8_DOT `mode`: "1", int8
    activations for M <= 16 unless f32 compute was asked for explicitly,
    when N has a multiple-of-128 divisor tile of at least 1024 (<= 8192);
    "0", never; "force", for M <= 16 at any compute dtype and any such tile
    of at least 128. Else the f32 dequant-matmul."""
    if mode == "0" or m > INT8_MAX_M:
        return False
    if mode == "force":
        return _widest_divisor_tile(n) >= 128
    return compute_dtype != torch.float32 and _widest_divisor_tile(n) >= 1024


def qmm(x: torch.Tensor, qt: QTensor, compute_dtype=torch.bfloat16,
        inkq: bool = False, int8: str = "1") -> torch.Tensor:
    """x (M, K) @ dequant(qt) -> (M, N) f32 by the path qmm_pallas takes;
    inkq: the int8 path quantizes inside its launch (TPULAMM_INT8_INKQ=1
    in the JAX package); int8: use_int8's mode (TPULAMM_INT8_DOT)."""
    n, _ = qt.mm_dims
    if use_int8(x.shape[0], n, compute_dtype, int8):
        return qmm_int8_inkq_cuda(x, qt) if inkq else qmm_int8_cuda(x, qt)
    return qmm_cuda(x, qt)
