"""Flash attention over the slot KV cache: the CUDA kernels, their plain
version, and launch counts. Counterpart of tpulamm.ops.flash_attention.

- `flash_attention`: online-softmax attention for prefill ubatches
  (csrc/flash_attention.cu `prefill_kernel` replaces `flash_attention` /
  `_kernel`): one block of two warpgroups per 128 query rows walks the
  live key tiles, QK^T and PV on wgmma, K/V through a cp.async ring.
  At head dim 256, where those blocks would leave SMs idle
  (`prefill_parts`), each row block's live tiles are split into parts,
  one block each, and the parts combined in order as flash_decode's
  chunks are.
- `flash_decode`: split-S flash decoding for a few query rows
  (`decode_kernel` replaces `flash_decode` / `_decode_kernel` and its XLA
  combine): one block of 4 warps per chunk of keys and up to 64 rows
  (m16 row tiles), the warps splitting the chunk's keys; each block
  writes its chunk's unnormalised (acc, m, l) and a second launch combines
  them in chunk order. The pair counts as one launch. The chunks come
  from `decode_chunking`, at the residency the built kernel reports.
- `flash_attention_ref`: the plain version of both, f32 throughout.

Layout as in the JAX package: q (B, Hkv, T*G, hd) f32 with the G query
heads of a KV head folded into the rows; k / v (B, Hkv, S, hd) in any float
type or int8 codes with per-row scales ks / vs (B, Hkv, S); kpos (B, S)
int32 key positions (-1 = empty cell); qbase / qlen (B,) int32, the first
query position and the live query count of each batch row. Returns
(B, Hkv, T*G, hd) f32. Head dims 64, 128 and 256 with bf16 or int8 K/V
run the two kernels above (at 256 with 64-key prefill tiles and one
decode block an SM for bf16, two for int8); f32 / f16 K/V run the
kernel's older mma.sync body (see the note in the source).

A wrapper takes the plain version only for tensors that lie on the CPU; on
CUDA tensors it launches its kernel or raises. K, V, kpos and the scales go
to the kernel through their strides, so the span view of a cache buffer is
never copied.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
LAUNCHES = {"flash_attention": 0, "flash_decode": 0}

# decode_kernel: the keys a warp takes at once (a chunk is a multiple of
# them) and the query rows of one block (4 m16 tiles)
DECODE_KEY_TILE = 16
DECODE_ROWS = 64
# the fewest keys of a decode chunk where S has them, by head dim: one key
# tile at hd 64 and 128; 256 keys at hd 256, where below that a block's
# fixed cost (its tile list, first loads, fold and partial) and the
# combine's chunk loop outgrow its keys (one KV head at S 8193 was 257
# chunks of 32)
DECODE_MIN_CHUNK = {64: DECODE_KEY_TILE, 128: DECODE_KEY_TILE, 256: 256}
# prefill_kernel: query rows of a block, the head dims whose blocks take
# parts (csrc P_PARTS_HD), and the fewest keys of a part
PREFILL_ROWS = 128
PREFILL_PARTS_HEAD_DIMS = (256,)
PREFILL_MIN_PART = 1024
# decode_kernel blocks resident on one SM of an H100, by (head dim, int8
# K/V), as the built kernel reports them (`_residency`, which the wrapper
# reads; tests/test_torch_cuda.py holds the two equal): 128 threads and a
# 3-slot ring of 64-key tiles; at hd 64 (<= 128 registers, <= 50 KB) four,
# at hd 128 (<= 168 registers) three for int8's 50 KB and two for bf16's
# 98 KB; at hd 256 (<= 255 registers) one for bf16's 194 KB and two for
# int8's 98 KB. The CPU tests chunk at these figures.
DESIGN_RESIDENCY = {(64, False): 4, (64, True): 4, (128, False): 2,
                    (128, True): 3, (256, False): 1, (256, True): 2}
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.int8: 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def decode_chunking(S: int, B: int, Hkv: int, TG: int, sm_count: int,
                    blocks_per_sm: int, hd: int) -> tuple[int, int]:
    """(chunk, n_chunks) of flash_decode: the keys one block takes, a
    multiple of DECODE_KEY_TILE, and the chunks that cover S. The grid,
    B * Hkv * ceil(TG / DECODE_ROWS) * n_chunks blocks, is as many chunks
    as fit one wave of resident blocks (blocks_per_sm * sm_count) and no
    more, so no block waits for a second wave; at least one chunk, and
    none shorter than DECODE_MIN_CHUNK[hd] keys but the last. Every key
    lies in exactly one chunk; the last may be short (one key: the trash
    cell of S = n_ctx + 1)."""
    groups = B * Hkv * -(-TG // DECODE_ROWS)
    n_tiles = max(1, -(-S // DECODE_KEY_TILE))
    want = max(1, min(-(-S // DECODE_MIN_CHUNK[hd]),
                      blocks_per_sm * sm_count // groups))
    chunk = -(-n_tiles // want) * DECODE_KEY_TILE
    return chunk, -(-S // chunk)


def prefill_parts(S: int, B: int, Hkv: int, TG: int, sm_count: int) -> int:
    """The parts each 128-row block of flash_attention splits its live key
    tiles into: as many as keep the grid, B * Hkv * ceil(TG / 128) blocks
    a part, within one block an SM (the kernel holds its SM alone), with at
    least PREFILL_MIN_PART keys of the span a part; 1 where the blocks
    already fill the card."""
    blocks = B * Hkv * -(-TG // PREFILL_ROWS)
    return max(1, min(sm_count // blocks, S // PREFILL_MIN_PART))


@functools.lru_cache(maxsize=None)
def _residency(dev: torch.device, hd: int, k_type: int, v_type: int,
               S: int) -> int:
    """decode_kernel blocks (of the body dispatch picks for these types)
    that one SM of `dev` holds, read from the built kernel at the shared
    memory of a chunk of all S keys, the most a chunk can take; sets the
    kernel's shared-memory limit first."""
    from tpulamm_torch.ops import kernels
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        kernels.check(kernels.library("flash_attention")
                      .tl_flash_decode_blocks(
                          hd, k_type, v_type,
                          -(-S // DECODE_KEY_TILE) * DECODE_KEY_TILE,
                          ctypes.byref(n)), "flash_decode: occupancy")
    if n.value < 1:
        raise RuntimeError(f"flash_decode: the kernel for hd {hd} does not "
                           f"fit an SM at S = {S}")
    return n.value


def flash_attention_ref(q, k, v, kpos, qbase, qlen, ks=None, vs=None, *,
                        scale: float, g: int, causal: bool = True
                        ) -> torch.Tensor:
    """Plain version: scores, mask and softmax materialised in f32
    (flash_attention.py:353-377)."""
    TG = q.shape[2]
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    if ks is not None:
        kf = kf * ks.to(torch.float32)[:, :, :, None]
    if vs is not None:
        vf = vf * vs.to(torch.float32)[:, :, :, None]
    s = torch.einsum("bhrd,bhsd->bhrs", q.to(torch.float32), kf) * scale
    live = (kpos >= 0)[:, None, None, :]
    if causal:
        t = torch.arange(TG, device=q.device) // g
        qpos = qbase[:, None].to(torch.int64) + t[None, :]          # (B, TG)
        live = live & (kpos[:, None, None, :] <= qpos[:, None, :, None])
        live = live & (t[None, None, :, None]
                       < qlen.to(torch.int64)[:, None, None, None])
    s = torch.where(live, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - m))
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhrs,bhsd->bhrd", p, vf)
    return torch.where(l > 0, out / l, 0.0)


def _device(q, k, v, kpos, qbase, qlen, ks, vs) -> torch.device:
    """Check shapes and that every tensor lies on one device."""
    B, Hkv, _, hd = q.shape
    S = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the flash kernels take "
                         f"{HEAD_DIMS}")
    if tuple(k.shape) != (B, Hkv, S, hd) or tuple(v.shape) != (B, Hkv, S, hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(kpos.shape) != (B, S):
        raise ValueError(f"kpos {tuple(kpos.shape)} is not ({B}, {S})")
    for name, sc in (("ks", ks), ("vs", vs)):
        if sc is not None and tuple(sc.shape) != (B, Hkv, S):
            raise ValueError(f"{name} {tuple(sc.shape)} is not "
                             f"({B}, {Hkv}, {S})")
    devs = {t.device for t in (q, k, v, kpos, qbase, qlen, ks, vs)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on {sorted(map(str, devs))}: the kernel "
                         "needs them all on one CUDA device")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash kernel for device {dev}")
    return dev


def _strides(t: torch.Tensor, name: str, rows16: bool = False
             ) -> tuple[int, ...]:
    """Element strides of all but the last axis, which must be 1; rows16:
    rows must also start 16-byte aligned (the kernel loads K / V rows 8
    elements at a time)."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must have stride 1")
    st = t.stride()[:-1]
    if rows16 and (t.data_ptr() % 16
                   or any(s * t.element_size() % 16 for s in st)):
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    return st


def _launch(split: bool, q, k, v, kpos, qbase, qlen, ks, vs, scale, g,
            causal) -> torch.Tensor:
    from tpulamm_torch.ops import kernels
    lib = kernels.library("flash_attention")
    B, Hkv, TG, hd = q.shape
    S = k.shape[2]
    dev = q.device
    qc = q.to(torch.float32).contiguous()
    kp = kpos if kpos.dtype == torch.int32 else kpos.to(torch.int32)
    qb = qbase.to(torch.int32).contiguous()
    ql = qlen.to(torch.int32).contiguous()
    for name, t in (("k", k), ("v", v)):
        if t.dtype not in _TYPE_CODE:
            raise ValueError(f"{name}: dtype {t.dtype} is not taken")
    for name, sc in (("ks", ks), ("vs", vs)):
        if sc is not None and sc.dtype != torch.float32:
            raise ValueError(f"{name} must be float32")
    k_st, v_st = _strides(k, "k", True), _strides(v, "v", True)
    kp_st = _strides(kp, "kpos")
    ks_st = _strides(ks, "ks") if ks is not None else (0, 0)
    vs_st = _strides(vs, "vs") if vs is not None else (0, 0)
    out = torch.empty((B, Hkv, TG, hd), dtype=torch.float32, device=dev)
    chunk, ns, acc, m, l = S, 1, None, None, None
    if split:
        chunk, ns = decode_chunking(
            S, B, Hkv, TG, _sm_count(dev),
            _residency(dev, hd, _TYPE_CODE[k.dtype], _TYPE_CODE[v.dtype], S),
            hd)
    elif (hd in PREFILL_PARTS_HEAD_DIMS
          and {k.dtype, v.dtype} <= {torch.bfloat16, torch.int8}):
        # the older body (f32 / f16 K/V) takes no parts
        ns = prefill_parts(S, B, Hkv, TG, _sm_count(dev))
    if split or ns > 1:
        acc = torch.empty((B, Hkv, ns, TG, hd), dtype=torch.float32,
                          device=dev)
        m = torch.empty((B, Hkv, ns, TG), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.tl_flash(
        hd, int(split), qc.data_ptr(),
        k.data_ptr(), _TYPE_CODE[k.dtype], *k_st,
        v.data_ptr(), _TYPE_CODE[v.dtype], *v_st,
        kp.data_ptr(), kp_st[0], qb.data_ptr(), ql.data_ptr(),
        ptr(ks), *ks_st[:2], ptr(vs), *vs_st[:2],
        B, Hkv, TG, S, int(g), int(bool(causal)), float(scale),
        chunk, ns, ptr(acc), ptr(m), ptr(l), out.data_ptr(), stream)
    kernels.check(rc, "flash_decode" if split else "flash_attention")
    return out


def flash_attention(q, k, v, kpos, qbase, qlen, ks=None, vs=None, *,
                    scale: float, g: int, causal: bool = True
                    ) -> torch.Tensor:
    """Online-softmax attention (csrc/flash_attention.cu `prefill_kernel`:
    one block of two warpgroups per (b, h, 128-row tile) walking the key
    tiles live for its rows, or at hd 256 a part of them, prefill_parts)."""
    if _device(q, k, v, kpos, qbase, qlen, ks, vs).type == "cpu":
        return flash_attention_ref(q, k, v, kpos, qbase, qlen, ks, vs,
                                   scale=scale, g=g, causal=causal)
    out = _launch(False, q, k, v, kpos, qbase, qlen, ks, vs, scale, g,
                  causal)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_decode(q, k, v, kpos, qbase, qlen, ks=None, vs=None, *,
                 scale: float, g: int, causal: bool = True) -> torch.Tensor:
    """Split-S flash decoding (same contract as flash_attention): one
    block per (chunk, 64-row group, h, b), chunks from decode_chunking,
    then the combine in chunk order."""
    if _device(q, k, v, kpos, qbase, qlen, ks, vs).type == "cpu":
        return flash_attention_ref(q, k, v, kpos, qbase, qlen, ks, vs,
                                   scale=scale, g=g, causal=causal)
    out = _launch(True, q, k, v, kpos, qbase, qlen, ks, vs, scale, g, causal)
    LAUNCHES["flash_decode"] += 1
    return out
