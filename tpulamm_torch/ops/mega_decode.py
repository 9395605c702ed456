"""Decode megakernel: one launch per decode step for every layer of a
llama-family stack. Counterpart of tpulamm.ops.pallas_decode.

- `build_mega`: the eligibility checks of the JAX `build_mega` and the
  operands: the engine's own per-layer QTensors (no stacked copy of the
  planes; the kernel reads them through a table of pointers) and the norms
  stacked (L, dim) f32.
- `rope_lane_vectors`: rope as per-lane cos / sin vectors (signs folded),
  rope(x) = x * cos + rot(x) * sin.
- `mega_decode_layers`: one step through csrc/mega_decode.cu (replaces
  `mega_decode_layers` / `_make_kernel`) for CUDA tensors;
  `mega_decode_layers_ref`, its plain version, for CPU ones. `LAUNCHES`
  counts the kernel launches.

The step's position and cell are two int32 device words (the JAX kernel
takes qpos as an array), so a launch captured in a CUDA graph reads each
replay's own; the kernel checks the cell against the span on the device
and, where it is outside, sets an error word and writes nothing. Both
functions also take the two as host ints, checked on the host.

Both write the new K / V rows, rounded to bf16, into the cache in place at
the cell the engine allocated (the JAX scan writes them after the kernel),
and return them as f32 too. They read the cache through the engine's span
view: cells past it are empty, and an empty cell adds exact zeros, so this
equals the JAX package's read of the full cache.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from tpulamm_torch.ops.ffn_fused import ACTS, TK, _act_fn
from tpulamm_torch.ops.layers import rms_norm
from tpulamm_torch.ops.qmm import _plane_ptrs
from tpulamm_torch.ops.qtensor import QTensor, dequant_mm
from tpulamm_torch.ops.rope import RopeParams, rope_angles

MAX_HEAD_DIM = 256
MAX_CHUNK = 2048                 # keys of one attention item (shared memory)
LAUNCHES = {"mega_decode": 0}
WEIGHTS = ("wqkv_fused", "wo", "wgateup_fused", "w_down")
ROPE_KINDS = {"none": 0, "norm": 1, "neox": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class MegaSpec:
    """Static geometry of the megakernel."""
    n_layers: int
    dim: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn: int
    nqkv: int                  # (H + 2*Hkv) * hd
    qtypes: tuple              # (qkv, wo, gu, down) GGMLType
    act: str                   # silu | gelu | relu | relu_sqr
    eps: float
    rope_kind: str             # "norm" | "neox" | "none"
    n_rot: int


@dataclass
class MegaModel:
    spec: MegaSpec
    layers: list               # the engine's per-layer params (not copied)
    norms: dict                # attn_norm / ffn_norm (L, dim) f32
    rope: RopeParams
    # device tables and zeroed counters of the kernel, built at first use
    tables: dict


def _uniform_qt(layers, key):
    qts = {lyr[key].qtype for lyr in layers}
    return qts.pop() if len(qts) == 1 else None


def build_mega(params: dict, cfg) -> MegaModel | None:
    """The megakernel's operands; None if ineligible.

    Eligibility = the llama-family topology the kernel implements: rms
    pre-norm, fused QKV / gate-up QTensors, no biases, no MoE/ALiBi/
    qk-norm/parallel-residual, rope norm/neox/none, causal, and shapes in
    whole 256-element chunks (pallas_decode.py:528-577). The JAX function
    then also sizes its tiles to the TPU's VMEM and refuses what does not
    fit (LLaMA-7B at n_ctx 2048); the card has no such budget, so the port
    takes every eligible shape."""
    layers = params.get("layers", [])
    if not layers:
        return None
    if (cfg.norm_type != "rms" or cfg.post_norm or cfg.parallel_residual
            or cfg.qk_norm or cfg.n_expert > 0 or cfg.pos_emb
            or cfg.tok_norm or not cfg.causal or cfg.max_alibi_bias > 0
            or cfg.clamp_kqv > 0 or cfg.res_scale != 1.0
            or cfg.rope.kind not in ("norm", "neox", "none")):
        return None
    need = WEIGHTS + ("attn_norm", "ffn_norm")
    for lyr in layers:
        for k in need:
            if lyr.get(k) is None:
                return None
        for k in WEIGHTS:
            w = lyr[k]
            if not (isinstance(w, QTensor) and w.layout == "mm"):
                return None
        if any(lyr.get(b) is not None
               for b in ("bqkv_fused", "bo", "b_down", "b_gate", "b_up",
                         "ffn_act_scales", "attn_norm_2")):
            return None
    qts = tuple(_uniform_qt(layers, k) for k in WEIGHTS)
    if any(q is None for q in qts):
        return None
    hd = cfg.head_dim
    H, Hkv, dim = cfg.n_heads, cfg.n_kv_heads, cfg.dim
    nqkv = (H + 2 * Hkv) * hd
    nq = H * hd
    ffn = cfg.ffn_dim
    l0 = layers[0]
    if (l0["wqkv_fused"].mm_dims != (nqkv, dim)
            or l0["wo"].mm_dims != (dim, nq)
            or l0["wgateup_fused"].mm_dims != (2 * ffn, dim)
            or l0["w_down"].mm_dims != (dim, ffn)):
        return None
    if dim % TK or nq % TK or ffn % TK or cfg.rope.n_rot % 2:
        return None
    norms = {name: torch.stack([lyr[name] for lyr in layers]
                               ).to(torch.float32)
             for name in ("attn_norm", "ffn_norm")}
    spec = MegaSpec(
        n_layers=len(layers), dim=dim, n_heads=H, n_kv_heads=Hkv,
        head_dim=hd, ffn=ffn, nqkv=nqkv, qtypes=qts, act=cfg.ffn_act,
        eps=cfg.norm_eps, rope_kind=cfg.rope.kind, n_rot=cfg.rope.n_rot)
    return MegaModel(spec=spec, layers=layers, norms=norms, rope=cfg.rope,
                     tables={})


def rope_lane_vectors(rope: RopeParams, hd: int, n_heads: int,
                      n_kv_heads: int, pos: torch.Tensor):
    """Per-lane cos/sin vectors (signs folded) for the in-kernel rope.

    pos: (B,) int -> cosq/sinq (B, n_heads*hd), cosk/sink (B, nkv*hd),
    all f32. Lanes >= n_rot within a head carry cos=1, sin=0
    (pass-through, exactly apply_rope's partial-rotation semantics)."""
    B = pos.shape[0]
    dev = pos.device
    if rope.kind == "none":
        c = torch.ones((B, 0), dtype=torch.float32, device=dev)
        s = torch.zeros((B, 0), dtype=torch.float32, device=dev)
    else:
        cos, sin = rope_angles(rope, pos)        # (B, n_rot/2), mscale folded
        if rope.kind == "norm":
            c = torch.repeat_interleave(cos, 2, dim=-1)             # c_i, c_i
            s = torch.stack([-sin, sin], dim=-1).reshape(B, -1)     # -s_i, s_i
        else:                                                       # neox
            c = torch.cat([cos, cos], dim=-1)
            s = torch.cat([-sin, sin], dim=-1)
    pad = hd - c.shape[-1]
    if pad:
        c = torch.cat([c, torch.ones((B, pad), dtype=torch.float32,
                                     device=dev)], -1)
        s = torch.cat([s, torch.zeros((B, pad), dtype=torch.float32,
                                      device=dev)], -1)
    return (c.repeat(1, n_heads), s.repeat(1, n_heads),
            c.repeat(1, n_kv_heads), s.repeat(1, n_kv_heads))


def _rot(x: torch.Tensor, kind: str, hd: int, n_rot: int) -> torch.Tensor:
    """rope's companion on a (1, heads*hd) row: the pair swap (norm) or the
    half swap of the first n_rot lanes of each head (neox); lanes that
    rope passes through get sin = 0, so their value is never used."""
    xh = x.reshape(-1, hd)
    d = torch.arange(hd, device=x.device)
    if kind == "norm":
        idx = d ^ 1
    else:
        half = n_rot // 2
        idx = torch.where(d < half, d + half, d - half)
    return xh[:, idx].reshape(x.shape)


def _check_step(mega: MegaModel, x, kpos, k_cache, v_cache) -> int:
    """-> S, the span; raises on what the step does not take."""
    spec = mega.spec
    if x.dim() != 2 or x.shape[1] != spec.dim:
        raise ValueError(f"x {tuple(x.shape)} is not (1, {spec.dim})")
    if x.shape[0] != 1:
        raise NotImplementedError(
            "megakernel decode serves the single-stream step (B0 == 1); "
            "batched decode runs the forward")
    if len(k_cache) != spec.n_layers or len(v_cache) != spec.n_layers:
        raise ValueError("one K and one V cache view a layer")
    S = kpos.shape[-1]
    want = (1, spec.n_kv_heads, S, spec.head_dim)
    for t in list(k_cache) + list(v_cache):
        if tuple(t.shape) != want or t.dtype != torch.bfloat16:
            raise ValueError(f"cache views must be {want} bf16, got "
                             f"{tuple(t.shape)} {t.dtype}")
    return S


def error_word(mega: MegaModel, dev) -> torch.Tensor:
    """The MegaModel's own int32 error word on `dev` (zeroed once), used
    where a call passes none."""
    key = ("err", str(dev))
    w = mega.tables.get(key)
    if w is None:
        w = mega.tables[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return w


def _step_words(qpos, cell, S: int, dev):
    """(qpos, cell) as int32 device words of `dev`: host ints are checked
    (cell in [0, S)) and copied over; words are taken as they are."""
    if isinstance(qpos, int) and isinstance(cell, int):
        if not 0 <= cell < S:
            raise ValueError(f"cell {cell} is outside the span {S}")
        w = torch.tensor([qpos, cell], dtype=torch.int32).to(dev)
        return w[:1], w[1:]
    for name, t in (("qpos", qpos), ("cell", cell)):
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32
                and t.numel() >= 1 and t.device == dev):
            raise ValueError(f"{name} must be a host int or an int32 word "
                             f"on {dev}")
    return qpos, cell


def mega_decode_layers_ref(mega: MegaModel, x, qpos, cell, kpos,
                           k_cache, v_cache, cosq, sinq, cosk, sink,
                           err=None):
    """Plain version: a loop over layers at the JAX kernel's rounding
    points (pallas_decode.py:205-339); the softmax over the live cells
    only (an empty cell adds exact zeros). Same contract as
    mega_decode_layers."""
    spec = mega.spec
    S = _check_step(mega, x, kpos, k_cache, v_cache)
    qw, cw = _step_words(qpos, cell, S, x.device)
    qpos, cell = int(qw.reshape(-1)[0]), int(cw.reshape(-1)[0])
    f32, bf16 = torch.float32, torch.bfloat16
    L, nkv = spec.n_layers, spec.n_kv_heads * spec.head_dim
    if not 0 <= cell < S:               # the kernel's error word
        (error_word(mega, x.device) if err is None else err).fill_(1)
        return (x.new_zeros((1, spec.dim), dtype=f32),
                x.new_zeros((L, 1, nkv), dtype=f32),
                x.new_zeros((L, 1, nkv), dtype=f32))
    torch.backends.cuda.matmul.allow_tf32 = False       # a full-f32 reference
    H, Hkv, hd, ffn = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.ffn
    G, nq, nkv = H // Hkv, H * hd, Hkv * hd
    scale = 1.0 / math.sqrt(hd)
    live = torch.nonzero((kpos[0] >= 0) & (kpos[0] <= qpos)).flatten()

    def w(lyr, name):
        return dequant_mm(lyr[name], f32)

    xres = x.to(bf16)
    k_new, v_new = [], []
    for il, lyr in enumerate(mega.layers):
        hn = rms_norm(xres, mega.norms["attn_norm"][il], spec.eps)
        qkv = hn.to(f32) @ w(lyr, "wqkv_fused")
        qf, kf, vf = qkv[:, :nq], qkv[:, nq:nq + nkv], qkv[:, nq + nkv:]
        if spec.rope_kind != "none":
            qf = qf * cosq + _rot(qf, spec.rope_kind, hd, spec.n_rot) * sinq
            kf = kf * cosk + _rot(kf, spec.rope_kind, hd, spec.n_rot) * sink
        k_new.append(kf)
        v_new.append(vf)
        qb = qf.to(bf16).to(f32).reshape(Hkv, G, hd)
        kb = kf.to(bf16).to(f32).reshape(Hkv, 1, hd)
        vb = vf.to(bf16).to(f32).reshape(Hkv, 1, hd)
        kc = k_cache[il][0][:, live].to(f32)               # (Hkv, n, hd)
        vc = v_cache[il][0][:, live].to(f32)
        s = torch.einsum("jgd,jnd->jgn", qb, kc) * scale
        sc = (qb * kb).sum(-1) * scale                     # (Hkv, G)
        m = torch.maximum(s.amax(-1), sc) if live.numel() else sc
        pr = torch.exp(s - m[..., None])
        pc = torch.exp(sc - m)
        pv = (torch.einsum("jgn,jnd->jgd", pr.to(bf16).to(f32), vc)
              + pc[..., None] * vb)
        denom = pr.sum(-1) + pc
        ao = (pv / denom[..., None]).reshape(1, nq).to(bf16)
        xres = (xres.to(f32) + ao.to(f32) @ w(lyr, "wo")).to(bf16)
        hn = rms_norm(xres, mega.norms["ffn_norm"][il], spec.eps)
        gu = hn.to(f32) @ w(lyr, "wgateup_fused")
        mid = (_act_fn(gu[:, :ffn], spec.act) * gu[:, ffn:]).to(bf16)
        xres = (xres.to(f32) + mid.to(f32) @ w(lyr, "w_down")).to(bf16)
        k_cache[il][0, :, cell] = kf.reshape(Hkv, hd).to(bf16)
        v_cache[il][0, :, cell] = vf.reshape(Hkv, hd).to(bf16)
    return (xres.to(f32), torch.stack(k_new), torch.stack(v_new))


# -- the kernel's arguments (csrc/mega_decode.cu, struct MegaArgs) ------------
_INTS = ("L", "dim", "H", "Hkv", "hd", "ffn", "S", "act", "rope_kind",
         "n_rot", "qt_qkv", "qt_wo", "qt_gu", "qt_dn", "nch", "chunk",
         "kv_hstride", "kv_rstride", "kv_vec")
_PTRS = ("qpos", "cell", "err", "planes", "kcache", "vcache", "attn_norm",
         "ffn_norm", "kpos", "x",
         "cosq", "sinq", "cosk", "sink", "x_out", "k_new", "v_new", "xres",
         "qkv", "ao", "mid", "apart", "partial", "counters", "bar")


class _MegaArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_longlong) for n in _INTS]
                + [("eps", ctypes.c_double), ("scale", ctypes.c_double)]
                + [(n, ctypes.c_void_p) for n in _PTRS])


@functools.lru_cache(maxsize=None)
def _blocks(dev: torch.device, kmax: int) -> int:
    """The cooperative grid of the kernel on this card, for a stack whose
    largest product K (which sizes the kernel's shared memory) is kmax."""
    from tpulamm_torch.ops import kernels
    n = ctypes.c_int(0)
    kernels.check(kernels.library("mega_decode").tl_mega_blocks(
        kmax, ctypes.byref(n)), "mega_decode: cooperative launch")
    return n.value


def attn_chunks(S: int, blocks: int, n_heads: int) -> tuple[int, int]:
    """Phase B's items: (nch, chunk), S cut into nch chunks of `chunk`
    keys (the last may be short, none empty), one item (head, chunk) a
    block where the heads allow, at most MAX_CHUNK keys an item and, where
    S allows, no fewer than 8."""
    nch = max(blocks // n_heads, -(-S // MAX_CHUNK), 1)
    nch = min(nch, -(-S // 8))
    chunk = -(-S // nch)
    return -(-S // chunk), chunk


def _table(mega: MegaModel, key, ptrs, dev) -> torch.Tensor:
    """A device int64 table of pointers, made once for each set and kept
    (a captured launch goes on reading the table it was given)."""
    t = mega.tables.get((key, ptrs))
    if t is None:
        t = mega.tables[(key, ptrs)] = torch.tensor(ptrs, dtype=torch.int64,
                                                    device=dev)
    return t


def _plane_table(mega: MegaModel, dev) -> torch.Tensor:
    """The (L, 4, 4) table of plane pointers (qa, qb, sa, sb of each
    weight), made and checked once: the weights are the engine's and stay
    where they are."""
    t = mega.tables.get("planes")
    if t is None:
        qts = [lyr[k] for lyr in mega.layers for k in WEIGHTS]
        if any(q.device != dev for q in qts) or any(
                n.device != dev for n in mega.norms.values()):
            raise ValueError("the megakernel needs its weights on the CUDA "
                             f"device of x ({dev})")
        ptrs = [p for q in qts for p in _plane_ptrs(q)]
        if any(p % 16 for p in ptrs):
            raise ValueError("the megakernel reads its planes in 16-byte "
                             "words: every plane must start 16-byte aligned")
        t = mega.tables["planes"] = torch.tensor(ptrs, dtype=torch.int64,
                                                 device=dev)
    return t


def mega_decode_layers(mega: MegaModel, x, qpos, cell, kpos,
                       k_cache, v_cache, cosq, sinq, cosk, sink, err=None):
    """One decode step through every layer.

    x: (1, dim) f32 hidden (embedding output); qpos: the token's position
    and cell its cache cell, both host ints or both int32 device words;
    err: an int32 device word set to 1 where the cell is outside the span
    (then nothing is written; None: error_word(mega));
    kpos: (1, S) int32 cell positions (-1 = empty;
    the cell's own is still -1); k_cache / v_cache: one (1, Hkv, S, hd)
    bf16 view of the slot's cache rows a layer (any strides with the last
    one 1); cos* / sin*: rope_lane_vectors. Writes the new K / V rows
    (bf16) at `cell` in place. Returns (x_out (1, dim) f32,
    k_new (L, 1, Hkv*hd) f32, v_new same)."""
    S = _check_step(mega, x, kpos, k_cache, v_cache)
    if x.device.type == "cpu":
        return mega_decode_layers_ref(mega, x, qpos, cell, kpos, k_cache,
                                      v_cache, cosq, sinq, cosk, sink, err)
    spec = mega.spec
    dev = x.device
    L, H, Hkv, hd = spec.n_layers, spec.n_heads, spec.n_kv_heads, spec.head_dim
    dim, ffn, nq, nqkv = spec.dim, spec.ffn, H * hd, spec.nqkv
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel takes <= {MAX_HEAD_DIM}")
    qw, cw = _step_words(qpos, cell, S, dev)
    err = error_word(mega, dev) if err is None else err
    if err.dtype != torch.int32 or err.device != dev:
        raise ValueError(f"err must be an int32 word on {dev}")
    views = list(k_cache) + list(v_cache)
    if any(t.device != dev for t in [kpos, cosq, sinq, cosk, sink, *views]):
        raise ValueError("the megakernel needs every operand on one CUDA "
                         "device")
    st = k_cache[0].stride()
    if st[-1] != 1 or any(t.stride() != st for t in views):
        raise ValueError("the cache views must share one layout, last "
                         "stride 1")
    if kpos.dtype != torch.int32 or kpos.stride(-1) != 1:
        raise ValueError("kpos must be int32 with stride 1 along S")
    from tpulamm_torch.ops import kernels
    lib = kernels.library("mega_decode")
    blocks = _blocks(dev, max(dim, nq, ffn))
    nch, chunk = attn_chunks(S, blocks, H)
    # K / V rows as 16-byte words: hd a multiple of 8, every row aligned
    kv_vec = int(hd % 8 == 0 and st[1] % 8 == 0 and st[2] % 8 == 0
                 and all(t.data_ptr() % 16 == 0 for t in views))
    planes = _plane_table(mega, dev)
    kc = _table(mega, "k", tuple(t.data_ptr() for t in k_cache), dev)
    vc = _table(mega, "v", tuple(t.data_ptr() for t in v_cache), dev)
    need = max(nqkv, dim, ffn) // 128 + H
    zeros = mega.tables.get("zeros")
    if zeros is None or zeros.numel() < need + 2:
        # the tile / head counters and the barrier's two words: zeroed
        # once, and every launch leaves them zeroed
        zeros = mega.tables["zeros"] = torch.zeros(
            max(need + 2, 4096), dtype=torch.int32, device=dev)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def bf(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)
    x_out, k_new, v_new = f32(1, dim), f32(L, 1, Hkv * hd), f32(L, 1, Hkv * hd)
    xres, qkv, ao, mid = bf(dim), f32(nqkv), bf(nq), bf(ffn)
    apart = f32(H * nch * (hd + 2))
    xf, cq, sq, ck, sk = (t.to(torch.float32).contiguous()
                          for t in (x, cosq, sinq, cosk, sink))
    qt = [int(q) for q in spec.qtypes]
    a = _MegaArgs(
        L=L, dim=dim, H=H, Hkv=Hkv, hd=hd, ffn=ffn, S=S,
        act=ACTS.get(spec.act, 2),
        rope_kind=ROPE_KINDS[spec.rope_kind], n_rot=spec.n_rot,
        qt_qkv=qt[0], qt_wo=qt[1], qt_gu=qt[2], qt_dn=qt[3],
        nch=nch, chunk=chunk, kv_hstride=st[1], kv_rstride=st[2],
        kv_vec=kv_vec,
        eps=spec.eps, scale=1.0 / math.sqrt(hd),
        qpos=qw.data_ptr(), cell=cw.data_ptr(), err=err.data_ptr(),
        planes=planes.data_ptr(), kcache=kc.data_ptr(), vcache=vc.data_ptr(),
        attn_norm=mega.norms["attn_norm"].data_ptr(),
        ffn_norm=mega.norms["ffn_norm"].data_ptr(), kpos=kpos.data_ptr(),
        x=xf.data_ptr(), cosq=cq.data_ptr(), sinq=sq.data_ptr(),
        cosk=ck.data_ptr(), sink=sk.data_ptr(), x_out=x_out.data_ptr(),
        k_new=k_new.data_ptr(), v_new=v_new.data_ptr(), xres=xres.data_ptr(),
        qkv=qkv.data_ptr(), ao=ao.data_ptr(), mid=mid.data_ptr(),
        apart=apart.data_ptr(), counters=zeros.data_ptr(),
        bar=zeros[-2:].data_ptr())
    n = ctypes.c_longlong(0)
    kernels.check(lib.tl_mega_scratch(ctypes.addressof(a), blocks,
                                      ctypes.byref(n)), "mega_decode")
    partial = f32(n.value)              # the products' per-warp sums
    a.partial = partial.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.check(lib.tl_mega_decode(ctypes.addressof(a), blocks, stream),
                  "mega_decode")
    LAUNCHES["mega_decode"] += 1
    return x_out, k_new, v_new
