"""KV cache: preallocated per-slot tensors with position metadata.

Counterpart of tpulamm.runtime.kvcache. Each sequence owns a slot (batch
row) of per-layer (B, H_kv, S, D) buffers; per-cell positions live in a
(B, S) int32 tensor (-1 = empty), from which attention derives the
reference's KQ_mask. JAX rebuilt the cache on every operation; here every
update is in place on the preallocated buffers (a gather such as defrag
builds its result and copies it back into the same storage).

- q8_0 storage (the reference's cache_type_k/v): int8 codes in k / v and
  per-(b, h, cell) f32 row scales in ks / vs; K and V independently.
- position surgery: seq_rm, seq_keep, seq_cp, seq_add and seq_div (which
  re-rotate cached K by the position change), defrag.
Segment ids (seg) belong to lookahead and eval_segmented, later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpulamm_torch.ops.rope import RopeParams, apply_rope

INT32_MAX = 2 ** 31 - 1

# cache storage types (-ctk/-ctv)
KV_CACHE_TYPES = ("float32", "bfloat16", "float16", "q8_0")


@dataclass
class KVCache:
    k: list                 # L x (B, H_kv, S, D) roped keys (int8 codes: q8_0)
    v: list                 # L x (B, H_kv, S, D) values
    pos: torch.Tensor       # (B, S) int32, -1 = empty cell
    ks: list | None = None  # L x (B, H_kv, S) f32 K row scales (q8_0 K)
    vs: list | None = None  # L x (B, H_kv, S) f32 V row scales (q8_0 V)

    @staticmethod
    def create(n_layers: int, n_slots: int, n_ctx: int, n_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, dtype_v=None,
               qtype_k: str | None = None, qtype_v: str | None = None,
               device="cpu") -> "KVCache":
        for qt in (qtype_k, qtype_v):
            if qt not in (None, "q8_0"):
                raise ValueError(f"unsupported KV cache quant type {qt!r} "
                                 "(supported: q8_0)")
        shape = (n_slots, n_kv_heads, n_ctx, head_dim)
        sshape = (n_slots, n_kv_heads, n_ctx)

        def bufs(q, dt):
            dt = torch.int8 if q else dt
            return [torch.zeros(shape, dtype=dt, device=device)
                    for _ in range(n_layers)]

        def scales(q):
            return ([torch.ones(sshape, dtype=torch.float32, device=device)
                     for _ in range(n_layers)] if q else None)

        return KVCache(
            k=bufs(qtype_k, dtype),
            v=bufs(qtype_v, dtype_v if dtype_v is not None else dtype),
            pos=torch.full((n_slots, n_ctx), -1, dtype=torch.int32,
                           device=device),
            ks=scales(qtype_k), vs=scales(qtype_v))


def q8_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) absmax int8 quantization, as the JAX package's:
    x (..., D) -> (codes int8 (..., D), scales f32 (...,)) with scale =
    amax / 127 (1 where amax is 0), codes = round-half-even(x / scale)
    clipped to +-127."""
    xf = x.to(torch.float32)
    amax = torch.amax(xf.abs(), dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _range_mask(pos: torch.Tensor, slot: int, p0: int, p1: int
                ) -> torch.Tensor:
    """(B, S) bool: cells of `slot` whose position is in [p0, p1)."""
    slot_mask = (torch.arange(pos.shape[0], device=pos.device) == slot)
    return slot_mask[:, None] & (pos >= p0) & (pos < p1) & (pos >= 0)


def seq_rm(cache: KVCache, slot: int, p0: int = 0,
           p1: int = INT32_MAX) -> KVCache:
    """Invalidate the cells of `slot` whose position is in [p0, p1)
    (in place; the K/V rows stay and are masked by position -1)."""
    row = cache.pos[slot]
    row.masked_fill_((row >= p0) & (row < p1) & (row >= 0), -1)
    return cache


def clear(cache: KVCache) -> KVCache:
    cache.pos.fill_(-1)
    return cache


def seq_cp(cache: KVCache, src: int, dst: int) -> KVCache:
    """Copy slot src's cells (K, V, scales, positions) onto slot dst, in
    place (llama_kv_cache_seq_cp)."""
    for bufs in (cache.k, cache.v, cache.ks, cache.vs):
        for buf in bufs or ():
            buf[dst].copy_(buf[src])
    cache.pos[dst].copy_(cache.pos[src])
    return cache


def seq_keep(cache: KVCache, slot: int) -> KVCache:
    """Invalidate every slot except `slot` (llama_kv_cache_seq_keep), in
    place."""
    keep = torch.arange(cache.pos.shape[0], device=cache.pos.device) == slot
    cache.pos.masked_fill_(~keep[:, None], -1)
    return cache


def seq_add(cache: KVCache, slot: int, p0: int, p1: int, delta: int,
            rope: RopeParams) -> KVCache:
    """Shift positions in [p0, p1) by delta and re-rope cached K (the
    reference's K-shift); cells whose new position falls below 0 are
    removed. In place."""
    m = _range_mask(cache.pos, slot, p0, p1)
    new_pos = torch.where(m, cache.pos + delta, cache.pos)
    _apply_pos_change(cache, m, new_pos, rope)
    cache.pos.copy_(torch.where(new_pos < 0, -1, new_pos))
    return cache


def seq_div(cache: KVCache, slot: int, p0: int, p1: int, d: int,
            rope: RopeParams) -> KVCache:
    """Integer-divide positions in [p0, p1) by d (self-extend) and re-rope
    cached K. In place."""
    m = _range_mask(cache.pos, slot, p0, p1)
    new_pos = torch.where(m, torch.div(cache.pos, d, rounding_mode="floor"),
                          cache.pos)
    _apply_pos_change(cache, m, new_pos, rope)
    cache.pos.copy_(new_pos)
    return cache


def _apply_pos_change(cache: KVCache, mask: torch.Tensor,
                      new_pos: torch.Tensor, rope: RopeParams) -> None:
    """Rotate the K rows under `mask` by their position change (rope by a
    delta composes with the stored rotation), in place. A q8_0 K is
    dequantized, rotated and requantized in the masked rows only: the other
    rows keep their exact codes and scales."""
    delta = torch.where(mask, new_pos - cache.pos, 0)          # (B, S)

    def rot(kl):                        # apply_rope wants (..., S, H, D)
        return apply_rope(kl.transpose(1, 2), delta, rope).transpose(1, 2)
    row = mask[:, None, :]                                       # (B, 1, S)
    if cache.ks is None:
        for kl in cache.k:
            kl.copy_(torch.where(row[..., None], rot(kl), kl))
        return
    for kl, sl in zip(cache.k, cache.ks):
        q, s = q8_quantize(rot(kl.to(torch.float32) * sl[..., None]))
        kl.copy_(torch.where(row[..., None], q, kl))
        sl.copy_(torch.where(row, s, sl))


def defrag(cache: KVCache) -> KVCache:
    """Compact live cells to the front of each slot, keeping their order
    (llama_kv_cache_defrag): a stable gather of k, v, ks, vs and pos, each
    copied back into its own buffer."""
    S = cache.pos.shape[1]
    live = cache.pos >= 0
    ar = torch.arange(S, device=cache.pos.device)
    order = torch.argsort(torch.where(live, ar, S + ar), dim=-1, stable=True)
    cache.pos.copy_(torch.gather(torch.where(live, cache.pos, -1), 1, order))
    for bufs in (cache.k, cache.v):
        for buf in bufs:
            idx = order[:, None, :, None].expand(-1, buf.shape[1], -1,
                                                 buf.shape[3])
            buf.copy_(torch.gather(buf, 2, idx))
    for bufs in (cache.ks, cache.vs):
        for buf in bufs or ():
            idx = order[:, None, :].expand(-1, buf.shape[1], -1)
            buf.copy_(torch.gather(buf, 2, idx))
    return cache


def write_kv(cache: KVCache, layer: int, k_new: torch.Tensor,
             v_new: torch.Tensor, slots: int | torch.Tensor | None,
             cells: torch.Tensor, positions: torch.Tensor) -> KVCache:
    """Store roped K / V for a ubatch (llm_build_kv_store equivalent), in
    place; a q8_0 K or V is quantized per (b, h, cell) row first.

    k_new/v_new: (B, T, H_kv, D); slots: (B,) slot ids, an int slot for
    every row, or None when the batch covers the first B slots in order;
    cells: (B, T) cell indices
    to write (padding rows target the trash cell: the engine allocates
    n_ctx + 1 cells and pads with cell n_ctx); positions: (B, T) token
    positions, written to the position table at layer 0 (-1 = empty).
    """
    B, T, H, _ = k_new.shape
    dev = k_new.device
    if slots is None:
        sl = torch.arange(B, dtype=torch.long, device=dev)
    elif isinstance(slots, int):
        sl = torch.full((B,), slots, dtype=torch.long, device=dev)
    else:
        sl = slots.to(torch.long)
    b3 = sl[:, None, None]                               # (B, 1, 1)
    h3 = torch.arange(H, dtype=torch.long, device=dev)[None, :, None]
    c3 = cells.to(torch.long)[:, None, :]                # (B, 1, T)
    idx = (b3, h3, c3)
    for new, bufs, scales in ((k_new, cache.k, cache.ks),
                              (v_new, cache.v, cache.vs)):
        rows = new.transpose(1, 2)                       # (B, H, T, D)
        if scales is not None:
            codes, sc = q8_quantize(rows)
            bufs[layer].index_put_(idx, codes)
            scales[layer].index_put_(idx, sc)
        else:
            bufs[layer].index_put_(idx, rows.to(bufs[layer].dtype))
    if layer == 0:
        cache.pos.index_put_((sl[:, None], cells.to(torch.long)),
                             positions.to(torch.int32))
    return cache
