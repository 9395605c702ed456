"""KV cache: preallocated per-slot tensors with position metadata.

Counterpart of tpulamm.runtime.kvcache. Each sequence owns a slot (batch
row) of per-layer (B, H_kv, S, D) buffers; per-cell positions live in a
(B, S) int32 tensor (-1 = empty), from which attention derives the
reference's KQ_mask. JAX rebuilt the cache on every write; here every
update is in place on the preallocated buffers.

Ported so far: create, write_kv, seq_rm, clear. The q8_0 cache
(ks/vs scale planes), segment ids (seg), seq_cp/seq_add/seq_div/defrag
come with later slices (ROADMAP queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

INT32_MAX = 2 ** 31 - 1


@dataclass
class KVCache:
    k: list                 # L x (B, H_kv, S, D) roped keys
    v: list                 # L x (B, H_kv, S, D) values
    pos: torch.Tensor       # (B, S) int32, -1 = empty cell

    @staticmethod
    def create(n_layers: int, n_slots: int, n_ctx: int, n_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16,
               device="cpu") -> "KVCache":
        shape = (n_slots, n_kv_heads, n_ctx, head_dim)
        return KVCache(
            k=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(n_layers)],
            v=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(n_layers)],
            pos=torch.full((n_slots, n_ctx), -1, dtype=torch.int32,
                           device=device),
        )


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


def write_kv(cache: KVCache, layer: int, k_new: torch.Tensor,
             v_new: torch.Tensor, slots: torch.Tensor | None,
             cells: torch.Tensor, positions: torch.Tensor) -> KVCache:
    """Store roped K / V for a ubatch (llm_build_kv_store equivalent), in
    place.

    k_new/v_new: (B, T, H_kv, D); slots: (B,) slot ids, or None when the
    batch covers the first B slots in order; cells: (B, T) cell indices
    to write (padding rows target the trash cell: the engine allocates
    n_ctx + 1 cells and pads with cell n_ctx); positions: (B, T) token
    positions, written to the position table at layer 0 (-1 = empty).
    """
    B, T, H, _ = k_new.shape
    dev = k_new.device
    sl = (torch.arange(B, dtype=torch.long, device=dev) if slots is None
          else slots.to(torch.long))
    b3 = sl[:, None, None]                               # (B, 1, 1)
    h3 = torch.arange(H, dtype=torch.long, device=dev)[None, :, None]
    c3 = cells.to(torch.long)[:, None, :]                # (B, 1, T)
    kT = k_new.transpose(1, 2)                           # (B, H, T, D)
    vT = v_new.transpose(1, 2)
    # in-place scatter into the preallocated buffers (JAX: .at[].set)
    cache.k[layer].index_put_((b3, h3, c3), kT.to(cache.k[layer].dtype))
    cache.v[layer].index_put_((b3, h3, c3), vT.to(cache.v[layer].dtype))
    if layer == 0:
        cache.pos.index_put_((sl[:, None], cells.to(torch.long)),
                             positions.to(torch.int32))
    return cache
