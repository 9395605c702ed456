"""On-device sampler chain for the batched decode block (counterpart of
tpulamm.ops.device_sampling).

Vectorized over slots: repetition / frequency / presence penalties,
penalize_nl and ignore_eos masks, and the default sampler queue top_k ->
tail_free -> typical -> top_p -> min_p -> temp (sampler_queue,
common/sampling.cpp:127-161), so a multi-token decode block stays on the
device for default OpenAI-style requests. The math mirrors
runtime/sampling.py; at temp <= 0 the token is exactly the host sampler's
argmax after penalties.

Penalty state lives on the device: a (W, B) ring of the last W = 64 fed
tokens with one shared write cursor (a host int: it advances by one a
step) and a (B, V) count tensor kept up to date; each slot's
penalty_last_n <= W window is enforced by evicting the entry that ages
past it. The chain runs on the top K = 128 candidates.

The ranks follow the JAX package's order exactly: candidates come from a
stable descending sort (jax.lax.top_k puts the lower index first among
equal values), and the typical and top-p ranks are stable argsorts, as
jnp.argsort is. A categorical draw is the Gumbel-max over the candidates'
logits from an explicit torch.Generator: the JAX draw's distribution,
not its bits, and no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

W_RING = 64      # penalty window capacity (penalty_last_n <= W_RING)
K_CHAIN = 128    # candidate count (per-slot top_k <= K_CHAIN)


class SampParams(NamedTuple):
    """Per-slot sampling parameter vectors, shape (B,) each."""
    temp: np.ndarray          # f32; <=0 -> greedy (argmax after penalties)
    top_k: np.ndarray         # i32 in [1, K_CHAIN]
    top_p: np.ndarray         # f32; >=1 disables
    min_p: np.ndarray         # f32; <=0 disables
    tfs_z: np.ndarray         # f32; >=1 disables
    typical_p: np.ndarray     # f32; >=1 disables
    pen_repeat: np.ndarray    # f32; 1.0 disables
    pen_freq: np.ndarray      # f32
    pen_present: np.ndarray   # f32
    last_n: np.ndarray        # i32 in [0, W_RING]
    penalize_nl: np.ndarray   # bool
    ignore_eos: np.ndarray    # bool


def params_from_samplers(samplers, n_slots: int) -> SampParams:
    """Build (B,)-vectors from host Sampler objects (None -> neutral)."""
    temp = np.zeros(n_slots, np.float32)
    top_k = np.ones(n_slots, np.int32)
    top_p = np.ones(n_slots, np.float32)
    min_pv = np.zeros(n_slots, np.float32)
    tfs = np.ones(n_slots, np.float32)
    typ = np.ones(n_slots, np.float32)
    rep = np.ones(n_slots, np.float32)
    freq = np.zeros(n_slots, np.float32)
    pres = np.zeros(n_slots, np.float32)
    last_n = np.zeros(n_slots, np.int32)
    pnl = np.ones(n_slots, bool)
    ieos = np.zeros(n_slots, bool)
    for i, s in samplers.items() if isinstance(samplers, dict) \
            else enumerate(samplers):
        if s is None:
            continue
        p = s.params
        temp[i] = p.temp
        top_k[i] = min(p.top_k if p.top_k > 0 else K_CHAIN, K_CHAIN)
        top_p[i] = p.top_p
        min_pv[i] = p.min_p
        tfs[i] = p.tfs_z
        typ[i] = p.typical_p
        rep[i] = p.penalty_repeat
        freq[i] = p.penalty_freq
        pres[i] = p.penalty_present
        last_n[i] = min(p.penalty_last_n, W_RING) \
            if p.penalty_last_n >= 0 else W_RING
        pnl[i] = p.penalize_nl
        ieos[i] = p.ignore_eos
    return SampParams(temp, top_k, top_p, min_pv, tfs, typ, rep, freq,
                      pres, last_n, pnl, ieos)


def ring_from_prev(prevs, n_slots: int) -> tuple[np.ndarray, int]:
    """(W, B) ring + shared cursor from per-slot prev-token lists.

    Right-aligned so the newest entry of every slot sits at column
    cursor-1; unwritten cells are -1 (contribute no counts)."""
    ring = np.full((W_RING, n_slots), -1, np.int32)
    for i, prev in prevs.items() if isinstance(prevs, dict) \
            else enumerate(prevs):
        if not prev:
            continue
        tail = list(prev)[-W_RING:]
        ring[W_RING - len(tail):, i] = tail
    return ring, W_RING    # cursor: next write position (wraps to 0)


def fast_chain_eligible(params) -> bool:
    """Can SamplingParams be reproduced by the on-device chain?"""
    p = params
    if (p.mirostat != 0 or p.logit_bias or p.n_probs
            or p.samplers_sequence != "kfypmt"
            or p.dynatemp_range > 0.0):
        return False
    if p.penalty_last_n > W_RING:
        return False
    if p.penalty_last_n < 0 and max(p.n_prev, 0) > W_RING:
        # -1 = whole context; reproducible only while the host window
        # (prev, capped at n_prev) fits the device ring
        return False
    if p.temp > 0.0 and not (0 < p.top_k <= K_CHAIN):
        return False
    return True


# -- device side (torch) ------------------------------------------------------

def params_to(sp: SampParams, device) -> SampParams:
    """The (B,) vectors as tensors on `device` (one copy each)."""
    return SampParams(*(torch.from_numpy(np.asarray(a)).to(device)
                        for a in sp))


def build_counts(ring: torch.Tensor, wr: int, last_n: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, V) int32 occurrence counts of each slot's newest last_n ring
    entries."""
    W, B = ring.shape
    age = (wr - 1 - torch.arange(W, device=ring.device)) % W          # (W,)
    valid = (age[:, None] < last_n[None, :]) & (ring >= 0)            # (W, B)
    tok = torch.where(valid, ring, vocab).to(torch.long)              # OOB drops
    counts = torch.zeros((B, vocab + 1), dtype=torch.int32, device=ring.device)
    counts.scatter_add_(1, tok.T, torch.ones_like(tok.T, dtype=torch.int32))
    return counts[:, :vocab].contiguous()


def push_token(ring: torch.Tensor, wr: int, counts: torch.Tensor,
               last_n: torch.Tensor, new_tok: torch.Tensor,
               active: torch.Tensor):
    """Advance the penalty window by one fed token per slot -> (ring, wr + 1,
    counts), new tensors (the inputs are not changed)."""
    W, _ = ring.shape
    # the entry ageing past each slot's window leaves the counts
    evict_col = ((wr - last_n) % W).to(torch.long)                   # (B,)
    old = ring.T.gather(1, evict_col[:, None])[:, 0]
    old_ok = active & (old >= 0) & (last_n > 0)
    new_ok = active & (last_n > 0)
    counts = counts.clone()
    counts.scatter_add_(1, old.clamp(min=0).to(torch.long)[:, None],
                        -old_ok.to(torch.int32)[:, None])
    counts.scatter_add_(1, new_tok.to(torch.long)[:, None],
                        new_ok.to(torch.int32)[:, None])
    ring = ring.clone()
    ring[wr % W] = torch.where(active, new_tok.to(ring.dtype), ring[wr % W])
    return ring, wr + 1, counts


def apply_penalties(lg: torch.Tensor, counts: torch.Tensor, sp: SampParams,
                    nl_id: int, eos_id: int) -> torch.Tensor:
    """llama_sample_repetition_penalties + penalize_nl/ignore_eos masks."""
    used = counts > 0
    rep = sp.pen_repeat[:, None]
    pen = torch.where(used, torch.where(lg > 0, lg / rep, lg * rep), lg)
    pen = (pen - counts.to(torch.float32) * sp.pen_freq[:, None]
           - used.to(torch.float32) * sp.pen_present[:, None])
    # restore the newline logit where penalize_nl is off
    pen[:, nl_id] = torch.where(sp.penalize_nl, pen[:, nl_id], lg[:, nl_id])
    pen[:, eos_id] = torch.where(sp.ignore_eos,
                                 torch.full_like(pen[:, eos_id], -torch.inf),
                                 pen[:, eos_id])
    return pen


def _softmax(v: torch.Tensor) -> torch.Tensor:
    m = torch.amax(v, dim=-1, keepdim=True)
    e = torch.exp(v - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def _rank_cut(probs: torch.Tensor, order: torch.Tensor, p: torch.Tensor
              ) -> torch.Tensor:
    """keep mask: the first `cut` entries in `order`, cut = the count of
    cumulative probabilities below p, plus 1."""
    rank = torch.argsort(order, dim=-1, stable=True)
    csum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    cut = torch.sum((csum < p[:, None]).to(torch.int32), dim=-1,
                    keepdim=True) + 1
    return rank < cut


def filter_candidates(pen: torch.Tensor, sp: SampParams):
    """Default sampler queue on penalized (B, V) logits.

    Returns (kv, ki): top-K_CHAIN candidate logits (filtered entries at
    -1e30) and their token ids; kv[:, 0] is the penalized argmax."""
    kv, ki = torch.sort(pen, dim=-1, descending=True, stable=True)
    kv, ki = kv[:, :K_CHAIN], ki[:, :K_CHAIN]
    col = torch.arange(K_CHAIN, device=pen.device)[None, :]
    neg = torch.tensor(-1e30, dtype=torch.float32, device=pen.device)

    # per-slot top_k: a rank cut on the already-sorted candidates
    kv = torch.where(col < sp.top_k[:, None], kv, neg)

    # tail-free (llama_sample_tail_free): |second derivative| mass cut
    probs = _softmax(kv)
    d2 = torch.abs(torch.diff(torch.diff(probs, dim=-1), dim=-1))   # (B, K-2)
    s = torch.sum(d2, dim=-1, keepdim=True)
    d2n = torch.where(s > 0, d2 / torch.where(s > 0, s, 1.0), 0.0)
    csum = torch.cumsum(d2n, dim=-1)
    cut = torch.sum((csum < sp.tfs_z[:, None]).to(torch.int32), dim=-1,
                    keepdim=True) + 1
    keep_tfs = (col < cut) | (sp.tfs_z[:, None] >= 1.0) | (s <= 0)
    kv = torch.where(keep_tfs, kv, neg)

    # locally-typical: order by |-log p - H| ascending, cumulative-prob cut
    probs = _softmax(kv)
    logp = torch.log(torch.clamp(probs, min=1e-30))
    ent = -torch.sum(torch.where(probs > 0, probs * logp, 0.0), dim=-1,
                     keepdim=True)
    t_order = torch.argsort(torch.abs(-logp - ent), dim=-1, stable=True)
    keep_typ = _rank_cut(probs, t_order, sp.typical_p) \
        | (sp.typical_p[:, None] >= 1.0)
    kv = torch.where(keep_typ, kv, neg)

    # top-p on the surviving set (rank by current logits desc)
    probs = _softmax(kv)
    p_order = torch.argsort(-kv, dim=-1, stable=True)
    keep_p = _rank_cut(probs, p_order, sp.top_p) | (sp.top_p[:, None] >= 1.0)
    kv = torch.where(keep_p, kv, neg)

    # min-p: drop below min_p * max_prob (max always survives)
    probs = _softmax(kv)
    limit = torch.amax(probs, dim=-1, keepdim=True) * sp.min_p[:, None]
    kv = torch.where((probs >= limit) | (sp.min_p[:, None] <= 0.0), kv, neg)
    return kv, ki


def gumbel_argmax(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One categorical draw a row from unnormalized log-probabilities:
    argmax(logits - log(E)), E ~ Exp(1) from `gen` (no host sync)."""
    e = torch.empty_like(logits, dtype=torch.float32).exponential_(
        1.0, generator=gen)
    return torch.argmax(logits.to(torch.float32) - torch.log(e), dim=-1)


def sample_chain(lg: torch.Tensor, gen: torch.Generator, sp: SampParams,
                 counts: torch.Tensor, nl_id: int, eos_id: int
                 ) -> torch.Tensor:
    """One sampling step: penalties + default queue on (B, V) logits ->
    next tokens (B,) int64. temp <= 0 slots take argmax-after-penalties
    (the host sampler's greedy); every step draws from `gen`, as the JAX
    chain splits its key every step."""
    pen = apply_penalties(lg.to(torch.float32), counts, sp, nl_id, eos_id)
    kv, ki = filter_candidates(pen, sp)
    cat = gumbel_argmax(kv / torch.clamp(sp.temp, min=1e-6)[:, None], gen)
    pick = torch.gather(ki, -1, cat[:, None])[:, 0]
    return torch.where(sp.temp > 0.0, pick, ki[:, 0])
