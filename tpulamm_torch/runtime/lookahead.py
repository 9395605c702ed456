"""Lookahead decoding (counterpart of tpulamm.runtime.lookahead;
examples/lookahead parity).

The algorithm (lmsys lookahead decoding): a W-wide, (N-1)-level Jacobi
window guesses future tokens; every step evaluates, in ONE compound batch,
the input token, up to G verification n-grams from a per-first-token pool,
and the whole window — then accepts the longest verified n-gram prefix,
shifts the window one level, and harvests new n-grams from the window
diagonals.

The reference expresses the batch structure with per-token seq_id lists
(lookahead.cpp:183-260); here the same visibility is encoded in packed
per-token segment ranges (engine.eval_segmented / KVCache.seg):
- input token: segment 0 (visible to everything)
- window level 0, column i: range [i+1, W]  (columns >= i see it — the
  reference's seq_ids {i+1..W})
- window level j>=1, column i: range [i+1, i+1]
- verification n-gram g: range [W+1+g, W+1+g]

Accepted tokens are re-evaluated into the main sequence after rollback
(simpler than the reference's seq_keep/seq_cp surgery; one extra small
forward per step).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpulamm_torch.runtime.sampling import SamplingParams
from tpulamm_torch.runtime.speculative import (SpecStats, _mk_sampler,
                                               _tokens)


def _pack(lo: int, hi: int) -> int:
    return lo | (hi << 16)


@dataclass
class _NgramPool:
    """Per-first-token ring buffer of (N-1)-grams (ngram_container)."""
    N: int
    G: int

    def __post_init__(self):
        self.grams: dict[int, list[tuple[int, ...]]] = {}
        self.heads: dict[int, int] = {}

    def get(self, first: int) -> list[tuple[int, ...]]:
        return self.grams.get(first, [])

    def add(self, first: int, gram: tuple[int, ...]):
        lst = self.grams.setdefault(first, [])
        if gram in lst:
            return
        if len(lst) < self.G:
            lst.append(gram)
        else:
            h = self.heads.get(first, 0)
            lst[h] = gram
            self.heads[first] = (h + 1) % self.G


def generate_lookahead(engine, prompt, *, n_predict: int = 128,
                       sampling: SamplingParams | None = None,
                       W: int = 8, N: int = 4, G: int = 8, slot: int = 0,
                       stop_on_eos: bool = True, stream=None):
    """Returns (token_ids, text, stats). The compound batch of each step
    runs through engine.eval_segmented (the einsum attention with the
    segment mask), the kept tokens through eval_tokens."""
    tokens = _tokens(engine, prompt)
    sampler = _mk_sampler(engine, sampling)
    for t in tokens:
        sampler.accept(t, apply_grammar=False)
    eos = engine.tokenizer.vocab.eos_id if engine.tokenizer else 2

    logits = engine.prefill(slot, tokens)
    cur = sampler.sample(logits)
    sampler.accept(cur)

    # Jacobi window init (lookahead.cpp:139-144 "sequence of increasing
    # numbers" — any init works; we seed from the prompt tail)
    seed = (tokens * ((W * (N - 1)) // max(len(tokens), 1) + 1))
    win = [[seed[(j * W + i) % len(seed)] for i in range(W)]
           for j in range(N - 1)]
    pool = _NgramPool(N=N, G=G)
    stats = SpecStats()
    out: list[int] = []
    # stream via an incremental UTF-8 decoder (byte tokens can split
    # multi-byte sequences across steps — same as Engine.generate)
    import codecs
    sdec = codecs.getincrementaldecoder("utf-8")("replace")

    def emit(tok):
        if stream is not None and engine.tokenizer is not None:
            piece = sdec.decode(engine.tokenizer.token_bytes(tok))
            if piece:
                stream(piece)

    while len(out) < n_predict:
        if stop_on_eos and cur == eos and not sampler.params.ignore_eos:
            break
        out.append(cur)
        emit(cur)
        if len(out) >= n_predict:
            break

        n_past = int(engine.n_past[slot])
        # ---- build the compound batch --------------------------------------
        toks = [cur]
        poss = [n_past]
        segs = [0]
        # verification n-grams
        grams = pool.get(cur)[:G]
        gram_idx = []            # batch index of each gram token
        for g, gram in enumerate(grams):
            idx = []
            for j, t in enumerate(gram):
                idx.append(len(toks))
                toks.append(t)
                poss.append(n_past + 1 + j)
                segs.append(_pack(W + 1 + g, W + 1 + g))
            gram_idx.append(idx)
        # window level 0, columns 1..W-1 (column 0 is `cur`)
        lvl0_idx = [0] + [0] * (W - 1)
        for i in range(1, W):
            lvl0_idx[i] = len(toks)
            toks.append(win[0][i])
            poss.append(n_past + i)
            segs.append(_pack(i + 1, W))
        # levels 1..N-2 (diagonal positions)
        lvl_idx = [lvl0_idx] + [[0] * W for _ in range(N - 2)]
        for j in range(1, N - 1):
            for i in range(W):
                lvl_idx[j][i] = len(toks)
                toks.append(win[j][i])
                poss.append(n_past + j + i)
                segs.append(_pack(i + 1, i + 1))

        stats.n_target_steps += 1
        stats.n_drafted += sum(len(g) for g in grams)
        logits_all = engine.eval_segmented(
            slot, np.asarray(toks, np.int32), np.asarray(poss, np.int32),
            np.asarray(segs, np.int32))

        # ---- verify n-grams + shift window (lookahead.cpp:266-435; the
        # window shifts once per accepted token, last level resampled from
        # the batch logits only at v=0) --------------------------------------
        active = list(range(len(grams)))
        accepted: list[int] = []
        nxt = None
        hit_eos = False
        for v in range(N):
            if v == 0:
                i_batch = 0
            else:
                if not active or hit_eos:
                    break
                g = active[0]
                i_batch = gram_idx[g][v - 1]
                stats.n_accepted += 1
            tok = sampler.sample(logits_all[i_batch])
            sampler.accept(tok)
            if v > 0:
                accepted.append(tok)
            else:
                nxt = tok
            if stop_on_eos and tok == eos and not sampler.params.ignore_eos:
                hit_eos = True
            # keep grams whose next token matches
            active = [g for g in active
                      if v < N - 1 and v < len(grams[g])
                      and grams[g][v] == tok]

            # window shift (inside the v loop, as in the reference)
            prev_lvl0 = list(win[0])
            for j in range(N - 2):
                win[j] = win[j + 1]
            if v == 0:
                win[N - 2] = [int(np.argmax(logits_all[lvl_idx[N - 2][i]]))
                              for i in range(W)]
                # harvest new n-grams from the shifted diagonals
                for f in range(W):
                    pool.add(prev_lvl0[f],
                             tuple(win[j][f] for j in range(N - 1)))
            else:
                win[N - 2] = list(win[0])

        # ---- KV management ---------------------------------------------------
        # sampled tokens in order: v=0 first, then the gram-verified ones;
        # the LAST becomes the next input (emitted at the next loop top).
        # Drop every batch cell, then replay the kept positions into the
        # main sequence (the reference's seq_rm + seq_keep/seq_cp surgery,
        # lookahead.cpp:441-456, done here as rollback + re-eval).
        new_tokens = [nxt] + accepted
        engine.rollback(slot, n_past)
        engine.eval_tokens(slot, [cur] + new_tokens[:-1])
        stop = False
        for t in new_tokens[:-1]:
            if stop_on_eos and t == eos and not sampler.params.ignore_eos:
                stop = True
                break
            out.append(t)
            emit(t)
            if len(out) >= n_predict:
                break
        if stop:
            break
        cur = new_tokens[-1]   # outer loop handles cur == eos

    text = engine.tokenizer.decode(out) if engine.tokenizer else ""
    return out, text, stats
