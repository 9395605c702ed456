"""Beam-search decoding (counterpart of tpulamm.runtime.beam) —
llama_beam_search parity (llama.h:905, llama.cpp beam-search machinery +
examples/beam-search, 262 LoC).

Beams live on engine slots; forking a beam copies its KV cells with
seq_cp (the reference does the same with llama_kv_cache_seq_cp). Each step
every live beam scores its next-token distribution in ONE batched decode
step, the top n_beams continuations by cumulative logprob survive, and
beams ending in EOS retire to a done-list. Returns the best sequence by
length-normalized logprob.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max()
    e = x - m
    return e - np.log(np.exp(e).sum())


@dataclass
class Beam:
    tokens: list[int] = field(default_factory=list)
    logprob: float = 0.0
    slot: int = 0
    last: int = -1                  # last decoded token (pending KV write)

    def score(self) -> float:
        return self.logprob / max(len(self.tokens), 1)


def beam_search(engine, prompt, *, n_beams: int = 4, n_predict: int = 64,
                slot_base: int = 0) -> tuple[list[int], float]:
    """Returns (best token sequence, length-normalized logprob)."""
    assert not engine.recurrent or n_beams == 1, \
        "beam forking needs copyable state"
    assert slot_base + n_beams <= engine.n_slots, \
        f"beam search needs {n_beams} slots (engine has {engine.n_slots})"
    if isinstance(prompt, str):
        tokens = engine.tokenizer.encode(prompt, special=True)
    else:
        tokens = list(prompt)
    eos = engine.tokenizer.vocab.eos_id if engine.tokenizer else 2

    for s in range(slot_base, slot_base + n_beams):
        engine.reset_slot(s)
    logits = engine.prefill(slot_base, tokens)
    lp = _log_softmax(logits.astype(np.float64))
    top = np.argsort(-lp)[:n_beams]
    beams: list[Beam] = []
    for j, t in enumerate(top):
        s = slot_base + j
        if j > 0:
            engine.seq_cp(slot_base, s)
        beams.append(Beam(tokens=[int(t)], logprob=float(lp[t]), slot=s,
                          last=int(t)))
    done: list[Beam] = []

    for _ in range(n_predict - 1):
        live = [b for b in beams if b.last != eos]
        for b in beams:
            if b.last == eos:
                done.append(b)
        if not live:
            break
        step = {b.slot: b.last for b in live}
        logits = engine.decode_batch(step)
        # candidate pool: every live beam x top n_beams tokens
        cands = []
        for b in live:
            lp = _log_softmax(logits[b.slot].astype(np.float64))
            for t in np.argsort(-lp)[:n_beams]:
                cands.append((b.logprob + float(lp[t]), b, int(t)))
        cands.sort(key=lambda c: -c[0])
        cands = cands[:n_beams]

        # slot assignment: beams keep their slot for their first child;
        # extra children fork via seq_cp into slots of dropped AND retired
        # beams (a beam ending in EOS frees its slot)
        used_parents: set[int] = set()
        freed = [b.slot for b in beams
                 if not any(c[1] is b for c in cands)]
        new_beams = []
        for logprob, parent, tok in cands:
            if parent.slot not in used_parents:
                used_parents.add(parent.slot)
                slot = parent.slot
            else:
                slot = freed.pop()
                engine.seq_cp(parent.slot, slot)
            new_beams.append(Beam(tokens=parent.tokens + [tok],
                                  logprob=logprob, slot=slot, last=tok))
        beams = new_beams

    done.extend(beams)
    best = max(done, key=lambda b: b.score())
    toks = best.tokens
    if toks and toks[-1] == eos:
        toks = toks[:-1]
    return toks, best.score()
