"""Sampling suite — parity with llama_sample_* (llama.cpp:10673-11260) and the
configurable sampler chain of common/sampling.cpp (sampler_queue :127-161).

Operates on host numpy logits (the reference samples on CPU too; logits are
one (vocab,) vector per sequence, so host-side sampling costs nothing next to
the device forward pass). Greedy/dist/penalties/top-k/top-p/min-p/tail-free/
typical/temp(+dynatemp)/mirostat v1+v2 are all implemented.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SamplingParams:
    """Field-compatible subset of llama_sampling_params (common/sampling.h)."""
    seed: int = 0xFFFFFFFF
    n_prev: int = 64
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    tfs_z: float = 1.0
    typical_p: float = 1.0
    temp: float = 0.8
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    penalty_last_n: int = 64
    penalty_repeat: float = 1.1
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    mirostat: int = 0              # 0 off, 1 v1, 2 v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    penalize_nl: bool = True
    samplers_sequence: str = "kfypmt"   # top_k,tfs,typical,top_p,min_p,temp
    logit_bias: dict[int, float] = field(default_factory=dict)
    ignore_eos: bool = False
    n_probs: int = 0               # top-N token probs per emitted token
    #                                (server.cpp n_probs / OpenAI logprobs)


def softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max()
    e = np.exp(logits - m)
    return e / e.sum()


def top_k(logits: np.ndarray, k: int) -> np.ndarray:
    """Keep k highest logits, -inf the rest (llama_sample_top_k)."""
    if k <= 0 or k >= logits.size:
        return logits
    kth = np.partition(logits, -k)[-k]
    out = np.where(logits >= kth, logits, -np.inf)
    return out


def top_p(logits: np.ndarray, p: float, min_keep: int = 1) -> np.ndarray:
    if p >= 1.0:
        return logits
    order = np.argsort(-logits)
    probs = softmax(logits[order])
    csum = np.cumsum(probs)
    cut = np.searchsorted(csum, p) + 1
    cut = max(cut, min_keep)
    mask = np.full_like(logits, -np.inf)
    keep = order[:cut]
    mask[keep] = logits[keep]
    return mask


def min_p(logits: np.ndarray, p: float, min_keep: int = 1) -> np.ndarray:
    """Drop tokens below p * max_prob (llama_sample_min_p)."""
    if p <= 0.0:
        return logits
    probs = softmax(logits)
    limit = probs.max() * p
    keep = probs >= limit
    if keep.sum() < min_keep:
        order = np.argsort(-logits)[:min_keep]
        keep[:] = False
        keep[order] = True
    return np.where(keep, logits, -np.inf)


def tail_free(logits: np.ndarray, z: float, min_keep: int = 1) -> np.ndarray:
    """Tail-free sampling via second-derivative mass (llama_sample_tail_free)."""
    if z >= 1.0 or logits.size <= 2:
        return logits
    order = np.argsort(-logits)
    probs = softmax(logits[order])
    d2 = np.abs(np.diff(probs, n=2))
    s = d2.sum()
    if s == 0:
        return logits
    d2 = d2 / s
    csum = np.cumsum(d2)
    cut = int(np.searchsorted(csum, z)) + 1
    cut = max(cut, min_keep)
    mask = np.full_like(logits, -np.inf)
    keep = order[:cut]
    mask[keep] = logits[keep]
    return mask


def typical(logits: np.ndarray, p: float, min_keep: int = 1) -> np.ndarray:
    """Locally-typical sampling (llama_sample_typical)."""
    if p >= 1.0:
        return logits
    probs = softmax(logits)
    with np.errstate(divide="ignore"):
        ent = -np.sum(np.where(probs > 0, probs * np.log(probs), 0.0))
    shifted = np.abs(-np.where(probs > 0, np.log(probs), np.inf) - ent)
    order = np.argsort(shifted)
    csum = np.cumsum(probs[order])
    cut = int(np.searchsorted(csum, p)) + 1
    cut = max(cut, min_keep)
    mask = np.full_like(logits, -np.inf)
    keep = order[:cut]
    mask[keep] = logits[keep]
    return mask


def apply_temp(logits: np.ndarray, temp: float, dynatemp_range: float = 0.0,
               dynatemp_exponent: float = 1.0) -> np.ndarray:
    if dynatemp_range > 0:
        # entropy-scaled temperature (llama_sample_entropy)
        lo = max(0.0, temp - dynatemp_range)
        hi = temp + dynatemp_range
        probs = softmax(logits)
        with np.errstate(divide="ignore", invalid="ignore"):
            ent = -np.sum(np.where(probs > 0, probs * np.log(probs), 0.0))
        n = np.count_nonzero(np.isfinite(logits))
        max_ent = np.log(max(n, 2))
        norm = (ent / max_ent) ** dynatemp_exponent if max_ent > 0 else 0.0
        t = lo + (hi - lo) * norm
        return logits / max(t, 1e-6)
    if temp <= 0:
        return logits
    return logits / temp


def apply_guidance(logits: np.ndarray, logits_guidance: np.ndarray,
                   scale: float) -> np.ndarray:
    """Classifier-free guidance (llama_sample_apply_guidance): log-softmax
    both, then l = scale*(l - g) + g."""
    def logsm(x):
        m = x.max()
        return x - m - np.log(np.exp(x - m).sum())
    l = logsm(np.asarray(logits, np.float32))
    g = logsm(np.asarray(logits_guidance, np.float32))
    return scale * (l - g) + g


def apply_penalties(logits: np.ndarray, prev: list[int], penalty_repeat: float,
                    penalty_freq: float, penalty_present: float) -> np.ndarray:
    """llama_sample_repetition_penalties semantics."""
    if not prev or (penalty_repeat == 1.0 and penalty_freq == 0.0
                    and penalty_present == 0.0):
        return logits
    out = logits.copy()
    ids, counts = np.unique(np.asarray(prev, np.int64), return_counts=True)
    sel = out[ids]
    sel = np.where(sel <= 0, sel * penalty_repeat, sel / penalty_repeat)
    sel = sel - counts * penalty_freq - (counts > 0) * penalty_present
    out[ids] = sel
    return out


class Sampler:
    """Stateful sampling context (llama_sampling_context equivalent)."""

    def __init__(self, params: SamplingParams, vocab_size: int,
                 eos_id: int = 2, nl_id: int = 13,
                 grammar=None, token_pieces: list[bytes] | None = None):
        """grammar: tpulamm.grammar.engine.Grammar; token_pieces: raw piece
        bytes per token id (required when a grammar is set)."""
        self.params = params
        self.vocab_size = vocab_size
        self.eos_id = eos_id
        self.nl_id = nl_id
        self.grammar = grammar
        self.token_pieces = token_pieces
        if grammar is not None:
            assert token_pieces is not None, "grammar requires token_pieces"
        self.prev: list[int] = []
        self.mu: float | None = None  # mirostat state
        seed = params.seed
        if seed in (-1, 0xFFFFFFFF):
            seed = np.random.SeedSequence().entropy % (2**32)
        self.rng = np.random.default_rng(seed)

    def reset(self):
        self.prev.clear()
        self.mu = None

    def accept(self, tok: int, apply_grammar: bool = True):
        """llama_sampling_accept: track history; advance grammar state."""
        self.prev.append(tok)
        if len(self.prev) > max(self.params.n_prev,
                                self.params.penalty_last_n):
            self.prev.pop(0)
        if self.grammar is not None and apply_grammar and tok != self.eos_id:
            self.grammar.accept_token(self.token_pieces[tok])

    # -- grammar constraint (llama_sample_grammar, llama.cpp:11125) ---------
    def _grammar_ok(self, tok: int) -> bool:
        if tok == self.eos_id:
            return self.grammar.can_stop()
        piece = self.token_pieces[tok]
        return tok not in self.grammar.reject_tokens({tok: piece})

    def _apply_grammar(self, logits: np.ndarray) -> np.ndarray:
        out = logits.copy()
        finite = np.flatnonzero(np.isfinite(out))
        pieces = {int(t): self.token_pieces[int(t)] for t in finite
                  if t != self.eos_id}
        for t in self.grammar.reject_tokens(pieces):
            out[t] = -np.inf
        if not self.grammar.can_stop():
            out[self.eos_id] = -np.inf
        return out

    # -- main entry (llama_sampling_sample, common/sampling.cpp:163-298) ----
    def sample(self, logits: np.ndarray) -> int:
        """Sample; if a grammar is set and the pick violates it, re-sample
        with the grammar constraint applied first (the reference's
        resample-after-grammar logic, sampling.cpp:276-294)."""
        tok = self._sample_impl(logits)
        if self.grammar is not None and not self._grammar_ok(tok):
            masked = self._apply_grammar(np.asarray(logits, np.float32))
            tok = self._sample_impl(masked)
        return tok

    def _sample_impl(self, logits: np.ndarray) -> int:
        p = self.params
        logits = np.asarray(logits, np.float32).copy()

        for tid, bias in p.logit_bias.items():
            logits[tid] += bias
        if p.ignore_eos:
            logits[self.eos_id] = -np.inf

        nl_logit = logits[self.nl_id] if self.nl_id < logits.size else None
        # penalty_last_n < 0 = whole context (common.cpp maps -1 -> n_ctx)
        last = (list(self.prev) if p.penalty_last_n < 0
                else self.prev[-p.penalty_last_n:]) \
            if p.penalty_last_n else []
        logits = apply_penalties(logits, last, p.penalty_repeat,
                                 p.penalty_freq, p.penalty_present)
        if not p.penalize_nl and nl_logit is not None:
            logits[self.nl_id] = nl_logit

        if p.temp < 0.0:
            # "sample with probs" greedy: softmax then argmax
            return int(np.argmax(softmax(logits)))
        if p.temp == 0.0:
            return int(np.argmax(logits))

        if p.mirostat == 1:
            return self._mirostat_v1(logits)
        if p.mirostat == 2:
            return self._mirostat_v2(logits)

        # sampler queue in configured order (sampler_queue :127-161)
        for ch in p.samplers_sequence:
            if ch == "k":
                logits = top_k(logits, p.top_k)
            elif ch == "f":
                logits = tail_free(logits, p.tfs_z)
            elif ch == "y":
                logits = typical(logits, p.typical_p)
            elif ch == "p":
                logits = top_p(logits, p.top_p)
            elif ch == "m":
                logits = min_p(logits, p.min_p)
            elif ch == "t":
                logits = apply_temp(logits, p.temp, p.dynatemp_range,
                                    p.dynatemp_exponent)
        return self._dist(logits)

    def _dist(self, logits: np.ndarray) -> int:
        probs = softmax(logits)
        return int(self.rng.choice(probs.size, p=probs))

    def _mirostat_v1(self, logits: np.ndarray) -> int:
        p = self.params
        if self.mu is None:
            self.mu = 2.0 * p.mirostat_tau
        probs = softmax(apply_temp(logits, p.temp))
        order = np.argsort(-probs)
        sp = probs[order]
        m = 100
        # estimate Zipf exponent s_hat from top-m probabilities
        idx = np.arange(1, min(m, sp.size))
        ti = np.log((idx + 1) / idx)
        b = np.log(sp[:len(idx)] / sp[1:len(idx) + 1])
        s_hat = float(np.sum(ti * b) / np.sum(ti * ti))
        eps = s_hat - 1
        n = self.vocab_size
        k = int(((eps * (2 ** self.mu)) / (1 - n ** (-eps))) ** (1 / s_hat))
        k = max(1, min(k, sp.size))
        keep = order[:k]
        masked = np.full_like(logits, -np.inf)
        masked[keep] = logits[keep]
        tok = self._dist(apply_temp(masked, p.temp))
        surprise = -np.log2(probs[tok] + 1e-30)
        self.mu -= p.mirostat_eta * (surprise - p.mirostat_tau)
        return tok

    def _mirostat_v2(self, logits: np.ndarray) -> int:
        p = self.params
        if self.mu is None:
            self.mu = 2.0 * p.mirostat_tau
        scaled = apply_temp(logits, p.temp)
        probs = softmax(scaled)
        surprises = -np.log2(probs + 1e-30)
        keep = surprises <= self.mu
        if not keep.any():
            keep[np.argmax(probs)] = True
        masked = np.where(keep, scaled, -np.inf)
        tok = self._dist(masked)
        surprise = float(surprises[tok])
        self.mu -= p.mirostat_eta * (surprise - p.mirostat_tau)
        return tok
