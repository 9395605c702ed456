"""Speculative decoding: draft-model and prompt-lookup (n-gram) drafting
(counterpart of tpulamm.runtime.speculative).

Capability parity with the reference's decode-loop examples:
- examples/speculative/speculative.cpp: a small draft model proposes
  n_draft tokens; the target scores the whole draft in ONE forward; the
  accepted prefix is the longest one where the target's own choice equals
  the draft; rejected KV cells are dropped (llama_kv_cache_seq_rm).
- examples/lookup/lookup.cpp: prompt n-gram speculation -- the draft comes
  from matching the most recent n-gram of the context against earlier
  context, no second model needed.

Two forms, as in the JAX package:
- the host loops (generate_speculative, generate_prompt_lookup): one
  (1+k)-token `eval_tokens` verify a step, sampled on the host Sampler
  (grammar, streaming);
- the device blocks (generate_speculative_fast,
  generate_prompt_lookup_fast, and the engine's serving hooks
  spec_lookup_block, spec_lookup_block_multi, spec_draft_block). The JAX
  package runs the whole propose / verify / accept loop in one jitted
  lax.while_loop. Here one CYCLE -- k draft steps and the draft's last KV
  write (or the n-gram search over a history on the device), the (1+k)
  target verify, the acceptance -- is captured once into a CUDA graph
  for each key, in the target engine's graph pool (runtime.decode_graph),
  and a block replays it. Token, position, emitted count, budget and an
  active word live in device buffers (CycleBuffers); a cycle whose row is
  no longer active (EOS, budget, context, max_steps) writes only the trash
  cell and moves no counter, so a replay past the end changes nothing. A
  block replays the graph in chunks of ceil(remaining / (k + 1)) cycles
  (none can overshoot the budget at zero acceptance) and reads the state
  back once a chunk: an idle replay still runs every kernel, and the host
  cannot see `done` without a copy.

Acceptance (all on the device):
- greedy: the longest prefix where the target's argmax equals the draft;
  output-invariant (emitted tokens equal plain greedy decoding);
- stochastic (temp > 0, one vocabulary; speculative.cpp:245-295): the
  draft samples d ~ q, accept iff u q(d) <= p(d), the first rejection
  resamples normalize(max(p - q, 0)). `_stochastic_accept` takes its
  uniforms and Gumbel noise as arguments, so a test can feed it the JAX
  package's draws;
- token match (temp > 0 otherwise, and the lookup tiers): a target sample
  per position, accepted while it equals the draft.
Sampled draws come from the target engine's torch.Generator (registered
with the graph), not from JAX keys: the draws differ from the JAX
package's by design; greedy tokens do not.

After a block the host mirrors move over the emitted prefix only
(n_past = pos, cell_pos[start:pos]); a rejected cell keeps its position
above pos on the device until the next verify overwrites it, masked
causally meanwhile, as in the JAX engine. The final rollback drops it.
"""

from __future__ import annotations

import codecs
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpulamm_torch.models.llama import forward
from tpulamm_torch.ops.device_sampling import gumbel_argmax
from tpulamm_torch.runtime.sampling import Sampler, SamplingParams


@dataclass
class SpecStats:
    n_drafted: int = 0
    n_accepted: int = 0
    n_target_steps: int = 0

    @property
    def accept_rate(self) -> float:
        return self.n_accepted / max(self.n_drafted, 1)


def _mk_sampler(engine, sampling: SamplingParams | None,
                grammar=None) -> Sampler:
    sampling = sampling or SamplingParams()
    eos = engine.tokenizer.vocab.eos_id if engine.tokenizer else 2
    pieces = engine.token_pieces() if grammar is not None else None
    return Sampler(sampling, engine.cfg.vocab_size, eos_id=eos,
                   grammar=grammar, token_pieces=pieces)


def _tokens(engine, prompt) -> list[int]:
    if isinstance(prompt, str):
        assert engine.tokenizer is not None
        return engine.tokenizer.encode(prompt, special=True)
    return list(prompt)


def _grammar(grammar):
    if grammar is not None and isinstance(grammar, str):
        from tpulamm_torch.grammar.engine import Grammar
        return Grammar.from_gbnf(grammar)
    return grammar


def _spec_loop(target, sampler: Sampler, first_logits: np.ndarray,
               propose, on_accept, n_predict: int, eos: int,
               stop_on_eos: bool, slot: int, stream=None):
    """Shared verify loop: `propose(cur)` -> draft list; `on_accept(toks)`
    keeps auxiliary state (draft engine / history) in sync."""
    stats = SpecStats()
    out: list[int] = []
    # byte tokens may split multi-byte UTF-8 across steps
    sdec = codecs.getincrementaldecoder("utf-8")("replace")

    def emit(tok):
        if stream is not None and target.tokenizer is not None:
            piece = sdec.decode(target.tokenizer.token_bytes(tok))
            if piece:
                stream(piece)

    cur = sampler.sample(first_logits)
    sampler.accept(cur)
    while len(out) < n_predict:
        if stop_on_eos and cur == eos and not sampler.params.ignore_eos:
            break
        out.append(cur)
        emit(cur)
        if len(out) >= n_predict:
            break
        draft = propose(cur)
        stats.n_drafted += len(draft)
        stats.n_target_steps += 1
        base = int(target.n_past[slot])
        logits = target.eval_tokens(slot, [cur] + draft)   # (1+k, vocab)
        accepted: list[int] = []
        nxt = None
        for i in range(len(draft) + 1):
            tok = sampler.sample(logits[i])
            if i < len(draft) and tok == draft[i]:
                sampler.accept(tok)
                accepted.append(tok)
            else:
                nxt = tok
                break
        stats.n_accepted += len(accepted)
        # keep only [cur] + accepted in the target KV
        target.rollback(slot, base + 1 + len(accepted))
        on_accept([cur] + accepted)
        hit_eos = False
        for t in accepted:
            if stop_on_eos and t == eos and not sampler.params.ignore_eos:
                hit_eos = True       # accepted draft ended the sequence
                break
            out.append(t)
            emit(t)
        if hit_eos:
            break
        sampler.accept(nxt)
        cur = nxt
    return out, stats


def generate_speculative(target, draft, prompt, *, n_predict: int = 128,
                         sampling: SamplingParams | None = None,
                         n_draft: int = 5, slot: int = 0,
                         stop_on_eos: bool = True, stream=None, grammar=None):
    """Draft-model speculative decoding on the host (speculative.cpp
    parity): the draft proposes greedily by decode_one, the target
    verifies with eval_tokens and the host Sampler."""
    tokens = _tokens(target, prompt)
    sampler = _mk_sampler(target, sampling, _grammar(grammar))
    for t in tokens:
        sampler.accept(t, apply_grammar=False)

    logits = target.prefill(slot, tokens)
    draft.prefill(slot, tokens)

    def propose(cur: int) -> list[int]:
        # draft greedily proposes n_draft continuations of cur
        base = int(draft.n_past[slot])
        toks: list[int] = []
        lg = draft.decode_one(slot, cur)
        for _ in range(n_draft):
            t = int(np.argmax(lg))
            toks.append(t)
            if len(toks) < n_draft:
                lg = draft.decode_one(slot, t)
        # drop the drafted cells; on_accept replays the accepted prefix
        draft.rollback(slot, base)
        return toks

    def on_accept(chunk: list[int]):
        draft.eval_tokens(slot, chunk)

    eos = target._eos()
    out, stats = _spec_loop(target, sampler, logits, propose, on_accept,
                            n_predict, eos, stop_on_eos, slot, stream)
    text = target.tokenizer.decode(out) if target.tokenizer else ""
    return out, text, stats


def find_ngram_draft(history: list[int], n_draft: int,
                     ngram_min: int = 1, ngram_max: int = 4) -> list[int]:
    """Prompt-lookup proposal: match the most recent n-gram against earlier
    history and copy what followed it (lookup.cpp / common ngram cache)."""
    h = history
    n = len(h)
    for g in range(min(ngram_max, n - 1), ngram_min - 1, -1):
        tail = h[n - g:]
        # search latest earlier occurrence
        for start in range(n - g - 1, -1, -1):
            if h[start:start + g] == tail:
                cont = h[start + g:start + g + n_draft]
                if cont:
                    return cont
    return []


def generate_prompt_lookup(engine, prompt, *, n_predict: int = 128,
                           sampling: SamplingParams | None = None,
                           n_draft: int = 5, ngram_min: int = 1,
                           ngram_max: int = 4, slot: int = 0,
                           stop_on_eos: bool = True, stream=None,
                           grammar=None):
    """Prompt n-gram speculative decoding on the host (lookup.cpp
    parity)."""
    tokens = _tokens(engine, prompt)
    sampler = _mk_sampler(engine, sampling, _grammar(grammar))
    for t in tokens:
        sampler.accept(t, apply_grammar=False)

    logits = engine.prefill(slot, tokens)
    history = list(tokens)

    def propose(cur: int) -> list[int]:
        return find_ngram_draft(history + [cur], n_draft,
                                ngram_min, ngram_max)

    def on_accept(chunk: list[int]):
        history.extend(chunk)

    eos = engine._eos()
    out, stats = _spec_loop(engine, sampler, logits, propose, on_accept,
                            n_predict, eos, stop_on_eos, slot, stream)
    text = engine.tokenizer.decode(out) if engine.tokenizer else ""
    return out, text, stats


# -- the sampling rule (speculative.py:247-303 of the JAX package) ----------

def _dense_dist(lg: torch.Tensor, temp, top_k: int) -> torch.Tensor:
    """(..., V) logits -> the plain sampler's distribution (temp + top-k),
    dense over V: entries below the k-th largest logit get probability 0
    (a boundary tie keeps every tied entry, as in the JAX rule)."""
    t = (torch.clamp(temp, min=1e-6) if isinstance(temp, torch.Tensor)
         else max(float(temp), 1e-6))
    if top_k > 0:
        thr = torch.topk(lg, min(top_k, lg.shape[-1]), dim=-1).values[..., -1:]
        lg = torch.where(lg >= thr, lg, torch.full_like(lg, -float("inf")))
    return torch.softmax(lg / t, dim=-1)


def _dist_sample(dist: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Categorical draw from a dense probability vector (zeros excluded)
    with Gumbel noise g of its shape: jax.random.categorical's form,
    argmax(log p + g)."""
    logp = torch.where(dist > 0, torch.log(dist),
                       torch.full_like(dist, -float("inf")))
    return torch.argmax(logp + g, dim=-1)


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(E), E ~ Exp(1), from `gen`."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -torch.log(e.exponential_(1.0, generator=gen))


def _stochastic_accept(pt: torch.Tensor, qd: torch.Tensor,
                       draft_toks: torch.Tensor, u: torch.Tensor,
                       g: torch.Tensor):
    """Speculative-sampling acceptance with residual resampling
    (speculative.cpp:245-295; Leviathan et al. 2023, thm 1): accept d_i
    iff u_i q_i(d_i) <= p_i(d_i); at the first rejection draw from
    normalize(max(p_i - q_i, 0)); with all k accepted, the bonus token
    draws from p_k. Emitted tokens are distributed as plain target
    sampling for any draft q.

    pt: (k+1, V) target distributions; qd: (k, V) draft distributions;
    draft_toks: (k,); u: (k,) uniforms; g: (V,) Gumbel noise of the
    residual draw. Returns (n_acc, nxt) as 0-d int64 tensors."""
    k = qd.shape[0]
    d = draft_toks.long()[:, None]
    p_at = pt[:k].gather(1, d)[:, 0]
    q_at = qd.gather(1, d)[:, 0]
    # u * q <= p  <=>  u <= p / q (q(d) > 0 since d was drawn from q)
    acc = u * q_at <= p_at
    n_acc = torch.where(acc.all(), k, torch.argmax((~acc).to(torch.int32)))
    p_sel = pt.index_select(0, n_acc.view(1))[0]
    q_row = qd.index_select(0, torch.clamp(n_acc, max=k - 1).view(1))[0]
    q_sel = torch.where(n_acc < k, q_row, torch.zeros_like(q_row))
    res = torch.clamp(p_sel - q_sel, min=0.0)
    den = res.sum()
    # den == 0 on a rejection needs p == q pointwise (probability 0); the
    # p_sel fallback only guards float dust
    dist = torch.where(den > 0, res / torch.clamp(den, min=1e-30), p_sel)
    return n_acc, _dist_sample(dist, g)


def _sample_rows(lg: torch.Tensor, temp: torch.Tensor, top_k: int,
                 gen: torch.Generator) -> torch.Tensor:
    """One target sample a row (Engine._sample_next's rule: top-k, 0 = the
    full vocabulary, at each row's temperature; a Gumbel-max draw from
    `gen`); rows at temp <= 0 take the argmax. lg (N, V), temp (N,)."""
    vals, idx = ((lg, None) if top_k <= 0
                 else torch.topk(lg, min(top_k, lg.shape[-1]), dim=-1))
    j = gumbel_argmax(vals / torch.clamp(temp, min=1e-6)[:, None], gen)
    pick = j if idx is None else idx.gather(-1, j[:, None])[:, 0]
    return torch.where(temp > 0.0, pick, torch.argmax(lg, dim=-1))


def _match_accept(tgt: torch.Tensor, drafts: torch.Tensor) -> torch.Tensor:
    """(B, k+1) target choices, (B, k) drafts -> (B,) accepted lengths:
    the longest prefix where they agree."""
    k = drafts.shape[1]
    miss = (tgt[:, :k] != drafts).to(torch.int32)
    return torch.where(miss.any(dim=1), torch.argmax(miss, dim=1), k)


# -- the device cycle (the body of the JAX while_loop) ----------------------

class CycleBuffers:
    """Static device state of a speculation block over B rows, one int32
    buffer staged in one host-to-device copy and read back in one copy:
    the carried token, position, active word, emitted count, budget, EOS
    id and temperature (f32 bits) a row; the cycle index; the (max_steps +
    1, B, W) emitted rows (-1 padded; the last row takes the writes of an
    idle cycle), (max_steps + 1, B) accepted counts and drafted counts;
    an optional (B, H) token history (prompt lookup), kept last so a read
    skips it."""

    def __init__(self, B: int, W: int, max_steps: int, device,
                 H: int = 0):
        self.B, self.W, self.S, self.H = B, W, max_steps, H
        sizes = {"tok": B, "pos": B, "act": B, "emitted": B, "budget": B,
                 "eos": B, "temp": B, "i": 1,
                 "rows": (max_steps + 1) * B * W,
                 "accs": (max_steps + 1) * B, "drafted": max_steps + 1,
                 "h": B * H}
        self.off = {}
        o = 0
        for name, n in sizes.items():
            self.off[name] = (o, o + n)
            o += n
        self.flat = torch.zeros(o, dtype=torch.int32, device=device)
        v = {n: self.flat[a:b] for n, (a, b) in self.off.items()}
        self.tok, self.pos, self.act = v["tok"], v["pos"], v["act"]
        self.emitted, self.budget, self.eos = (v["emitted"], v["budget"],
                                               v["eos"])
        self.temp = v["temp"].view(torch.float32)
        self.i = v["i"]
        self.rows = v["rows"].view(max_steps + 1, B, W)
        self.accs = v["accs"].view(max_steps + 1, B)
        self.drafted = v["drafted"]
        self.h = v["h"].view(B, H)

    def stage(self, tok, pos, act, budget, eos, temp=None, h=None) -> None:
        host = np.zeros(self.flat.numel(), np.int32)

        def put(name, arr):
            a, b = self.off[name]
            host[a:b] = np.asarray(arr).reshape(-1)
        put("tok", tok)
        put("pos", pos)
        put("act", np.asarray(act, np.int32))
        put("budget", budget)
        put("eos", eos)
        if temp is not None:
            put("temp", np.asarray(temp, np.float32).view(np.int32))
        a, b = self.off["rows"]
        host[a:b] = -1
        if h is not None:
            put("h", h)
        self.flat.copy_(torch.from_numpy(host))

    def stage_idle(self, trash: int) -> None:
        """Inputs under which a cycle writes no live cell: no row active."""
        z = np.zeros(self.B, np.int32)
        self.stage(z, z, z, z, z)

    def read(self) -> dict:
        """The state without the history, in one device-to-host copy."""
        n = self.off["h"][0]
        host = self.flat[:n].to("cpu", copy=True).numpy()

        def get(name):
            a, b = self.off[name]
            return host[a:b]
        S, B, W = self.S, self.B, self.W
        return {"tok": get("tok"), "pos": get("pos"),
                "act": get("act").astype(bool), "emitted": get("emitted"),
                "budget": get("budget"), "i": int(get("i")[0]),
                "rows": get("rows").reshape(S + 1, B, W)[:S],
                "accs": get("accs").reshape(S + 1, B)[:S],
                "drafted": get("drafted")[:S]}

    def finish(self, row: torch.Tensor, n_acc: torch.Tensor,
               nxt: torch.Tensor, hit_eos: torch.Tensor, need: int,
               n_ctx: int, drafted: torch.Tensor | None = None) -> None:
        """The end of a cycle for every row: an active row's emitted row
        and count at the cycle index, its carried token, position and
        emitted count advanced by n_acc + 1; the index + 1 where any row
        ran; a row stays active while it has not hit EOS, has budget, and
        fits another cycle (pos + need + 1 <= n_ctx) and another index."""
        run = self.act.bool()
        anyrun = run.any()
        iw = torch.where(anyrun, self.i, self.S).long()
        self.rows.index_copy_(0, iw, torch.where(
            run[:, None], row.to(torch.int32), -1)[None])
        self.accs.index_copy_(0, iw, torch.where(
            run, n_acc.to(torch.int32), 0)[None])
        if drafted is not None:
            self.drafted.index_copy_(0, iw, drafted.to(torch.int32).view(1))
        n_emit = torch.where(run, n_acc.to(torch.int32) + 1, 0)
        self.tok.copy_(torch.where(run, nxt.to(torch.int32), self.tok))
        self.pos.add_(n_emit)
        self.emitted.add_(n_emit)
        self.i.add_(anyrun.to(torch.int32))
        self.act.copy_((run & ~hit_eos & (self.emitted < self.budget)
                        & (self.pos + need + 1 <= n_ctx)
                        & (self.i < self.S)).to(torch.int32))


def run_block(g, k: int, remaining: int) -> dict:
    """Replay the staged cycle until no row is active or max_steps cycles
    ran: chunks of ceil(remaining / (k + 1)) replays, none of which can
    overshoot the largest active budget at zero acceptance, then one read
    of the state. `remaining`: the largest staged budget."""
    bufs = g.bufs
    i = 0
    while True:
        n = min(max(1, -(-remaining // (k + 1))), bufs.S - i)
        with torch.no_grad():
            for _ in range(n):
                g.replay()
        st = bufs.read()
        i = st["i"]
        if not st["act"].any() or i >= bufs.S:
            return st
        remaining = int((st["budget"] - st["emitted"])[st["act"]].max())


def _rows_out(drafts: torch.Tensor, n_acc: torch.Tensor,
              nxt: torch.Tensor) -> torch.Tensor:
    """(B, k+1) emitted row: the accepted drafts, then nxt, then -1."""
    k = drafts.shape[1]
    idx = torch.arange(k + 1, device=drafts.device)[None, :]
    pad = torch.cat([drafts, drafts[:, :1]], dim=1)
    return torch.where(idx < n_acc[:, None], pad,
                       torch.where(idx == n_acc[:, None], nxt[:, None], -1))


def _hit_eos(row: torch.Tensor, n_acc: torch.Tensor,
             eos: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(row.shape[1], device=row.device)[None, :]
    return ((idx <= n_acc[:, None]) & (row == eos[:, None])).any(dim=1)


def _no_head(params: dict) -> dict:
    """The weights without the lm head: a forward of them returns hidden
    states (the draft's last KV write, whose logits nothing reads; the
    JAX jit drops that head as dead code)."""
    return {k: v for k, v in params.items() if k not in ("output", "output_b")}


def draft_cycle_body(target, draft, bufs: CycleBuffers, k: int, tslot: int,
                     span_t, span_d, mode: str, top_k: int, gen):
    """The cycle of `_build_spec_scan` / `_build_draft_scan_srv` for one
    row: k draft steps (greedy argmax, or a draw from q with mode
    "stochastic") and the draft's last KV write, then the (1, 1+k) target
    verify of the target slot `tslot`, and the acceptance: mode "greedy"
    (argmax match), "stochastic" (_stochastic_accept) or "match" (a target
    sample a position, accepted while it equals the draft)."""
    dcfg, tcfg = draft.cfg, target.cfg
    dparams, dparams_nohead = draft.params, _no_head(draft.params)
    dev = target.device
    n_ctx = min(target.n_ctx, draft.n_ctx)
    ar = torch.arange(k + 1, device=dev)

    def body():
        run = bufs.act.bool()
        pos = bufs.pos
        t, p = bufs.tok, pos
        toks, qs = [], []
        for _ in range(k):
            lg, _ = forward(dparams, dcfg, t.view(1, 1),
                            torch.where(run, p, -1).view(1, 1), draft.cache,
                            0, torch.where(run, p, draft.n_ctx).view(1, 1),
                            kv_span=span_d, t_bucket=1)
            lgv = lg[0, 0]
            if mode == "stochastic":
                q = _dense_dist(lgv, bufs.temp[0], top_k)
                t = _dist_sample(q, _gumbel(q.shape, gen, dev)).view(1)
                qs.append(q)
            else:
                t = torch.argmax(lgv).view(1)
            toks.append(t)
            p = p + 1
        # the last proposal's KV: a fully accepted draft proposes next
        # from a context that holds it
        forward(dparams_nohead, dcfg, t.view(1, 1),
                torch.where(run, p, -1).view(1, 1), draft.cache, 0,
                torch.where(run, p, draft.n_ctx).view(1, 1),
                kv_span=span_d, t_bucket=1)
        drafts = torch.cat(toks).view(1, k).to(torch.int32)
        seq = torch.cat([bufs.tok, drafts[0]]).view(1, k + 1)
        poss = (pos + ar).view(1, k + 1)
        logits, _ = forward(target.params, tcfg, seq,
                            torch.where(run, poss, -1), target.cache, tslot,
                            torch.where(run, poss, target.n_ctx),
                            kv_span=span_t, t_bucket=k + 1)
        lg = logits[0]                                        # (k+1, V)
        if mode == "greedy":
            tgt = torch.argmax(lg, dim=-1)[None]
            n_acc = _match_accept(tgt, drafts)
            nxt = tgt.gather(1, n_acc[:, None])[:, 0]
        elif mode == "stochastic":
            pt = _dense_dist(lg, bufs.temp[0], top_k)
            u = torch.rand((k,), generator=gen, device=dev)
            n_acc, nxt = _stochastic_accept(pt, torch.stack(qs), drafts[0],
                                            u, _gumbel(pt.shape[-1:], gen,
                                                       dev))
            n_acc, nxt = n_acc.view(1), nxt.view(1)
        else:
            tgt = _sample_rows(lg, bufs.temp.expand(k + 1), top_k,
                               gen)[None]
            n_acc = _match_accept(tgt, drafts)
            nxt = tgt.gather(1, n_acc[:, None])[:, 0]
        row = _rows_out(drafts, n_acc, nxt)
        bufs.finish(row, n_acc, nxt, _hit_eos(row, n_acc, bufs.eos), k,
                    n_ctx)
    return body


def _propose(h: torch.Tensor, pos: torch.Tensor, k: int, ngram_min: int,
             ngram_max: int) -> torch.Tensor:
    """(B, H) histories holding each row's carried token at pos -> (B, k)
    drafts: the k tokens after the latest earlier occurrence of the
    longest tail n-gram (find_ngram_draft semantics), zeros where none
    matches (a proposal that is simply rejected)."""
    B, H = h.shape
    dev = h.device
    idx = torch.arange(H, device=dev)[None, :]
    p = pos.long()[:, None]
    cand = torch.zeros((B, k), dtype=h.dtype, device=dev)
    found = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    for g in range(ngram_max, ngram_min - 1, -1):
        tpos = torch.clamp(p - g + 1 + torch.arange(g, device=dev)[None, :],
                           0, H - 1)
        tail = h.gather(1, tpos)                              # (B, g)
        eq = torch.ones((B, H), dtype=torch.bool, device=dev)
        for j in range(g):
            eq &= torch.roll(h, -j, dims=1) == tail[:, j:j + 1]
        # the match must end before pos, and the tail must exist
        valid = eq & (idx <= p - g) & (p + 1 >= g)
        best = torch.where(valid, idx, -1).amax(dim=1, keepdim=True)
        cidx = torch.clamp(torch.clamp(best, min=0) + g
                           + torch.arange(k, device=dev)[None, :], max=H - 1)
        cont = h.gather(1, cidx)
        hit = best >= 0
        cand = torch.where(~found & hit, cont, cand)
        found = found | hit
    return cand


def lookup_cycle_body(target, bufs: CycleBuffers, k: int, slots,
                      ngram_min: int, ngram_max: int, span, greedy: bool,
                      top_k: int, gen, clamp_budget: bool):
    """The cycle of `_build_lookup_scan` (B = 1, slots = the slot id) and
    `_build_lookup_scan_multi` (slots None: the first B slots): each active
    row writes its carried token into its history at pos, drafts by the
    n-gram search, one (B, 1+k) target forward verifies every row, then
    the acceptance (argmax match, or a target sample a position at the
    row's temperature, accepted while it equals the draft), the row into
    the history after pos. clamp_budget: a row never emits past its budget
    (the multi-slot rule)."""
    cfg = target.cfg
    dev = target.device
    B, H = bufs.B, bufs.H
    n_ctx = target.n_ctx
    ar = torch.arange(k + 1, device=dev)[None, :]

    def body():
        run = bufs.act.bool()
        pos = bufs.pos
        h = bufs.h
        pidx = torch.clamp(pos.long(), max=H - 1)[:, None]
        h.scatter_(1, pidx, torch.where(run[:, None], bufs.tok[:, None],
                                        h.gather(1, pidx)))
        drafts = _propose(h, pos, k, ngram_min, ngram_max)
        seq = torch.cat([bufs.tok[:, None], drafts], dim=1)
        poss = pos[:, None] + ar
        logits, _ = forward(target.params, cfg,
                            torch.where(run[:, None], seq, 0),
                            torch.where(run[:, None], poss, -1),
                            target.cache, slots,
                            torch.where(run[:, None], poss, n_ctx),
                            kv_span=span, t_bucket=k + 1)
        if greedy:
            tgt = torch.argmax(logits, dim=-1)
        else:
            V = logits.shape[-1]
            tgt = _sample_rows(logits.reshape(-1, V),
                               bufs.temp[:, None].expand(B, k + 1)
                               .reshape(-1), top_k, gen).view(B, k + 1)
        n_acc = _match_accept(tgt, drafts)
        if clamp_budget:
            n_acc = torch.minimum(n_acc, torch.clamp(
                bufs.budget - bufs.emitted - 1, min=0))
        nxt = tgt.gather(1, n_acc.long()[:, None])[:, 0]
        row = _rows_out(drafts, n_acc, nxt)
        hidx = torch.clamp(pos.long()[:, None] + 1 + ar, max=H - 1)
        h.scatter_(1, hidx, torch.where(run[:, None], row.to(h.dtype),
                                        h.gather(1, hidx)))
        bufs.finish(row, n_acc, nxt, _hit_eos(row, n_acc, bufs.eos), k,
                    n_ctx)
    return body


def _max_steps(engine, n_predict: int) -> int:
    b = engine.DECODE_BUCKETS
    return next((x for x in b if x >= n_predict), b[-1])


def _stage1(bufs: CycleBuffers, cur: int, pos: int, k_need: int, n_ctx: int,
            budget: int, eos: int, temp: float, h=None) -> None:
    """Stage a one-row block; the row starts active where another cycle
    fits and there is budget (the JAX loop's first cond)."""
    act = budget > 0 and pos + k_need + 1 <= n_ctx
    bufs.stage([cur], [pos], [act], [budget], [eos], [temp], h)


def _finish_fast(engine, slot, out, start0, stop_on_eos, eos, t0,
                 draft=None):
    """The post-call contract of generate_fast: the output cut to
    n_predict and at EOS, the KV rolled back to the returned tokens (the
    final token's KV may be unwritten)."""
    total_written = int(engine.n_past[slot]) - start0
    if stop_on_eos and eos in out:
        out = out[:out.index(eos)]
    tgt_past = start0 + min(len(out), total_written)
    if tgt_past != int(engine.n_past[slot]):
        engine.rollback(slot, tgt_past)
    if draft is not None:
        dr_past = min(tgt_past, int(draft.n_past[0]))
        if dr_past != int(draft.n_past[0]):
            draft.rollback(0, dr_past)
    engine.timings.t_eval += time.perf_counter() - t0
    engine.timings.n_eval += len(out)
    text = engine.tokenizer.decode(out) if engine.tokenizer else ""
    return out, text


def _advance_mirrors(eng, slot: int, start: int, pos: int) -> None:
    eng.n_past[slot] = pos
    eng.cell_pos[slot, start:pos] = np.arange(start, pos)


def spec_mode(target, draft, greedy: bool) -> str:
    """The acceptance rule: "greedy", "stochastic" (temp > 0 and one
    vocabulary: the residual max(p - q, 0) needs p and q over the same
    one) or "match" (temp > 0 over two vocabularies)."""
    if greedy:
        return "greedy"
    if target.cfg.vocab_size == draft.cfg.vocab_size:
        return "stochastic"
    return "match"


def draft_block(target, draft, tslot: int, cur: int, start: int, k: int,
                max_steps: int, span_t, span_d, mode: str, temp: float,
                top_k: int, seed: int, eos: int, budget: int) -> dict:
    """One device block of draft-model speculation from position `start`
    of the target slot (the draft at its slot 0); the host mirrors of both
    engines move over the emitted prefix. Returns the read state."""
    key = ("spec", id(draft), tslot, k, max_steps, span_t, span_d, mode,
           top_k if mode != "greedy" else 0)

    def make():
        bufs = CycleBuffers(1, k + 1, max_steps, target.device)
        gen = None if mode == "greedy" else target._gen
        return bufs, draft_cycle_body(target, draft, bufs, k, tslot, span_t,
                                      span_d, mode, top_k, gen), gen
    g = target.graphs.get(key, make)
    _stage1(g.bufs, cur, start, k, min(target.n_ctx, draft.n_ctx), budget,
            eos, max(temp, 0.0))
    if mode != "greedy":
        target._gen.manual_seed(seed)
    dstart = int(draft.n_past[0])
    st = run_block(g, k, budget)
    target.timings.n_step += st["i"]
    if st["i"]:
        pos = int(st["pos"][0])
        _advance_mirrors(target, tslot, start, pos)
        _advance_mirrors(draft, 0, dstart, pos)
    return st


def generate_speculative_fast(target, draft, prompt, *, n_predict: int = 128,
                              n_draft: int = 5, temp: float = 0.0,
                              top_k: int = 40, seed: int = 0,
                              stop_on_eos: bool = True):
    """Draft-model speculative decoding with the whole propose / verify /
    accept cycle on the device (a captured graph a cycle, replayed for a
    block). Greedy (temp <= 0) emits exactly the tokens plain greedy
    decoding would; temp > 0 runs true speculative sampling over one
    vocabulary (token match otherwise; the JAX package's
    TPULAMM_SPEC_TOKEN_MATCH A/B switch is not ported). Both engines
    one-slot, no megakernel. Returns (token_ids, text, SpecStats)."""
    for eng, name in ((target, "target"), (draft, "draft")):
        if eng.mega is not None or eng.n_slots != 1 or eng.recurrent:
            raise ValueError(
                f"{name} engine must be single-slot, non-recurrent, "
                "without the megakernel, for on-device speculation")
    tokens = _tokens(target, prompt)
    target.reset_slot(0)
    draft.reset_slot(0)
    logits = target.prefill(0, tokens)
    draft.prefill(0, tokens)
    t0 = time.perf_counter()
    first = int(np.argmax(logits))
    eos = target._eos()
    mode = spec_mode(target, draft, temp <= 0.0)
    max_steps = _max_steps(target, n_predict)
    stats = SpecStats()
    out = [first]
    cur = first
    start0 = int(target.n_past[0])
    n_ctx = min(target.n_ctx, draft.n_ctx)
    while len(out) < n_predict and not (stop_on_eos and eos in out):
        startb = int(target.n_past[0])
        # the last verify may overshoot n_predict by up to k accepted
        # tokens, and its KV writes reach k past the final position
        budget = n_predict - len(out) + 2 * n_draft + 2
        st = draft_block(target, draft, 0, cur, startb, n_draft, max_steps,
                         target._kv_span(budget), draft._kv_span(budget),
                         mode, temp, top_k, seed + len(out),
                         eos if stop_on_eos else -1, n_predict - len(out))
        n_steps = st["i"]
        if n_steps == 0:
            break                                    # context full
        stats.n_target_steps += n_steps
        stats.n_drafted += n_draft * n_steps
        stats.n_accepted += int(st["accs"][:n_steps, 0].sum())
        out.extend(int(t) for r in st["rows"][:n_steps, 0] for t in r
                   if t >= 0)
        cur = out[-1]
        if int(st["pos"][0]) + n_draft + 1 > n_ctx:
            break                                    # context full
    out, text = _finish_fast(target, 0, out[:n_predict], start0,
                             stop_on_eos, eos, t0, draft)
    return out, text, stats


def lookup_block(engine, slots: list[int], carries: list[int],
                 hists: list[list[int]], k: int, max_steps: int, span,
                 budgets: list[int], eos_ids: list[int], temps: list[float],
                 greedy: bool, top_k: int, seed: int,
                 ngram_min: int = 1, ngram_max: int = 4,
                 multi: bool = False) -> dict:
    """One device block of prompt-lookup speculation. multi=False: one row,
    the slot slots[0] through a (1, 1+k) forward; multi=True: B =
    len(slots) rows over the first B slots (slots[r] == r, inactive rows
    carry budget 0), one (B, 1+k) forward. The host mirrors move over each
    row's emitted prefix. Returns the read state."""
    B = len(slots)
    H = engine.n_ctx + k + 2
    fslots = None if multi else slots[0]
    key = ("lookup", B, fslots, k, max_steps, span, ngram_min, ngram_max,
           greedy, top_k if not greedy else 0, multi)

    def make():
        bufs = CycleBuffers(B, k + 1, max_steps, engine.device, H=H)
        gen = None if greedy else engine._gen
        return bufs, lookup_cycle_body(engine, bufs, k, fslots, ngram_min,
                                       ngram_max, span, greedy, top_k, gen,
                                       clamp_budget=multi), gen
    g = engine.graphs.get(key, make)
    h = np.full((B, H), -1, np.int32)
    pos = np.zeros(B, np.int64)
    act = np.zeros(B, bool)
    for r, s in enumerate(slots):
        n = int(engine.n_past[s]) if budgets[r] > 0 else 0
        h[r, :len(hists[r])] = hists[r]
        pos[r] = n
        act[r] = budgets[r] > 0 and n + k + 1 <= engine.n_ctx
    g.bufs.stage(carries, pos, act, budgets, eos_ids, temps, h)
    if not greedy:
        engine._gen.manual_seed(seed)
    st = run_block(g, k, max(budgets))
    engine.timings.n_step += st["i"]
    for r, s in enumerate(slots):
        if act[r] and int(st["pos"][r]) > pos[r]:
            _advance_mirrors(engine, s, int(pos[r]), int(st["pos"][r]))
    return st


def generate_prompt_lookup_fast(engine, prompt, *, n_predict: int = 128,
                                n_draft: int = 5, ngram_min: int = 1,
                                ngram_max: int = 4, temp: float = 0.0,
                                top_k: int = 40, seed: int = 0,
                                stop_on_eos: bool = True, slot: int = 0):
    """Prompt n-gram speculative decoding with the whole cycle on the
    device (lookup.cpp parity, no drafting model): the n-gram search runs
    over a history buffer on the device. Greedy output is identical to
    plain greedy decoding. Returns (token_ids, text, SpecStats)."""
    if engine.mega is not None or engine.recurrent:
        raise ValueError("engine must be non-recurrent, without the "
                         "megakernel, for on-device speculation")
    tokens = _tokens(engine, prompt)
    engine.reset_slot(slot)
    logits = engine.prefill(slot, tokens)
    t0 = time.perf_counter()
    first = int(np.argmax(logits))
    eos = engine._eos()
    greedy = temp <= 0.0
    max_steps = _max_steps(engine, n_predict)
    stats = SpecStats()
    out = [first]
    cur = first
    history = list(tokens)          # tokens BEFORE the current position
    start0 = int(engine.n_past[slot])
    while len(out) < n_predict and not (stop_on_eos and eos in out):
        span = engine._kv_span(n_predict - len(out) + 2 * n_draft + 2)
        st = lookup_block(engine, [slot], [cur], [history], n_draft,
                          max_steps, span, [n_predict - len(out)],
                          [eos if stop_on_eos else -1], [temp], greedy,
                          top_k, seed + len(out), ngram_min, ngram_max)
        n_steps = st["i"]
        if n_steps == 0:
            break                                    # context full
        stats.n_target_steps += n_steps
        stats.n_drafted += n_draft * n_steps
        stats.n_accepted += int(st["accs"][:n_steps, 0].sum())
        block = [int(t) for r in st["rows"][:n_steps, 0] for t in r
                 if t >= 0]
        history.append(cur)
        history.extend(block[:-1])   # block[-1] is the new carry token
        out.extend(block)
        cur = out[-1]
        if int(st["pos"][0]) + n_draft + 1 > engine.n_ctx:
            break                                    # context full
    out, text = _finish_fast(engine, slot, out[:n_predict], start0,
                             stop_on_eos, eos, t0)
    return out, text, stats
