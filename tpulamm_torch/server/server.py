"""HTTP inference server with slot-based continuous batching on the torch
Engine (counterpart of tpulamm.server.server).

    python -m tpulamm_torch.server.server -m model.gguf [--device cpu]

Capability parity with examples/server/server.cpp: OpenAI-compatible
`/v1/completions` and `/v1/chat/completions` (+ native `/completion`),
streaming SSE, `/embedding(s)`, `/tokenize`, `/detokenize`, `/infill`,
`/slots`, `/system_prompt`, `/cancel`, `/health`, `/props`, `/v1/models`
and a Prometheus `/metrics` endpoint; requests are multiplexed over N slots
and running slots share one batched decode step per iteration
(update_slots, server.cpp:1617) -- new requests prefill into a free slot
and join the batch.

Decode runs in the JAX server's tiers: the speculative blocks
(`--model-draft`: one active slot, draft-model speculation through
`Engine.spec_draft_block`; `--lookup-decoding`: prompt-lookup
speculation, one greedy slot through `spec_lookup_block`, several slots
or sampled ones through the compound verify of `spec_lookup_block_multi`;
each counted in the `llamacpp:spec_*` counters of `/metrics`), device
blocks with greedy or temp + top-k sampling inside the step graph
(`Engine.decode_batch_fast`), device blocks with the full sampler chain
(`decode_batch_sampled`), and single steps sampled on the host
(`decode_batch`: grammar, stop strings, n_probs, mirostat, logit bias).

Once the model is loaded, the Scheduler thread makes every engine call,
so every CUDA call of a running server (prefill, graph capture and
replay, embeddings) comes from that thread; the HTTP handler threads only
tokenize, render JSON and pass queues. A graph capture in the default
(global) mode is safe because no other thread of the server touches CUDA
meanwhile.

The mesh: `--tp` / `--dp` build the Engine on a (dp, tp) mesh whose ranks
all live on `--device` (parallel.mesh). Multi-host serving: every process
starts with the same arguments and `--coordinator HOST:PORT
--num-processes N --process-id I` (parallel.distributed); process 0 keeps
HTTP and mirrors its engine calls over the broadcast channel
(`--broadcast-port`, default HTTP port + 1000; server.multihost) to the
others, which apply them; a worker silent for `--mh-heartbeat` seconds
fails the in-flight requests and every later one with 503
(`llamacpp:mh_workers_lost` in /metrics).
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tpulamm_torch.cli._common import require_file
from tpulamm_torch.grammar.engine import Grammar
from tpulamm_torch.grammar.json_schema import json_grammar, schema_to_grammar
from tpulamm_torch.ops.device_sampling import fast_chain_eligible
from tpulamm_torch.parallel.distributed import (add_distributed_args,
                                                init_from_args, world)
from tpulamm_torch.runtime.chat import (apply_chat_template,
                                        template_from_metadata)
from tpulamm_torch.runtime.kvcache import KV_CACHE_TYPES
from tpulamm_torch.runtime.sampling import Sampler, SamplingParams, softmax
from tpulamm_torch.server.multihost import (CallBroadcaster, MirroredEngine,
                                            WorkerLost, connect_worker,
                                            worker_loop)
from tpulamm_torch.utils import log as logm

WORKER_LOST = "multi-host worker lost"


@dataclass
class Request:
    prompt: str | list[int]
    params: SamplingParams
    n_predict: int
    stream: bool
    embed: bool = False          # embedding request (pooled hidden states)
    grammar: str | None = None   # GBNF constraint (server "grammar" param)
    cache_prompt: bool = False   # reuse the slot's KV prefix (server.cpp:97)
    eot_id: int | None = None    # extra stop token (FIM end-of-turn)
    stop_strs: list = field(default_factory=list)  # server.cpp "stop"
    out: "queue.Queue" = field(default_factory=queue.Queue)
    rid: str = field(default_factory=lambda: uuid.uuid4().hex[:16])
    # set to cancel mid-generation (client disconnect or POST /cancel);
    # the scheduler frees the slot at the next decode boundary
    cancel: threading.Event = field(default_factory=threading.Event)
    # the HTTP status of an "error" item: 503 once a multi-host worker is
    # lost (the server cannot serve), else 400
    error_status: int = 400


@dataclass
class SlotState:
    req: Request | None = None
    sampler: Sampler | None = None
    next_tok: int | None = None
    n_gen: int = 0
    prompt_len: int = 0
    t_start: float = 0.0
    seed: int = 0                # the request's seed for device blocks
    text_tail: str = ""          # rolling tail for stop-sequence matching
    # tokens FED to the engine on this slot (prompt + carried generations);
    # survives request completion so cache_prompt can reuse the KV prefix
    # (server_slot.cache_tokens, server.cpp:1880)
    hist: list = field(default_factory=list)


class Metrics:
    def __init__(self):
        self.lock = threading.Lock()
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self.requests = 0
        self.busy_slots = 0
        self.queue_depth = 0
        # which decode path served tokens: fast = device blocks; slow =
        # per-token host-sampled steps (penalties/grammar)
        self.fast_blocks = 0
        self.slow_steps = 0
        # fast blocks that used the full device sampler chain
        # (penalties + default queue) rather than plain temp/top-k
        self.sampled_blocks = 0
        # speculative (prompt-lookup or draft-model) blocks + their
        # economics
        self.spec_blocks = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # spec blocks verified against the --model-draft draft engine
        self.spec_draft_blocks = 0
        # multi-host transport health
        self.mh_workers_lost = 0
        # prompt tokens satisfied from a cached KV prefix (cache_prompt)
        self.cached_prompt_tokens = 0

    def render(self) -> str:
        # prometheus text format (server.cpp /metrics parity)
        return (
            "# TYPE llamacpp:prompt_tokens_total counter\n"
            f"llamacpp:prompt_tokens_total {self.prompt_tokens}\n"
            "# TYPE llamacpp:tokens_predicted_total counter\n"
            f"llamacpp:tokens_predicted_total {self.generated_tokens}\n"
            "# TYPE llamacpp:requests_total counter\n"
            f"llamacpp:requests_total {self.requests}\n"
            "# TYPE llamacpp:slots_busy gauge\n"
            f"llamacpp:slots_busy {self.busy_slots}\n"
            "# TYPE llamacpp:queue_depth gauge\n"
            f"llamacpp:queue_depth {self.queue_depth}\n"
            "# TYPE llamacpp:decode_fast_blocks_total counter\n"
            f"llamacpp:decode_fast_blocks_total {self.fast_blocks}\n"
            "# TYPE llamacpp:decode_slow_steps_total counter\n"
            f"llamacpp:decode_slow_steps_total {self.slow_steps}\n"
            "# TYPE llamacpp:decode_sampled_blocks_total counter\n"
            f"llamacpp:decode_sampled_blocks_total {self.sampled_blocks}\n"
            "# TYPE llamacpp:spec_blocks_total counter\n"
            f"llamacpp:spec_blocks_total {self.spec_blocks}\n"
            "# TYPE llamacpp:spec_drafted_total counter\n"
            f"llamacpp:spec_drafted_total {self.spec_drafted}\n"
            "# TYPE llamacpp:spec_accepted_total counter\n"
            f"llamacpp:spec_accepted_total {self.spec_accepted}\n"
            "# TYPE llamacpp:spec_draft_blocks_total counter\n"
            f"llamacpp:spec_draft_blocks_total {self.spec_draft_blocks}\n"
            "# TYPE llamacpp:mh_workers_lost counter\n"
            f"llamacpp:mh_workers_lost {self.mh_workers_lost}\n"
            "# TYPE llamacpp:prompt_cached_tokens_total counter\n"
            f"llamacpp:prompt_cached_tokens_total "
            f"{self.cached_prompt_tokens}\n")


class Scheduler(threading.Thread):
    """update_slots loop: assign queued requests to slots, batch-decode."""

    LOOKUP_DRAFT = 4     # n-gram draft length for the lookup spec blocks
    LOOKUP_STEPS = 64    # verify steps per spec block
    DRAFT_K = 4          # draft-model proposal length (--model-draft)
    DRAFT_STEPS = 32     # verify steps per draft-model block

    def __init__(self, engine, n_slots: int, lookup_decoding: bool = False):
        super().__init__(daemon=True)
        self.engine = engine
        self.n_slots = n_slots
        # opt-in prompt-lookup speculation (wins on weight-streaming-bound
        # models)
        self.lookup_decoding = lookup_decoding
        self.slots = [SlotState() for _ in range(n_slots)]
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self.metrics = Metrics()
        self.running = True
        self.worker_lost = False  # multi-host transport degraded
        self.requests: dict[str, Request] = {}   # rid -> live request
        # shared system prompt (server.cpp:118,639-672,1028-1087): one
        # prefill, seq_cp fan-out to every slot; requests then reuse the
        # prefix for free. _pending applies when all slots go idle.
        self.system_tokens: list[int] = []
        self.system_prompt: str = ""
        self._pending_system: str | None = None

    def set_system_prompt(self, text: str):
        """Queue a system-prompt (re)set; applied by the run loop when
        every slot is idle (system_prompt_update, server.cpp:1028)."""
        self._pending_system = text

    def _apply_system(self):
        # Runs on the scheduler thread: any exception here would kill the
        # run() loop and hang every client, so validate BEFORE touching
        # slot state and never let an error escape.
        text, self._pending_system = self._pending_system, None
        eng = self.engine
        try:
            toks = (eng.tokenizer.encode(text, special=True)
                    if text and eng.tokenizer else [])
            limit = eng.n_ctx - max(1, eng.n_ctx // 4)
            if len(toks) > limit:
                raise ValueError(
                    f"system prompt is {len(toks)} tokens; max {limit} "
                    f"(n_ctx {eng.n_ctx} minus generation headroom)")
            for i in range(self.n_slots):
                eng.reset_slot(i)
                self.slots[i].hist = []
            if toks:
                eng.prefill(0, toks)
                for i in range(1, self.n_slots):
                    eng.seq_cp(0, i)
                for i in range(self.n_slots):
                    self.slots[i].hist = list(toks)
            self.system_prompt = text or ""
            self.system_tokens = toks
        except Exception as e:  # noqa: BLE001 — scheduler must survive
            logm.log_tee(f"system prompt update rejected: {e}",
                         level="error")

    def submit(self, req: Request):
        with self.metrics.lock:
            self.metrics.requests += 1
            self.metrics.queue_depth += 1
        if self.worker_lost:
            # degraded multi-host: refuse instead of queueing forever
            self._fail_request(req, WORKER_LOST, 503)
            return
        self.requests[req.rid] = req
        self.pending.put(req)

    def cancel(self, rid: str) -> bool:
        req = self.requests.get(rid)
        if req is None:
            return False
        req.cancel.set()
        return True

    def _flush_held(self, i: int):
        slot = self.slots[i]
        if slot.text_tail:
            slot.req.out.put(("tok", -1, slot.text_tail, None))
            slot.text_tail = ""

    def _finish_slot(self, i: int, reason: str):
        slot = self.slots[i]
        # flush any held (potential-stop-prefix) text; a stop-sequence
        # match clears text_tail before calling, so nothing leaks there
        self._flush_held(i)
        slot.req.out.put((
            "done", reason,
            {"prompt_tokens": slot.prompt_len,
             "completion_tokens": slot.n_gen,
             "t_total": time.perf_counter() - slot.t_start}))
        self.requests.pop(slot.req.rid, None)
        slot.req = None
        slot.sampler = None
        slot.next_tok = None

    def _sweep_cancelled(self):
        """Free slots whose request was cancelled (disconnect or /cancel);
        the slot's KV is reset on reuse, so no rollback is needed."""
        for i, slot in enumerate(self.slots):
            if slot.req is not None and slot.req.cancel.is_set():
                self._finish_slot(i, "cancelled")

    def _fail_request(self, req: Request, msg: str, status: int = 400):
        """Answer `req` with an error. A 503 stays: a request failed for a
        lost worker keeps that status when a later handler fails it
        again."""
        self.requests.pop(req.rid, None)
        if req.error_status != 503:
            req.error_status = status
        req.out.put(("error", msg, {"prompt_tokens": 0,
                                    "completion_tokens": 0, "t_total": 0.0}))

    def on_worker_lost(self, idx: int):
        """Multi-host transport callback (the heartbeat monitor thread): a
        worker stopped heartbeating. Fail every live request with 503 and
        refuse new ones -- the scheduler thread may be blocked inside a
        collective that can never complete (the dead worker was a
        participant), so the client-visible failure must not depend on
        it. The next mirrored engine call raises WorkerLost
        (server.multihost)."""
        self.worker_lost = True
        with self.metrics.lock:
            self.metrics.mh_workers_lost += 1
        print(f"server: worker {idx} lost -- failing in-flight requests",
              flush=True)
        try:
            while True:
                self._fail_request(self.pending.get_nowait(), WORKER_LOST,
                                   503)
        except queue.Empty:
            pass
        # fail the streams; slot teardown is left to the run() loop (it
        # may be blocked in a device step: the client error cannot wait)
        for slot in self.slots:
            req = slot.req
            if req is not None:
                self._fail_request(req, WORKER_LOST, 503)

    def _assign(self):
        for i, slot in enumerate(self.slots):
            if slot.req is not None:
                continue
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                return
            with self.metrics.lock:
                self.metrics.queue_depth -= 1
            try:
                self._assign_one(i, req)
            except Exception as e:  # noqa: BLE001 — a bad request (e.g.
                # malformed grammar) must fail ITSELF, not kill the
                # scheduler thread and hang every other client
                if isinstance(e, WorkerLost) or self.worker_lost:
                    # the transport is gone: 503, and no further mirrored
                    # call (it would raise WorkerLost in its turn)
                    self._fail_request(req, WORKER_LOST, 503)
                else:
                    self._fail_request(req, f"{type(e).__name__}: {e}")
                    self.engine.reset_slot(i)
                slot = self.slots[i]
                slot.req = None
                slot.sampler = None
                slot.next_tok = None
                slot.hist = []

    def _assign_one(self, i: int, req: Request):
        slot = self.slots[i]
        if req.cancel.is_set():        # cancelled while queued
            self.requests.pop(req.rid, None)
            req.out.put(("done", "cancelled",
                         {"prompt_tokens": 0, "completion_tokens": 0,
                          "t_total": 0.0}))
            return
        eng = self.engine
        if req.embed:
            # embeddings run to completion on the slot, then free it; this
            # blocks the scheduler loop for the duration, as in the JAX
            # server
            vec = eng.embed(req.prompt, slot=i)
            eng.reset_slot(i)
            slot.hist = []
            self.requests.pop(req.rid, None)
            req.out.put(("embedding", vec.tolist(), None))
            return
        if isinstance(req.prompt, str):
            tokens = eng.tokenizer.encode(req.prompt, special=True)
        else:
            tokens = list(req.prompt)
        # keep room for generation; over-long generations are handled by
        # context shift at decode
        keep = eng.n_ctx - max(req.n_predict, 0) - 1
        if keep <= 0:
            keep = eng.n_ctx - 2
        # the shared system prefix survives trimming (the reference keeps
        # system_tokens and shifts only the per-slot part, server.cpp:1678)
        keep_user = max(keep - len(self.system_tokens), 8)
        if len(tokens) > keep_user:
            tokens = tokens[-keep_user:]
        tokens = self.system_tokens + tokens
        # cache_prompt (server.cpp:1880): reuse the KV prefix this slot
        # already holds when it matches the new prompt. Only valid while
        # the engine state still mirrors slot.hist exactly (no context
        # shift happened: cells contiguous, n_past == len(hist)). The
        # shared system prefix is reused even without cache_prompt.
        common = 0
        if ((req.cache_prompt or self.system_tokens) and slot.hist
                and not eng.recurrent):
            n_hist = len(slot.hist)
            if (int(eng.n_past[i]) == n_hist and np.array_equal(
                    eng.cell_pos[i, :n_hist], np.arange(n_hist))):
                limit = min(n_hist, len(tokens) - 1)  # eval >=1 for logits
                if not req.cache_prompt:
                    limit = min(limit, len(self.system_tokens))
                while common < limit and slot.hist[common] == tokens[common]:
                    common += 1
        if common > 0:
            eng.rollback(i, common)
        else:
            eng.reset_slot(i)
        slot.hist = list(tokens)
        eos = eng.tokenizer.vocab.eos_id if eng.tokenizer else 2
        grammar = pieces = None
        if req.grammar:
            grammar = Grammar.from_gbnf(req.grammar)
            pieces = eng.token_pieces()
        sampler = Sampler(req.params, eng.cfg.vocab_size, eos_id=eos,
                          grammar=grammar, token_pieces=pieces)
        for t in tokens:
            sampler.accept(t, apply_grammar=False)
        slot.req = req
        slot.sampler = sampler
        slot.n_gen = 0
        slot.prompt_len = len(tokens)
        slot.text_tail = ""
        slot.t_start = time.perf_counter()
        # a request without a seed (-1 / 0xFFFFFFFF) draws one from its
        # sampler, which was seeded from entropy
        slot.seed = (req.params.seed
                     if req.params.seed not in (-1, 0xFFFFFFFF)
                     else int(sampler.rng.integers(0x7FFFFFFF)))
        logits = eng.prefill(i, tokens[common:])
        with self.metrics.lock:
            self.metrics.prompt_tokens += len(tokens) - common
            self.metrics.cached_prompt_tokens += common
        self._sample_and_emit(i, logits)

    def _top_probs(self, logits: np.ndarray, n: int, sampled: int) -> dict:
        """Top-n token probabilities + the sampled token's probability
        (server.cpp n_probs payload)."""
        p = softmax(np.asarray(logits, np.float64))
        idx = np.argsort(p)[::-1][:n]
        tok = self.engine.tokenizer
        top = [{"id": int(t),
                "tok_str": tok.token_to_piece(int(t)) if tok else str(t),
                "prob": float(p[t])} for t in idx]
        return {"top": top, "sampled_prob": float(p[sampled])}

    def _sample_and_emit(self, i: int, logits: np.ndarray):
        slot = self.slots[i]
        eng = self.engine
        tok = slot.sampler.sample(logits)
        slot.sampler.accept(tok)
        eos = eng.tokenizer.vocab.eos_id if eng.tokenizer else 2
        stop = (tok == eos or tok == slot.req.eot_id) \
            and not slot.req.params.ignore_eos
        if not stop:
            slot.n_gen += 1
            piece = eng.tokenizer.token_to_piece(tok) if eng.tokenizer else ""
            # stop sequences (server.cpp "stop"): text that could still
            # become a stop match is HELD BACK (text_tail) so partial
            # matches never reach the client; on a full match the match
            # is trimmed, on any other finish the held text flushes
            if slot.req.stop_strs:
                cand = slot.text_tail + piece
                hit_pos = min((cand.index(sp) for sp in slot.req.stop_strs
                               if sp and sp in cand), default=-1)
                if hit_pos >= 0:
                    if hit_pos > 0:
                        slot.req.out.put(("tok", tok, cand[:hit_pos],
                                          None))
                        with self.metrics.lock:
                            self.metrics.generated_tokens += 1
                    slot.text_tail = ""
                    self._finish_slot(i, "stop")
                    return
                # longest suffix of cand that is a proper prefix of any
                # stop string stays held
                hold = 0
                for sp in slot.req.stop_strs:
                    for k in range(min(len(sp) - 1, len(cand)), hold, -1):
                        if cand.endswith(sp[:k]):
                            hold = k
                            break
                emit_text = cand[:len(cand) - hold] if hold else cand
                slot.text_tail = cand[len(cand) - hold:] if hold else ""
                if emit_text:
                    slot.req.out.put(("tok", tok, emit_text, None))
                    with self.metrics.lock:
                        self.metrics.generated_tokens += 1
                if slot.n_gen >= slot.req.n_predict:
                    self._flush_held(i)
                    self._finish_slot(i, "length")
                    return
                slot.next_tok = tok
                return
            probs = (self._top_probs(logits, slot.req.params.n_probs, tok)
                     if slot.req.params.n_probs else None)
            slot.req.out.put(("tok", tok, piece, probs))
            with self.metrics.lock:
                self.metrics.generated_tokens += 1
        if stop or slot.n_gen >= slot.req.n_predict:
            self._finish_slot(i, "stop" if stop else "length")
        else:
            slot.next_tok = tok

    @staticmethod
    def _fast_eligible(p) -> bool:
        """Sampling the device block reproduces exactly: greedy or plain
        temp+top-k, no penalties/grammar/bias/mirostat/probs."""
        plain = (p.penalty_repeat == 1.0 and p.penalty_freq == 0.0
                 and p.penalty_present == 0.0 and p.mirostat == 0
                 and not p.logit_bias and p.n_probs == 0)
        if not plain:
            return False
        if p.temp <= 0.0:
            return True
        return (p.top_k > 0 and p.top_p >= 1.0 and p.min_p <= 0.0
                and p.tfs_z >= 1.0 and p.typical_p >= 1.0)

    def _emit_generated(self, i: int, toks: list,
                        accept: bool = False) -> None:
        """Emit a block of generated tokens for slot i, finishing the
        slot on eos/EOT/n_predict (shared by the plain and sampled-chain
        block runners). accept=True also feeds tokens into the host
        sampler (penalty window for the next sampled block)."""
        eng = self.engine
        slot = self.slots[i]
        eos = eng.tokenizer.vocab.eos_id if eng.tokenizer else 2
        stop_eos = not slot.req.params.ignore_eos
        done_at = None
        for j, tok in enumerate(toks):
            if (tok == eos or tok == slot.req.eot_id) and stop_eos:
                done_at = j
                break
            if accept:
                slot.sampler.accept(tok, apply_grammar=False)
            slot.n_gen += 1
            piece = (eng.tokenizer.token_to_piece(tok)
                     if eng.tokenizer else "")
            slot.req.out.put(("tok", tok, piece, None))
            with self.metrics.lock:
                self.metrics.generated_tokens += 1
            if slot.n_gen >= slot.req.n_predict:
                done_at = j
                break
        if done_at is None and slot.n_gen >= slot.req.n_predict:
            done_at = len(toks) - 1
        if done_at is not None:
            stop = ((toks[done_at] == eos
                     or toks[done_at] == slot.req.eot_id) and stop_eos)
            self._finish_slot(i, "stop" if stop else "length")
        else:
            slot.next_tok = toks[-1]

    def _block_seed(self, active: dict[int, int]) -> int:
        """The seed of a block's generator: distinct per block (each slot's
        tokens so far) and per request mix (each slot's seed and id), and
        the same for a request with an explicit seed served the same way
        twice. The JAX server mixes in a global block count instead, so
        there a seed does not repeat a request's text."""
        seed = 0
        for i in active:
            s = self.slots[i]
            seed ^= (s.seed + 0x9E3779B9 * (i + 1) + 1000003 * s.n_gen) \
                & 0x7FFFFFFF
        return seed

    def _block_len(self, active: dict[int, int]) -> int:
        """Single-stream: bigger blocks amortize the per-dispatch floor
        (nothing is waiting -- the block tiers require an empty queue);
        multi-slot keeps short blocks so finished slots free up fast."""
        remaining = min(self.slots[i].req.n_predict - self.slots[i].n_gen
                        for i in active)
        return max(1, min(64 if len(active) == 1 else 8, remaining))

    def _run_fast_block(self, active: dict[int, int]) -> bool:
        """Multi-token device block for all active slots; False if the
        engine can't take the block (a context shift broke contiguity, or
        n_ctx is near): the caller takes the per-token tier."""
        temps = {i: self.slots[i].req.params.temp for i in active}
        # stochastic requests share one top_k here (gated in run());
        # greedy slots never consult it
        stoch = [self.slots[i].req.params.top_k for i in active
                 if self.slots[i].req.params.temp > 0.0]
        top_k = stoch[0] if stoch else 40
        try:
            blocks = self.engine.decode_batch_fast(
                active, self._block_len(active), temp=temps, top_k=top_k,
                seed=self._block_seed(active))
        except ValueError:
            return False
        for i, toks in blocks.items():
            # engine fed the carry token + all but the last sample
            self.slots[i].hist.append(active[i])
            self.slots[i].hist.extend(toks[:-1])
            self._emit_generated(i, toks)
        return True

    def _run_sampled_block(self, active: dict[int, int]) -> bool:
        """Multi-token device block with the FULL sampler chain
        (penalties + default queue, per-slot params) -- keeps default
        OpenAI-style requests (temp + penalties + top_p) off the
        one-host-trip-per-token slow path. False -> caller falls back."""
        samplers = {i: self.slots[i].sampler for i in active}
        try:
            blocks = self.engine.decode_batch_sampled(
                active, self._block_len(active), samplers,
                seed=self._block_seed(active))
        except ValueError:
            return False
        for i, toks in blocks.items():
            self.slots[i].hist.append(active[i])
            self.slots[i].hist.extend(toks[:-1])
            self._emit_generated(i, toks, accept=True)
        return True

    # -- the speculative tiers (server.py:553-715 of the JAX package) -----
    def _spec_ready(self, i: int, k: int) -> bool:
        """Slot i can take a speculation block: the engine is not
        recurrent, its history is what the engine holds, in contiguous
        cells, with room for a cycle."""
        eng = self.engine
        n = int(eng.n_past[i])
        return (not eng.recurrent and len(self.slots[i].hist) == n
                and n + k + 1 <= eng.n_ctx
                and np.array_equal(eng.cell_pos[i, :n], np.arange(n)))

    def _count_spec(self, drafted: int, accepted: int,
                    draft: bool = False) -> None:
        with self.metrics.lock:
            self.metrics.spec_blocks += 1
            self.metrics.spec_draft_blocks += int(draft)
            self.metrics.spec_drafted += drafted
            self.metrics.spec_accepted += accepted

    def _emit_spec(self, i: int, carry: int, rows) -> None:
        """Emit a slot's speculative rows: the engine fed the carry and
        every emitted token but the last, which is the new carry."""
        block = [int(t) for r in rows for t in r if t >= 0]
        slot = self.slots[i]
        slot.hist.append(carry)
        slot.hist.extend(block[:-1])
        self._emit_generated(i, block)

    def _run_lookup_block(self, i: int, carry: int) -> bool:
        """Single-active-slot greedy prompt-lookup speculation: one device
        block emits up to LOOKUP_STEPS * (k + 1) tokens with no drafting
        model (lookup.cpp fused into serving). False -> caller falls
        back."""
        eng = self.engine
        slot = self.slots[i]
        k = self.LOOKUP_DRAFT
        if not self._spec_ready(i, k):
            return False
        remaining = slot.req.n_predict - slot.n_gen
        budget = min(max(remaining, 1), self.LOOKUP_STEPS * (k + 1))
        stop_eos = not slot.req.params.ignore_eos
        try:
            rows, accs, n_steps, _ = eng.spec_lookup_block(
                i, carry, slot.hist, k, self.LOOKUP_STEPS, budget,
                eng._eos() if stop_eos else -1)
        except ValueError:
            return False
        if n_steps == 0:
            return False
        self._count_spec(k * n_steps, int(accs[:n_steps].sum()))
        self._emit_spec(i, carry, rows[:n_steps])
        return True

    def _run_draft_block(self, i: int, carry: int) -> bool:
        """Single-active-slot draft-MODEL speculation (--model-draft,
        speculative.cpp fused into serving): the attached draft engine
        proposes, one (1, 1+k) target forward verifies. Greedy requests
        are output-exact; temperature requests run true speculative
        sampling. False -> caller falls back."""
        eng = self.engine
        slot = self.slots[i]
        k = self.DRAFT_K
        if getattr(eng, "draft", None) is None or not self._spec_ready(i, k):
            return False
        p = slot.req.params
        temp = max(p.temp, 0.0)
        top_k = p.top_k if temp > 0.0 else 40
        remaining = slot.req.n_predict - slot.n_gen
        budget = min(max(remaining, 1), self.DRAFT_STEPS * (k + 1))
        try:
            rows, accs, n_steps, _ = eng.spec_draft_block(
                i, carry, slot.hist, k, self.DRAFT_STEPS, temp, top_k,
                self._block_seed({i: carry}),
                eng._eos() if not p.ignore_eos else -1, budget)
        except ValueError:
            return False
        if n_steps == 0:
            return False
        self._count_spec(k * n_steps, int(accs[:n_steps].sum()), draft=True)
        self._emit_spec(i, carry, rows[:n_steps])
        return True

    def _run_lookup_block_multi(self, active: dict[int, int],
                                greedy: bool = True) -> bool:
        """Multi-slot speculative serving: every active slot drafts by
        prompt lookup and one (B, 1+k) compound forward verifies all of
        them a cycle. greedy=False samples each position at its slot's
        temperature (greedy slots at temp 0) and accepts while the sample
        equals the draft. False -> caller falls back."""
        eng = self.engine
        k = self.LOOKUP_DRAFT
        top_k = 0
        if not greedy:
            # the sampled verify takes ONE top_k: the stochastic slots
            # must agree on it (greedy slots never consult it)
            tks = {self.slots[i].req.params.top_k for i in active
                   if self.slots[i].req.params.temp > 0.0}
            if len(tks) != 1:
                return False
            top_k = tks.pop()
        if not all(self._spec_ready(i, k) for i in active):
            return False
        eos = eng._eos()
        olds = {i: int(eng.n_past[i]) for i in active}
        try:
            rows, accs, n_steps, posv, _ = eng.spec_lookup_block_multi(
                active, {i: self.slots[i].hist for i in active},
                {i: max(self.slots[i].req.n_predict - self.slots[i].n_gen,
                        1) for i in active},
                {i: (eos if not self.slots[i].req.params.ignore_eos
                     else -1) for i in active},
                {i: max(self.slots[i].req.params.temp, 0.0)
                 for i in active},
                self._block_seed(active), k, self.LOOKUP_STEPS, greedy,
                top_k)
        except ValueError:
            return False
        if n_steps == 0:
            return False
        tot_acc = 0
        for i, carry in active.items():
            if int(posv[i]) == olds[i]:
                continue            # slot never advanced (budget edge)
            tot_acc += int(accs[:n_steps, i].sum())
            self._emit_spec(i, carry, rows[:n_steps, i])
        # drafted = k a cycle each slot actually ran (a slot that froze
        # early has -1 rows for the remaining cycles)
        ran = (rows[:n_steps] >= 0).any(axis=-1)
        self._count_spec(k * int(ran.sum()), tot_acc)
        return True

    def _compact_slots(self):
        """Keep active slot ids a low prefix: when a high-numbered slot
        outlives its neighbours, the _b_rows compaction bucket stays
        inflated for the remainder of its request. Migrate the highest
        busy slot into the lowest free slot whenever that shrinks the
        bucket (one KV-row copy per migration). This trades away the
        target slot's cached prompt prefix (cache_prompt), which is worth
        strictly less than streaming idle KV rows on every step. A
        megakernel or recurrent engine keeps the full batch (_b_rows), so
        nothing moves there."""
        eng = self.engine
        if eng.mega is not None or eng.recurrent:
            return
        while True:
            busy = [i for i, s in enumerate(self.slots)
                    if s.req is not None]
            if not busy:
                return
            free = [i for i in range(self.n_slots)
                    if self.slots[i].req is None]
            if not free or free[0] > busy[-1]:
                return
            cur = eng._b_rows(busy) or eng.n_slots
            new = eng._b_rows(busy[:-1] + [free[0]]) or eng.n_slots
            if new >= cur:
                return
            src, dst = busy[-1], free[0]
            eng.move_slot(src, dst)
            self.slots[dst] = self.slots[src]
            self.slots[src] = SlotState()

    def _block_ok(self, active: dict[int, int], eligible) -> bool:
        """A device block may serve `active`: no request is waiting to
        join, and every active request has no grammar (it lives on the
        sampler, not the params), no stop strings and params that
        `eligible` accepts."""
        return (self.pending.empty()
                and all(self.slots[i].sampler.grammar is None
                        and not self.slots[i].req.stop_strs
                        and eligible(self.slots[i].req.params)
                        for i in active))

    def run(self):
        while self.running:
            if self.worker_lost:
                # degraded multi-host: the requests were failed by
                # on_worker_lost; tear down slot state and idle (another
                # step would hang on the dead worker)
                for slot in self.slots:
                    if slot.req is not None:
                        self.requests.pop(slot.req.rid, None)
                        slot.req = None
                        slot.sampler = None
                        slot.next_tok = None
                time.sleep(0.05)
                continue
            try:
                self._run_once()
            except WorkerLost:
                continue               # on_worker_lost failed the requests

    def _run_once(self):
        """One pass of the loop: assign, then one decode tier."""
        self._sweep_cancelled()
        if self._pending_system is not None:
            # apply when every slot is idle; hold new assignments so
            # a busy server cannot starve the update
            if all(s.req is None for s in self.slots):
                self._apply_system()
            else:
                time.sleep(0.002)
                return
        self._assign()
        self._compact_slots()
        active = {i: s.next_tok for i, s in enumerate(self.slots)
                  if s.req is not None and s.next_tok is not None}
        with self.metrics.lock:
            self.metrics.busy_slots = sum(
                1 for s in self.slots if s.req is not None)
        if not active:
            time.sleep(0.002)
            return
        # the speculative tiers (the JAX server's order): a draft
        # model serves a single active slot, greedy or sampled;
        # prompt lookup serves one greedy slot by the single-slot
        # block, several or sampled ones by the compound verify
        spec_ok = self._block_ok(active, self._fast_eligible)
        if (spec_ok and len(active) == 1
                and getattr(self.engine, "draft", None) is not None):
            i = next(iter(active))
            if self._run_draft_block(i, active[i]):
                with self.metrics.lock:
                    self.metrics.fast_blocks += 1
                return
        if self.lookup_decoding and spec_ok:
            greedy = all(self.slots[i].req.params.temp <= 0.0
                         for i in active)
            if greedy and len(active) == 1:
                i = next(iter(active))
                ok = self._run_lookup_block(i, active[i])
            else:
                ok = self._run_lookup_block_multi(active, greedy=greedy)
            if ok:
                with self.metrics.lock:
                    self.metrics.fast_blocks += 1
                return
        # multi-token device blocks when every active request uses
        # block-reproducible sampling; the block samples with ONE
        # top_k, so stochastic requests must agree on it (greedy ones
        # don't use it)
        if (self._block_ok(active, self._fast_eligible)
                and len({self.slots[i].req.params.top_k
                         for i in active
                         if self.slots[i].req.params.temp > 0.0}) <= 1
                and self._run_fast_block(active)):
            with self.metrics.lock:
                self.metrics.fast_blocks += 1
            return
        # second tier: the full device sampler chain (penalties +
        # default queue) -- covers the OpenAI-default request shape
        # that would otherwise take the per-token host loop
        if (not self.engine.recurrent
                and self._block_ok(active, fast_chain_eligible)
                and self._run_sampled_block(active)):
            with self.metrics.lock:
                self.metrics.fast_blocks += 1
                self.metrics.sampled_blocks += 1
            return
        with self.metrics.lock:
            self.metrics.slow_steps += 1
        for i, t in active.items():
            self.slots[i].hist.append(t)
        logits = self.engine.decode_batch(active)
        for i, lg in logits.items():
            self._sample_and_emit(i, lg)


def _chat_prompt(messages: list[dict], metadata: dict | None = None) -> str:
    """Render chat messages with the model's own template
    (llama_chat_apply_template; chatml fallback, server.cpp default)."""
    tmpl = template_from_metadata(metadata or {})
    return apply_chat_template(tmpl, messages, add_assistant=True)


def infill_tokens(engine, prefix: str, suffix: str) -> list[int]:
    """<PRE> prefix <SUF> suffix <MID> from the model's FIM special tokens
    (tpulamm.cli.infill.infill_tokens); ValueError without them."""
    md = engine.metadata
    tok = engine.tokenizer
    pre = md.get("tokenizer.ggml.prefix_token_id")
    suf = md.get("tokenizer.ggml.suffix_token_id")
    mid = md.get("tokenizer.ggml.middle_token_id")
    if pre is None or suf is None or mid is None:
        raise ValueError("model has no FIM tokens "
                         "(tokenizer.ggml.{prefix,suffix,middle}_token_id)")
    out = []
    if tok.vocab.add_bos and tok.vocab.bos_id >= 0:
        out.append(tok.vocab.bos_id)
    out.append(int(pre))
    out += tok.encode(prefix, add_bos=False)
    out.append(int(suf))
    out += tok.encode(suffix, add_bos=False)
    out.append(int(mid))
    return out


def make_handler(sched: Scheduler, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok",
                                 "slots_idle": sum(1 for s in sched.slots
                                                   if s.req is None),
                                 "slots_processing": sum(1 for s in sched.slots
                                                         if s.req is not None)})
            elif self.path == "/metrics":
                body = sched.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": model_name, "object": "model",
                     "owned_by": "tpulamm"}]})
            elif self.path == "/slots":
                # per-slot state (server.cpp GET /slots)
                out = []
                for i, s in enumerate(sched.slots):
                    req = s.req          # snapshot: scheduler may finish
                    out.append({         # the slot mid-render
                        "id": i, "state": 1 if req is not None else 0,
                        "n_past": int(sched.engine.n_past[i]),
                        "n_decoded": s.n_gen if req is not None else 0,
                        "cache_tokens": len(s.hist),
                        "rid": req.rid if req is not None else None})
                self._json(200, out)
            elif self.path == "/props":
                self._json(200, {"total_slots": sched.n_slots,
                                 "model": model_name,
                                 "system_prompt": sched.system_prompt})
            else:
                self._json(404, {"error": "not found"})

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _params_from(self, body: dict) -> SamplingParams:
            # n_probs (native) / logprobs (OpenAI int form)
            n_probs = int(body.get("n_probs", 0)
                          or (body.get("logprobs") or 0))
            bias = {int(k): float(v)
                    for k, v in (body.get("logit_bias") or {}).items()} \
                if isinstance(body.get("logit_bias"), dict) else {}
            return SamplingParams(
                temp=float(body.get("temperature", 0.8)),
                top_k=int(body.get("top_k", 40)),
                top_p=float(body.get("top_p", 0.95)),
                min_p=float(body.get("min_p", 0.05)),
                tfs_z=float(body.get("tfs_z", 1.0)),
                typical_p=float(body.get("typical_p", 1.0)),
                penalty_repeat=float(body.get("repeat_penalty", 1.1)),
                penalty_last_n=int(body.get("repeat_last_n", 64)),
                penalty_freq=float(body.get("frequency_penalty", 0.0)),
                penalty_present=float(body.get("presence_penalty", 0.0)),
                mirostat=int(body.get("mirostat", 0)),
                mirostat_tau=float(body.get("mirostat_tau", 5.0)),
                mirostat_eta=float(body.get("mirostat_eta", 0.1)),
                ignore_eos=bool(body.get("ignore_eos", False)),
                logit_bias=bias,
                seed=int(body.get("seed", 0xFFFFFFFF)),
                n_probs=n_probs,
            )

        def _send_event(self, data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def _end_stream(self):
            self._send_event(b"data: [DONE]\n\n")
            self.wfile.write(b"0\r\n\r\n")

        def _run_request(self, prompt, body, kind: str,
                         eot_id: int | None = None):
            n_predict = int(body.get("n_predict",
                                     body.get("max_tokens", 128)))
            if n_predict < 0:
                # server.cpp: -1 = generate until EOS/stop (context
                # shift keeps the window bounded)
                n_predict = 1 << 30
            stream = bool(body.get("stream", False))
            stop = body.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            grammar = body.get("grammar")
            rf = body.get("response_format") or {}
            schema = body.get("json_schema") or (
                (rf.get("json_schema") or {}).get("schema")
                if rf.get("type") == "json_schema" else None)
            if grammar is None and (schema is not None
                                    or rf.get("type") == "json_object"):
                # OpenAI response_format -> GBNF constraint
                try:
                    grammar = (schema_to_grammar(schema)
                               if schema is not None else json_grammar())
                except ValueError as e:
                    self._json(400, {"error": f"bad json_schema: {e}"})
                    return
            req = Request(prompt=prompt, params=self._params_from(body),
                          n_predict=n_predict, stream=stream,
                          grammar=grammar, eot_id=eot_id,
                          cache_prompt=bool(body.get("cache_prompt", False)),
                          stop_strs=[str(x) for x in stop])
            if body.get("rid"):
                req.rid = str(body["rid"])   # client-chosen id -> /cancel
            sched.submit(req)

            if stream:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send_chunk(obj):
                    self._send_event(f"data: {json.dumps(obj)}\n\n".encode())

                while True:
                    item = req.out.get()
                    try:
                        if item[0] == "tok":
                            send_chunk(self._stream_obj(kind, item[2], None,
                                                        item[3]))
                            continue
                        # "done" (its finish reason) or "error"
                        send_chunk(self._stream_obj(
                            kind, "", "error" if item[0] == "error"
                            else item[1]))
                        self._end_stream()
                        break
                    except OSError:
                        # client went away: stop generating for this slot
                        # (server.cpp cancels the task on disconnect)
                        req.cancel.set()
                        break
                return

            text = ""
            usage = {}
            finish = "stop"
            probs_acc = []
            while True:
                item = req.out.get()
                if item[0] == "error":
                    self._json(req.error_status, {"error": item[1]})
                    return
                if item[0] == "tok":
                    text += item[2]
                    if item[3] is not None:
                        probs_acc.append({"content": item[2],
                                          "probs": item[3]["top"],
                                          "sampled_prob":
                                              item[3]["sampled_prob"]})
                else:
                    finish = item[1]
                    usage = item[2]
                    break
            self._json(200, self._final_obj(kind, text, finish, usage,
                                            probs_acc or None))

        def _stream_obj(self, kind, piece, finish, probs=None):
            if kind == "chat":
                delta = {"content": piece} if piece else {}
                return {"id": "chatcmpl", "object": "chat.completion.chunk",
                        "model": model_name,
                        "choices": [{"index": 0, "delta": delta,
                                     "finish_reason": finish}]}
            if kind == "oai":
                return {"id": "cmpl", "object": "text_completion",
                        "model": model_name,
                        "choices": [{"index": 0, "text": piece,
                                     "finish_reason": finish}]}
            out = {"content": piece, "stop": finish is not None}
            if probs is not None:
                # server.cpp streams completion_probabilities per chunk
                out["completion_probabilities"] = [
                    {"content": piece, "probs": probs["top"],
                     "sampled_prob": probs["sampled_prob"]}]
            return out

        def _final_obj(self, kind, text, finish, usage, probs=None):
            u = {"prompt_tokens": usage.get("prompt_tokens", 0),
                 "completion_tokens": usage.get("completion_tokens", 0),
                 "total_tokens": usage.get("prompt_tokens", 0)
                 + usage.get("completion_tokens", 0)}
            if kind == "chat":
                return {"id": "chatcmpl", "object": "chat.completion",
                        "model": model_name,
                        "choices": [{"index": 0, "finish_reason": finish,
                                     "message": {"role": "assistant",
                                                 "content": text}}],
                        "usage": u}
            if kind == "oai":
                choice = {"index": 0, "text": text, "finish_reason": finish}
                if probs:
                    # OpenAI text-completion logprobs shape
                    choice["logprobs"] = {
                        "tokens": [p["content"] for p in probs],
                        "token_logprobs": [
                            float(np.log(max(p["sampled_prob"], 1e-30)))
                            for p in probs],
                        "top_logprobs": [
                            {q["tok_str"]:
                             float(np.log(max(q["prob"], 1e-30)))
                             for q in p["probs"]} for p in probs],
                    }
                return {"id": "cmpl", "object": "text_completion",
                        "model": model_name,
                        "choices": [choice],
                        "usage": u}
            out = {"content": text, "stop": True,
                   "stopped_eos": finish == "stop",
                   "tokens_predicted": u["completion_tokens"],
                   "tokens_evaluated": u["prompt_tokens"]}
            if probs:
                # server.cpp completion_probabilities payload
                out["completion_probabilities"] = probs
            return out

        def do_POST(self):
            body = self._read_body()
            if self.path in ("/completion", "/completions"):
                self._run_request(body.get("prompt", ""), body, "native")
            elif self.path == "/v1/completions":
                self._run_request(body.get("prompt", ""), body, "oai")
            elif self.path == "/v1/chat/completions":
                prompt = _chat_prompt(body.get("messages", []),
                                      sched.engine.metadata)
                self._run_request(prompt, body, "chat")
            elif self.path in ("/embedding", "/v1/embeddings"):
                inputs = body.get("input", body.get("content", ""))
                if isinstance(inputs, str):
                    inputs = [inputs]
                vecs = []
                for text in inputs:
                    req = Request(prompt=text, params=SamplingParams(),
                                  n_predict=0, stream=False, embed=True)
                    sched.submit(req)
                    kind, vec, _ = req.out.get()
                    if kind == "error":
                        self._json(req.error_status, {"error": vec})
                        return
                    vecs.append(vec)
                if self.path == "/embedding":
                    self._json(200, {"embedding": vecs[0]})
                else:
                    self._json(200, {
                        "object": "list", "model": model_name,
                        "data": [{"object": "embedding", "index": i,
                                  "embedding": v}
                                 for i, v in enumerate(vecs)]})
            elif self.path == "/infill":
                # FIM completion (server.cpp handle_infill)
                try:
                    toks = infill_tokens(sched.engine,
                                         str(body.get("input_prefix", "")),
                                         str(body.get("input_suffix", "")))
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                eot = sched.engine.metadata.get("tokenizer.ggml.eot_token_id")
                self._run_request(toks, body, "native",
                                  eot_id=int(eot) if eot is not None
                                  else None)
            elif self.path == "/system_prompt":
                # runtime shared-system-prompt update (the reference's
                # system_prompt task, server.cpp:1483-1487); applied when
                # every slot goes idle
                sp = body.get("system_prompt", body)
                text = sp.get("prompt", "") if isinstance(sp, dict) \
                    else str(sp)
                sched.set_system_prompt(text)
                self._json(200, {"status": "queued"})
            elif self.path == "/cancel":
                ok = sched.cancel(str(body.get("rid", "")))
                self._json(200 if ok else 404, {"cancelled": ok})
            elif self.path == "/tokenize":
                toks = sched.engine.tokenizer.encode(
                    body.get("content", ""), special=True)
                self._json(200, {"tokens": toks})
            elif self.path == "/detokenize":
                text = sched.engine.tokenizer.decode(body.get("tokens", []))
                self._json(200, {"content": text})
            else:
                self._json(404, {"error": "not found"})

    return Handler


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8080,
          n_slots: int = 4, n_ctx: int = 2048, compute_dtype=None,
          started: threading.Event | None = None, tp: int = 1, dp: int = 1,
          cache_type_k="bfloat16", cache_type_v=None,
          lookup_decoding: bool = False, system_prompt: str | None = None,
          broadcast: tuple[str, int] | None = None,
          model_draft: str | None = None, heartbeat: float = 5.0,
          device=None):
    """Load the model on `device` (default "cuda"; with no CUDA device that
    raises unless "cpu" is asked for), start the Scheduler and serve HTTP
    until the server is shut down. `started` (an Event) gets the httpd and
    the scheduler as attributes and is set once the port is bound.
    tp / dp: the engine's mesh (parallel.mesh). lookup_decoding: the
    prompt-lookup speculative tiers; model_draft: a draft GGUF, loaded as
    a one-slot Engine on the same device and attached for draft-model
    speculation.

    broadcast=(host, port): the multi-host serving transport
    (server.multihost) over an initialized multi-process world
    (parallel.distributed). Process 0 accepts process_count - 1 workers on
    `port`, wraps its engine so every engine call replicates to them, and
    serves HTTP as usual; the other processes connect to process 0's
    host:port and apply the call stream. Every process must reach this
    function with identical model / mesh arguments. A worker heartbeat
    fails requests with 503 within ~`heartbeat` seconds of a worker dying
    instead of hanging on the next collective."""
    from tpulamm_torch.runtime.engine import Engine
    if broadcast is not None and world() is None:
        raise ValueError("broadcast: the multi-host transport needs a "
                         "multi-process world (parallel.distributed)")
    engine = Engine(model_path, n_ctx=n_ctx, n_slots=n_slots,
                    compute_dtype=compute_dtype, kv_dtype=cache_type_k,
                    kv_dtype_v=cache_type_v, tp=tp, dp=dp, device=device)
    if model_draft:
        # every process attaches its own draft (small, unmeshed)
        engine.attach_draft(Engine(model_draft, n_ctx=n_ctx, n_slots=1,
                                   compute_dtype=compute_dtype,
                                   device=device))
    sched_holder = []

    def _on_worker_lost(idx: int):
        if sched_holder:
            sched_holder[0].on_worker_lost(idx)

    if broadcast is not None:
        index, count = world()
        bhost, bport = broadcast
        if index != 0:
            sock = connect_worker(bhost, bport)
            print(f"worker {index}: applying engine calls from "
                  f"{bhost}:{bport}", flush=True)
            worker_loop(engine, sock, heartbeat=heartbeat / 4)
            return
        tx = CallBroadcaster(bport, count - 1, on_worker_lost=_on_worker_lost,
                             dead_after=heartbeat)
        engine = MirroredEngine(engine, tx)
    sched = Scheduler(engine, n_slots, lookup_decoding=lookup_decoding)
    sched_holder.append(sched)
    if system_prompt:
        sched.set_system_prompt(system_prompt)
    sched.start()
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(sched, model_path))
    if started is not None:
        started.httpd = httpd  # type: ignore[attr-defined]
        started.sched = sched  # type: ignore[attr-defined]
        started.set()
    print(f"tpulamm_torch server listening on http://{host}:"
          f"{httpd.server_port} ({n_slots} slots, n_ctx={n_ctx}, "
          f"{engine.device})", flush=True)
    httpd.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-server")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("-np", "--parallel", type=int, default=4,
                   help="number of slots (continuous batching width)")
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--compute-dtype", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks of the mesh (all on --device)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel (slot-sharding) mesh dimension")
    add_distributed_args(p)
    p.add_argument("--broadcast-port", type=int, default=None,
                   help="multi-host serving: TCP port on process 0 for "
                        "the engine-call broadcast channel (default: "
                        "HTTP port + 1000)")
    p.add_argument("--mh-heartbeat", type=float, default=5.0,
                   help="multi-host: seconds without a worker heartbeat "
                        "before the worker is declared lost and in-flight "
                        "requests fail with 503")
    p.add_argument("-ctk", "--cache-type-k", default="bfloat16",
                   choices=KV_CACHE_TYPES)
    p.add_argument("-ctv", "--cache-type-v", default=None,
                   choices=KV_CACHE_TYPES)
    p.add_argument("--lookup-decoding", action="store_true",
                   help="prompt-lookup speculation (greedy-exact; wins on "
                        "weight-bound models)")
    p.add_argument("-md", "--model-draft", default=None,
                   help="draft model GGUF: single-active-slot draft-model "
                        "speculation (greedy-exact; temp>0 runs true "
                        "speculative sampling -- accept iff u <= p/q, "
                        "residual resample)")
    p.add_argument("-spf", "--system-prompt-file", default=None,
                   help="file with a system prompt shared by every slot "
                        "(one prefill + seq_cp fan-out; server.cpp -spf)")
    logm.add_args(p)
    args = p.parse_args(argv)
    logm.setup(args, "server")
    logm.log(f"args: {vars(args)}")
    require_file(p, args.model)
    require_file(p, args.model_draft, "draft model")
    info = init_from_args(args)
    broadcast = None
    if info is not None and info["process_count"] > 1:
        # multi-host serving: process 0 keeps the HTTP frontend and
        # mirrors every engine call to the other processes over a TCP side
        # channel (server.multihost); the worker address is the
        # coordinator's host
        bhost = (args.coordinator.rsplit(":", 1)[0]
                 if args.coordinator else "127.0.0.1")
        broadcast = (bhost, args.broadcast_port or args.port + 1000)
    system_prompt = None
    if args.system_prompt_file:
        with open(args.system_prompt_file, errors="replace") as f:
            system_prompt = f.read()
    serve(args.model, args.host, args.port, n_slots=args.parallel,
          n_ctx=args.ctx_size, compute_dtype=args.compute_dtype,
          tp=args.tp, dp=args.dp,
          cache_type_k=args.cache_type_k, cache_type_v=args.cache_type_v,
          system_prompt=system_prompt, lookup_decoding=args.lookup_decoding,
          broadcast=broadcast, model_draft=args.model_draft,
          heartbeat=args.mh_heartbeat, device=args.device)


if __name__ == "__main__":
    main()
