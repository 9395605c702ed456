"""Decode engine: prefill / decode steps over the model forward
(counterpart of tpulamm.runtime.engine, core API).

- prompts are prefilled in ubatches of up to n_ubatch tokens, each run at
  its exact length. The JAX engine pads a ubatch to a PREFILL_BUCKETS
  length so jit compiles few shapes; eager torch needs no padding, but the
  attention kernel is chosen on that bucket length (forward's t_bucket),
  so the card runs the kernel the JAX package would (the kernels mask by
  the live query count). 16 is a bucket, so the int8/f32 choice of the
  projections is the same either way.
- the KV cache holds n_ctx + 1 cells per slot; cell n_ctx is the trash
  cell that padding rows of a batched step write to. kv_dtype picks its
  storage: a float dtype, or "q8_0" (int8 codes + per-row scales)
- a full context is handled as the JAX engine does: context shift (drop
  half of the tokens after the first n_keep, re-rope the rest, defrag) or,
  with grp_attn_n > 1, self-extend
- every decode step is a step graph (runtime.decode_graph): on CUDA one
  captured CUDA graph for each (path, B, kv_span, slot, sampler), replayed
  with no Python between its kernels; on the CPU the same step run
  eagerly. generate_fast decodes in blocks of DECODE_BUCKETS steps as the
  JAX engine's lax.scan blocks do (greedy argmax, or top-k + a Gumbel-max
  draw from the engine's torch.Generator, seeded seed + len(out) a block),
  checks EOS between blocks and rolls the cache back to the returned
  tokens; decode_one and decode_batch replay the graph of the forward
  alone and copy the logits back; generate samples on the host with
  Sampler
- the serving path: decode_batch, decode_batch_fast and
  decode_batch_sampled run over the first _b_rows slots (active-slot
  compaction); the two block methods keep n_steps of sampled tokens on the
  device and copy them back once (decode_batch_sampled's sampler chain
  runs eagerly after each replay of the forward's graph)
- the opt-in decode kernels (the JAX package's TPULAMM_MEGAKERNEL,
  TPULAMM_FUSED_FFN and TPULAMM_INT8_INKQ, here Engine options):
  megakernel=True makes each generate_fast step of a one-slot engine one
  launch through every layer (ops.mega_decode) in its own step graph;
  fused_ffn and int8_inkq change the kernels the forward runs on CUDA
- per-phase timings mirror llama_print_timings (llama.h:949)

Entry points run on CUDA unless the caller asks for the CPU; with no
CUDA device the default raises rather than falling back.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tpulamm_torch.models.llama import forward
from tpulamm_torch.models.loader import load_model
from tpulamm_torch.ops import device_sampling as ds
from tpulamm_torch.ops.mega_decode import build_mega, mega_decode_layers
from tpulamm_torch.ops.qtensor import QTensor
from tpulamm_torch.runtime import decode_graph as dg
from tpulamm_torch.runtime import kvcache as kv
from tpulamm_torch.runtime.kvcache import KVCache
from tpulamm_torch.runtime.sampling import Sampler, SamplingParams
from tpulamm_torch.tokenizer.spm import build_tokenizer


PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def resolve_device(device=None) -> torch.device:
    """None -> "cuda". A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the engine runs on the "
                           "GPU unless device='cpu' is passed")
    return dev


@dataclass
class Timings:
    t_load: float = 0.0
    t_sample: float = 0.0
    n_sample: int = 0
    t_prefill: float = 0.0
    n_prefill: int = 0
    t_eval: float = 0.0
    n_eval: int = 0
    n_step: int = 0         # decode steps run on the device (whole blocks)


class Engine:
    KV_SPAN_MIN = 256

    def __init__(self, model_path: str, *, n_ctx: int = 2048,
                 n_slots: int = 1, n_ubatch: int = 512,
                 compute_dtype: str | None = None,
                 kv_dtype=torch.bfloat16, kv_dtype_v=None,
                 flash_attn: bool | None = None, grp_attn_n: int = 1,
                 grp_attn_w: int = 512, megakernel: bool = False,
                 fused_ffn: bool = False, int8_inkq: bool = False,
                 device=None):
        """kv_dtype / kv_dtype_v: the K and V storage (-ctk / -ctv), a
        torch float dtype, its name, or "q8_0"; V defaults to K's.
        flash_attn: None picks the flash kernels by span as the JAX
        dispatch does; True / False forces them on / off.
        grp_attn_n / grp_attn_w: self-extend (grouped attention) factor
        and window; 1 = context shift when the window fills.
        megakernel: generate_fast decodes through the one-launch decode
        megakernel where the model and cache allow it (self.mega);
        fused_ffn: decode-size FFNs run the one-launch FFN kernel;
        int8_inkq: the int8 gemv quantizes its activations inside its
        launch. fused_ffn and int8_inkq act on CUDA only, as their JAX
        switches act on the TPU only."""
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        self.cfg, self.params, self.metadata = load_model(
            model_path, compute_dtype=compute_dtype, device=self.device)
        self.cfg.flash_attn = flash_attn
        self.cfg.fused_ffn = fused_ffn
        self.cfg.int8_inkq = int8_inkq
        self._fuse_projections()
        self.tokenizer = (build_tokenizer(self.metadata)
                          if "tokenizer.ggml.tokens" in self.metadata else None)
        self.n_ctx = n_ctx
        self.n_slots = n_slots
        if n_ubatch > PREFILL_BUCKETS[-1]:
            raise ValueError(f"n_ubatch={n_ubatch} exceeds the largest "
                             f"prefill bucket {PREFILL_BUCKETS[-1]}")
        self.n_ubatch = n_ubatch
        self.grp_attn_n = grp_attn_n
        self.grp_attn_w = grp_attn_w
        # tokens kept at the start of the window on context shift (--keep)
        self.n_keep = 4

        def storage(t):
            """(float dtype, None) or (None, "q8_0")"""
            if t == "q8_0":
                return None, t
            return (getattr(torch, t) if isinstance(t, str) else t), None
        kd, qk = storage(kv_dtype)
        vd, qv = storage(kv_dtype if kv_dtype_v is None else kv_dtype_v)
        # cell n_ctx is the trash cell for padding rows
        self.cache = KVCache.create(
            self.cfg.n_layers, n_slots, n_ctx + 1, self.cfg.n_kv_heads,
            self.cfg.head_dim, dtype=kd or torch.bfloat16,
            dtype_v=vd or torch.bfloat16, qtype_k=qk, qtype_v=qv,
            device=self.device)
        # host mirror of the cache's cell positions: cell allocation
        # (llama_kv_cache_find_slot, llama.cpp:2207) needs no device sync
        self.n_past = np.zeros(n_slots, np.int64)
        self.cell_pos = np.full((n_slots, n_ctx), -1, np.int64)
        self.ga_i = np.zeros(n_slots, np.int64)     # self-extend group index
        self.mega = self._build_mega() if megakernel else None
        # the step graphs (one memory pool) and the generator of their draws
        self.graphs = dg.DecodeGraphs(self.device, n_ctx)
        self._gen = torch.Generator(device=self.device)
        self.timings = Timings()
        self.timings.t_load = time.perf_counter() - t0

    def _fuse_projections(self):
        """Fuse the QKV and gate+up QTensors into one launch each (plane
        concat along N), and pad a tile-unfriendly lm head (vocab 32000)
        to a multiple of 1024; forward() slices the logits back."""
        out_w = self.params.get("output")
        quant = 1024
        if (isinstance(out_w, QTensor) and out_w.layout == "mm"
                and out_w.shape[0] % quant != 0 and out_w.shape[0] >= 4096):
            n_pad = -(-out_w.shape[0] // quant) * quant
            self.params["output"] = out_w.pad_n(n_pad)
            if self.params.get("output_b") is not None:
                b = self.params["output_b"]
                self.params["output_b"] = torch.cat(
                    [b, b.new_zeros(n_pad - b.shape[0])])

        def fusable(ws) -> bool:
            return (all(isinstance(w, QTensor) and w.layout == "mm"
                        for w in ws) and len({w.qtype for w in ws}) == 1)

        for layer in self.params.get("layers", []):
            ws = [layer.get(k) for k in ("wq", "wk", "wv")]
            if fusable(ws):
                layer["wqkv_fused"] = QTensor.concat_n(ws)
                bs = [layer.get(b) for b in ("bq", "bk", "bv")]
                if any(b is not None for b in bs):
                    layer["bqkv_fused"] = torch.cat([
                        b if b is not None else torch.zeros(
                            w.shape[0], dtype=torch.float32,
                            device=self.device)
                        for b, w in zip(bs, ws)])
                # drop the unfused tensors (they would double the weights)
                for key in ("wq", "wk", "wv", "bq", "bk", "bv"):
                    layer.pop(key, None)
            gu = [layer.get("w_gate"), layer.get("w_up")]
            if (fusable(gu) and gu[0].shape == gu[1].shape
                    and layer.get("b_gate") is None
                    and layer.get("b_up") is None):
                layer["wgateup_fused"] = QTensor.concat_n(gu)
                layer.pop("w_gate", None)
                layer.pop("w_up", None)

    def _build_mega(self):
        """The decode megakernel's operands when the model and cache
        qualify (engine.py:196-203 of the JAX package): a bf16 cache, an
        output head and out_norm, no out_norm bias; else None."""
        c, p = self.cache, self.params
        if (c.ks is not None or c.vs is not None
                or c.k[0].dtype != torch.bfloat16
                or c.v[0].dtype != torch.bfloat16
                or p.get("output") is None or p.get("out_norm") is None
                or p.get("out_norm_b") is not None):
            return None
        return build_mega(p, self.cfg)

    # -- low-level ubatch execution ------------------------------------------
    def _kv_span(self, need: int) -> int | None:
        """Attention-span bucket of a forward: _occupied_span(need), so
        attention reads only span cells. None (the full cache) on a
        megakernel engine, as in the JAX one (engine.py:451): its prefill,
        decode_one and decode_batch then make the JAX kernel choice;
        _mega_step keeps its own span view."""
        if self.mega is not None:
            return None
        return self._occupied_span(need)

    def _occupied_span(self, need: int) -> int | None:
        """Power of two covering every occupied KV cell plus `need`
        upcoming writes (None = the full cache)."""
        cols = np.flatnonzero((self.cell_pos >= 0).any(axis=0))
        occ = int(cols[-1]) + 1 if len(cols) else 0
        s = max(occ + need, self.KV_SPAN_MIN)
        if s >= self.n_ctx:
            return None
        span = 1 << (s - 1).bit_length()
        return None if span >= self.n_ctx else int(span)

    def _b_rows(self, ids) -> int | None:
        """Active-slot compaction bucket (the batch-dimension analogue of
        _kv_span): a batched step runs over only the first power-of-two
        many rows that cover every active slot id, so idle slots' KV is
        not streamed every step. None = the full batch. The slots=None
        forward reads and writes the FIRST B cache rows, so no renumbering
        is needed while slots are assigned lowest-free first. The
        megakernel engine keeps the full batch, as the JAX one does."""
        if self.mega is not None:
            return None
        hi = max(ids) + 1
        b = 1 << (hi - 1).bit_length() if hi > 1 else 1
        return None if b >= self.n_slots else b

    @staticmethod
    def _assert_b_cover(ids, b: int):
        """The compacted step reads and writes only the first b cache rows,
        so every active slot id must fit the bucket; a bucket that does not
        fails here rather than giving silently wrong rows."""
        bad = [int(i) for i in ids if not 0 <= int(i) < b]
        if bad:
            raise AssertionError(
                f"active slot ids {bad} outside compaction bucket {b}")

    @staticmethod
    def _bucket_for(t: int) -> int:
        """Smallest prefill bucket >= t (the JAX engine's padded length;
        t <= n_ubatch <= PREFILL_BUCKETS[-1])."""
        return next(b for b in PREFILL_BUCKETS if b >= t)

    def _step(self, tok: np.ndarray, pos: np.ndarray, cel: np.ndarray,
              slot: int) -> torch.Tensor:
        """One eager forward over one slot's (1, T) prefill ubatch; returns
        device logits (decode steps replay graphs: _graph)."""
        n = tok.shape[1]
        # one host-to-device copy for tokens, positions and cells
        host = torch.from_numpy(np.stack([tok, pos, cel]).astype(np.int64))
        t, p, c = host.to(self.device)
        with torch.no_grad():
            logits, self.cache = forward(self.params, self.cfg, t, p,
                                         self.cache, slot, c,
                                         kv_span=self._kv_span(0),
                                         t_bucket=(self._bucket_for(n)
                                                   if n > 1 else 1))
        return logits

    def _run_device(self, slot: int, tokens: np.ndarray,
                    positions: np.ndarray, cells: np.ndarray) -> torch.Tensor:
        """One ubatch for one slot -> (T, vocab) logits on the device."""
        logits = self._step(np.asarray(tokens)[None], np.asarray(positions)[None],
                            np.asarray(cells)[None], int(slot))
        return logits[0]

    def _run(self, slot: int, tokens: np.ndarray, positions: np.ndarray,
             cells: np.ndarray, all_logits: bool = True) -> np.ndarray:
        logits = self._run_device(slot, tokens, positions, cells)
        if not all_logits:
            logits = logits[-1:]
        return logits.cpu().numpy()

    def _cells_for(self, slot: int, n: int, positions: np.ndarray) -> np.ndarray:
        """Allocate n free cells (host mirror of llama_kv_cache_find_slot)."""
        free = np.flatnonzero(self.cell_pos[slot] < 0)
        if len(free) < n:
            raise RuntimeError(
                f"KV cache full for slot {slot}: need {n}, have {len(free)} "
                f"free of {self.n_ctx} (context shift should have freed "
                "space)")
        cells = free[:n]
        self.cell_pos[slot, cells] = positions
        return cells.astype(np.int32)

    # -- public API ------------------------------------------------------------
    def reset_slot(self, slot: int):
        self.seq_rm(slot)
        self.n_past[slot] = 0
        self.cell_pos[slot] = -1
        self.ga_i[slot] = 0

    def prefill(self, slot: int, tokens: list[int],
                logits_all: bool = False) -> np.ndarray:
        """Feed prompt tokens; returns logits of the final position (or of
        every position)."""
        t0 = time.perf_counter()
        out = []
        toks = np.asarray(tokens, np.int32)
        for off in range(0, len(toks), self.n_ubatch):
            chunk = toks[off:off + self.n_ubatch]
            pos = self.n_past[slot] + np.arange(len(chunk))
            cells = self._cells_for(slot, len(chunk), pos)
            logits = self._run(slot, chunk, pos.astype(np.int32), cells,
                               all_logits=logits_all)
            self.n_past[slot] += len(chunk)
            out.append(logits if logits_all else logits[-1:])
        self.timings.t_prefill += time.perf_counter() - t0
        self.timings.n_prefill += len(toks)
        return np.concatenate(out) if logits_all else out[-1][0]

    # -- decode steps: the step graphs (runtime.decode_graph) ----------------
    def _graph(self, path: str, B: int, span, slots, sampler) -> dg.StepGraph:
        """The step graph of one key. path "step" (the (B, 1) forward) or
        "mega" (the megakernel step, B = 1); span: the forward's kv_span or
        the megakernel's span view; slots: an int slot or None (the first
        B); sampler "logits" (the forward alone, its logits kept),
        "greedy" or ("top_k", k)."""
        def make():
            bufs = dg.StepBuffers(B, self.device, self.cfg.vocab_size
                                  if sampler == "logits" else None)
            gen, sample = None, None
            if sampler == "greedy":
                sample = dg.greedy
            elif sampler != "logits":
                gen = self._gen
                sample = dg.top_k_sampler(bufs, sampler[1], gen)
            if path == "mega":
                body = dg.mega_step(self, mega_decode_layers, bufs, span,
                                    slots, sample)
            else:
                body = dg.forward_step(self, forward, bufs, span, slots,
                                       sample)
            return bufs, body, gen
        return self.graphs.get((path, B, span, slots, sampler), make)

    def _mega_span(self, need: int) -> int:
        """The megakernel's span view: _occupied_span(need), else the whole
        cache row."""
        return self._occupied_span(need) or self.cache.pos.shape[1]

    def _block(self, path: str, slots, tok, pos, act, n_steps: int,
               temp, top_k: int, seed: int) -> np.ndarray:
        """n_steps decode steps of a block (JAX: one lax.scan dispatch)
        from (B,) host tokens, positions and active flags: cell = position,
        the span fixed for the block (_kv_span(n_steps), or the
        megakernel's view). The inputs go over in one copy, the step graph
        replays n_steps times and the (n_steps, B) tokens come back in one
        copy; temp (B,) picks the sampler: greedy where every active row
        is at temp <= 0, else top-k with the generator seeded `seed`."""
        act = np.asarray(act, bool)
        temp = np.asarray(temp, np.float32)
        sampler = ("greedy" if np.all(temp[act] <= 0.0)
                   else ("top_k", int(top_k)))
        span = (self._mega_span(n_steps) if path == "mega"
                else self._kv_span(n_steps))
        g = self._graph(path, len(tok), span, slots, sampler)
        g.bufs.stage(tok, pos, pos, act, temp)
        if sampler != "greedy":
            self._gen.manual_seed(seed)
        out = g.run(n_steps)
        self.timings.n_step += n_steps
        return out

    def _step_logits(self, slots, tok, pos, cel, act) -> np.ndarray:
        """One (B, 1) forward step through the graph of the forward alone
        (JAX: one jitted dispatch) -> (B, vocab) host logits."""
        g = self._graph("step", len(tok), self._kv_span(0), slots, "logits")
        g.bufs.stage(tok, pos, cel, act)
        self.timings.n_step += 1
        return g.logits()

    def _mega_step(self, slot: int, token: int) -> np.ndarray:
        """One decode step of a fresh-slot stream through the megakernel's
        graph (span _occupied_span(0)); returns (vocab,) host logits."""
        pos = int(self.n_past[slot])
        cell = int(self._cells_for(slot, 1, np.array([pos]))[0])
        g = self._graph("mega", 1, self._mega_span(0), slot, "logits")
        g.bufs.stage([token], [pos], [cell], [1])
        self.timings.n_step += 1
        lg = g.logits()[0]
        self.n_past[slot] += 1
        return lg

    def decode_one(self, slot: int, token: int) -> np.ndarray:
        """One decode step; returns (vocab,) logits."""
        t0 = time.perf_counter()
        self._maybe_shift(slot)
        pos = int(self.n_past[slot])
        cell = self._cells_for(slot, 1, np.array([pos]))[0]
        logits = self._step_logits(int(slot), [token], [pos], [cell], [1])[0]
        self.n_past[slot] += 1
        self.timings.t_eval += time.perf_counter() - t0
        self.timings.n_eval += 1
        return logits

    def decode_batch(self, toks: dict[int, int]) -> dict[int, np.ndarray]:
        """One decode step for several slots at once over the first
        _b_rows slots; idle slots among them run masked (position -1,
        trash cell)."""
        t0 = time.perf_counter()
        b = self._b_rows(toks) or self.n_slots
        self._assert_b_cover(toks, b)
        tok = np.zeros(b, np.int32)
        pos = np.full(b, -1, np.int32)
        cel = np.full(b, self.n_ctx, np.int32)
        act = np.zeros(b, np.int32)
        for slot, t in toks.items():
            self._maybe_shift(slot)
            p = self.n_past[slot]
            tok[slot], pos[slot], act[slot] = t, p, 1
            cel[slot] = self._cells_for(slot, 1, np.array([p]))[0]
            self.n_past[slot] += 1
        out = self._step_logits(None, tok, pos, cel, act)
        self.timings.t_eval += time.perf_counter() - t0
        self.timings.n_eval += len(toks)
        return {slot: out[slot] for slot in toks}

    # -- multi-token decode blocks (the serving path) -------------------------
    def _block_inputs(self, toks: dict[int, int], n_steps: int, name: str):
        """The guards of a decode block (contiguous cells, room for
        n_steps + 1 more), then (B, tok, pos, act) host arrays over the
        _b_rows bucket."""
        for s in toks:
            n = int(self.n_past[s])
            if not np.array_equal(self.cell_pos[s, :n], np.arange(n)):
                raise ValueError(f"slot {s}: cells not contiguous; "
                                 "use decode_batch")
            if n + n_steps + 1 > self.n_ctx:
                raise ValueError(f"{name} would overflow n_ctx")
        b = self._b_rows(toks) or self.n_slots
        self._assert_b_cover(toks, b)
        tok = np.zeros(b, np.int64)
        pos = np.zeros(b, np.int64)
        act = np.zeros(b, bool)
        for s, t in toks.items():
            tok[s] = t
            pos[s] = self.n_past[s]
            act[s] = True
        return b, tok, pos, act

    def _finish_block(self, toks: dict[int, int], n_steps: int,
                      out: np.ndarray, t0: float) -> dict[int, list[int]]:
        """Advance the host mirrors past a block; {slot: its tokens}."""
        res = {}
        for s in toks:
            start = int(self.n_past[s])
            self.n_past[s] = start + n_steps
            self.cell_pos[s, start:start + n_steps] = np.arange(
                start, start + n_steps)
            res[s] = [int(t) for t in out[:, s]]
        self.timings.t_eval += time.perf_counter() - t0
        self.timings.n_eval += n_steps * len(toks)
        return res

    def decode_batch_fast(self, toks: dict[int, int], n_steps: int, *,
                          temp: dict[int, float] | float = 0.0,
                          top_k: int = 40, seed: int = 0
                          ) -> dict[int, list[int]]:
        """Decode n_steps tokens for several slots in one device-resident
        block (JAX: one lax.scan dispatch): n_steps replays of the step
        graph with its sampler inside.

        Requires contiguous cells per slot (true after reset + prefill, not
        after a context shift) and plain temp / top-k sampling: greedy
        argmax, or top-k (0 = the full vocab) at `temp` with one draw a row
        from the engine's generator seeded with `seed`; rows with temp <= 0
        take the argmax. The draw is the Gumbel-max form of a multinomial
        draw from softmax(top-k / temp): torch.multinomial checks its input
        on the host, a sync a step. Returns {slot: [n_steps tokens]}, where
        result[s][0] is the token AFTER toks[s]."""
        b, tok, pos, act = self._block_inputs(toks, n_steps,
                                              "decode_batch_fast")
        t0 = time.perf_counter()
        tv = np.zeros(b, np.float32)
        for s in toks:
            tv[s] = temp if isinstance(temp, (int, float)) else temp.get(s, 0.0)
        out = self._block("step", None, tok, pos, act, n_steps, tv, top_k,
                          seed)
        return self._finish_block(toks, n_steps, out, t0)

    def decode_batch_sampled(self, toks: dict[int, int], n_steps: int,
                             samplers: dict, seed: int = 0
                             ) -> dict[int, list[int]]:
        """decode_batch_fast with the full sampler chain on the device
        (ops.device_sampling: penalties over a token ring, the default
        queue with per-slot parameters). Each step replays the graph of
        the forward alone; the chain runs eagerly after it, on the device
        (its ring cursor is a host int), and feeds the token back into the
        graph's buffers.

        samplers: {slot: runtime.sampling.Sampler} supplies per-slot
        params and the penalty history (Sampler.prev). The caller must
        accept() the returned tokens into each Sampler to keep host state
        canonical for the next block."""
        b, tok, pos, act = self._block_inputs(toks, n_steps,
                                              "decode_batch_sampled")
        t0 = time.perf_counter()
        sp = ds.params_to(ds.params_from_samplers(samplers, b), self.device)
        ring, wr = ds.ring_from_prev(
            {s: smp.prev for s, smp in samplers.items() if smp is not None}, b)
        ring = torch.from_numpy(ring).to(self.device)
        vocab = self.cfg.vocab_size
        eos_id, nl_id = self._eos(), (13 if vocab > 13 else 0)
        counts = ds.build_counts(ring, wr, sp.last_n, vocab)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        g = self._graph("step", b, self._kv_span(n_steps), None, "logits")
        bufs = g.bufs
        bufs.stage(tok, pos, pos, act)
        active = bufs.act.bool()
        out = torch.empty((n_steps, b), dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for i in range(n_steps):
                g.replay()
                nxt = torch.where(active, ds.sample_chain(
                    bufs.logits, gen, sp, counts, nl_id, eos_id),
                    bufs.tok.long())
                # host sampler semantics: the sampled token enters the
                # penalty window at once (accept at sample)
                ring, wr, counts = ds.push_token(ring, wr, counts, sp.last_n,
                                                 nxt, active)
                bufs.tok.copy_(nxt)
                out[i] = nxt
        self.timings.n_step += n_steps
        return self._finish_block(toks, n_steps, out.cpu().numpy(), t0)

    def rollback(self, slot: int, n_past: int):
        """Drop KV cells at positions >= n_past."""
        self.seq_rm(slot, int(n_past))
        self.n_past[slot] = n_past

    def seq_rm(self, slot: int, p0: int = 0, p1: int = kv.INT32_MAX):
        kv.seq_rm(self.cache, slot, p0, p1)
        cp = self.cell_pos[slot]
        cp[(cp >= p0) & (cp < p1)] = -1

    def seq_cp(self, src: int, dst: int):
        """Copy a slot's KV cells and host state to another slot."""
        kv.seq_cp(self.cache, src, dst)
        self.n_past[dst] = self.n_past[src]
        self.cell_pos[dst] = self.cell_pos[src]
        self.ga_i[dst] = self.ga_i[src]

    def seq_add(self, slot: int, p0: int, p1: int, delta: int):
        kv.seq_add(self.cache, slot, p0, p1, delta, self.cfg.rope)
        cp = self.cell_pos[slot]
        m = (cp >= p0) & (cp < p1)
        cp[m] += delta
        cp[m & (cp < 0)] = -1

    def seq_div(self, slot: int, p0: int, p1: int, d: int):
        kv.seq_div(self.cache, slot, p0, p1, d, self.cfg.rope)
        cp = self.cell_pos[slot]
        m = (cp >= p0) & (cp < p1)
        cp[m] //= d

    # -- context management (main.cpp:540-598) --------------------------------
    def _maybe_shift(self, slot: int):
        if self.grp_attn_n > 1:
            self._self_extend(slot)
            return
        if self.n_past[slot] + 1 <= self.n_ctx:
            return
        # context shift: drop half of the tokens after n_keep, shift the rest
        n_left = int(self.n_past[slot]) - self.n_keep
        n_discard = n_left // 2
        self.seq_rm(slot, self.n_keep, self.n_keep + n_discard)
        self.seq_add(slot, self.n_keep + n_discard, int(self.n_past[slot]),
                     -n_discard)
        self.n_past[slot] -= n_discard
        self.defrag()

    def defrag(self):
        """Compact live cells to the front of every slot, keeping their
        order, and the host cell mirror with them."""
        kv.defrag(self.cache)
        for row in self.cell_pos:
            live = row[row >= 0]
            row[:] = -1
            row[:len(live)] = live

    def _self_extend(self, slot: int):
        """Self-extend position surgery, main.cpp:575-598: ib =
        (ga_n * ga_i) / ga_w, and n_past shrinks by bd each shift."""
        ga_n, ga_w = self.grp_attn_n, self.grp_attn_w
        while self.n_past[slot] >= self.ga_i[slot] + ga_w:
            i, np_ = int(self.ga_i[slot]), int(self.n_past[slot])
            ib = (ga_n * i) // ga_w
            bd = (ga_w // ga_n) * (ga_n - 1)
            dd = (ga_w // ga_n) - ib * bd - ga_w
            self.seq_add(slot, i, np_, ib * bd)
            self.seq_div(slot, i + ib * bd, i + ib * bd + ga_w, ga_n)
            self.seq_add(slot, i + ib * bd + ga_w, np_ + ib * bd, dd)
            self.n_past[slot] -= bd
            self.ga_i[slot] += ga_w // ga_n

    # -- generation -------------------------------------------------------------
    def _encode(self, prompt) -> list[int]:
        if isinstance(prompt, str):
            assert self.tokenizer is not None, "model has no tokenizer vocab"
            return self.tokenizer.encode(prompt, special=True)
        return list(prompt)

    def _eos(self) -> int:
        return self.tokenizer.vocab.eos_id if self.tokenizer else 2

    def generate_fast(self, prompt, *, n_predict: int = 128,
                      temp: float = 0.0, top_k: int = 40, seed: int = 0,
                      slot: int = 0, stop_on_eos: bool = True):
        """Prefill, then decode blocks on the device as the JAX engine runs
        them (engine.py:1519-1612): the first token greedy; blocks of
        DECODE_BUCKETS steps (decode_graph.pick_block), each seeded seed +
        len(out), with EOS checked between blocks; step i of a block writes
        the KV of the token it carries at cell = position. Afterwards the
        cache is rolled back to start + min(len(out), steps written): it
        holds the returned tokens, all but the last where the output
        filled the blocks exactly. The megakernel serves a one-slot engine
        (engine.py:1538-1544). Needs a fresh slot (it is reset). Returns
        (token_ids, text)."""
        tokens = self._encode(prompt)
        self.reset_slot(slot)
        logits = self.prefill(slot, tokens)
        t0 = time.perf_counter()
        first = int(np.argmax(logits))   # first token greedy, as in JAX
        eos = self._eos()
        path = ("mega" if self.mega is not None and self.n_slots == 1
                else "step")
        start0 = int(self.n_past[slot])
        out = [first]
        while len(out) < n_predict and not (stop_on_eos and eos in out):
            n = dg.pick_block(n_predict - len(out),
                              self.n_ctx - int(self.n_past[slot]) - 1)
            if n <= 0:
                break                  # context full: no shift, as in JAX
            startb = int(self.n_past[slot])
            toks = self._block(path, int(slot), [out[-1]], [startb], [1], n,
                               [temp], top_k, seed + len(out))
            self.n_past[slot] = startb + n
            self.cell_pos[slot, startb:startb + n] = np.arange(startb,
                                                               startb + n)
            out.extend(int(t) for t in toks[:, 0])
        total_written = int(self.n_past[slot]) - start0
        out = out[:n_predict]
        if stop_on_eos and eos in out:
            out = out[:out.index(eos)]
        target = start0 + min(len(out), total_written)
        if target != int(self.n_past[slot]):
            self.rollback(slot, target)
        self.timings.t_eval += time.perf_counter() - t0
        self.timings.n_eval += len(out)
        text = self.tokenizer.decode(out) if self.tokenizer else ""
        return out, text

    def generate(self, prompt: str | list[int], *, n_predict: int = 128,
                 sampling: SamplingParams | None = None, slot: int = 0,
                 stop_on_eos: bool = True):
        """Generate tokens with the host Sampler; returns (token_ids, text)."""
        tokens = self._encode(prompt)
        sampling = sampling or SamplingParams()
        eos = self._eos()
        nl = 13
        if self.tokenizer is not None:
            ids = self.tokenizer.encode("\n", add_bos=False)
            nl = ids[-1] if ids else 13
        sampler = Sampler(sampling, self.cfg.vocab_size, eos_id=eos, nl_id=nl)
        for t in tokens:
            sampler.accept(t, apply_grammar=False)
        logits = self.prefill(slot, tokens)
        out_ids: list[int] = []
        for _ in range(n_predict):
            t0 = time.perf_counter()
            tok = sampler.sample(logits)
            sampler.accept(tok)
            self.timings.t_sample += time.perf_counter() - t0
            self.timings.n_sample += 1
            if stop_on_eos and tok == eos and not sampling.ignore_eos:
                break
            out_ids.append(tok)
            logits = self.decode_one(slot, tok)
        text = self.tokenizer.decode(out_ids) if self.tokenizer else ""
        return out_ids, text
