"""Decode engine: prefill / decode steps over the model forward
(counterpart of tpulamm.runtime.engine, core API).

- prompts are prefilled in ubatches of up to n_ubatch tokens, each run at
  its exact length (the JAX engine pads to power-of-two buckets so jit
  compiles few shapes; eager torch needs no padding, and since 16 is one
  of those buckets the int8/f32 kernel choice is the same)
- the KV cache holds n_ctx + 1 cells per slot; cell n_ctx is the trash
  cell that padding rows of a batched step write to
- decode runs one (B, 1) step per token; generate_fast samples on the
  device (greedy argmax, or top-k + torch.multinomial on a seeded
  torch.Generator) and generate samples on the host with Sampler
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
from tpulamm_torch.ops.qtensor import QTensor
from tpulamm_torch.runtime import kvcache as kv
from tpulamm_torch.runtime.kvcache import KVCache
from tpulamm_torch.runtime.sampling import Sampler, SamplingParams
from tpulamm_torch.tokenizer.spm import build_tokenizer


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


class Engine:
    KV_SPAN_MIN = 256

    def __init__(self, model_path: str, *, n_ctx: int = 2048,
                 n_slots: int = 1, n_ubatch: int = 512,
                 compute_dtype: str | None = None,
                 kv_dtype: torch.dtype = torch.bfloat16, device=None):
        """kv_dtype: a float dtype for K and V (the q8_0 cache is not
        ported yet)."""
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        self.cfg, self.params, self.metadata = load_model(
            model_path, compute_dtype=compute_dtype, device=self.device)
        self._fuse_projections()
        self.tokenizer = (build_tokenizer(self.metadata)
                          if "tokenizer.ggml.tokens" in self.metadata else None)
        self.n_ctx = n_ctx
        self.n_slots = n_slots
        self.n_ubatch = n_ubatch
        # cell n_ctx is the trash cell for padding rows
        self.cache = KVCache.create(self.cfg.n_layers, n_slots, n_ctx + 1,
                                    self.cfg.n_kv_heads, self.cfg.head_dim,
                                    dtype=kv_dtype, device=self.device)
        # host mirror of the cache's cell positions: cell allocation
        # (llama_kv_cache_find_slot, llama.cpp:2207) needs no device sync
        self.n_past = np.zeros(n_slots, np.int64)
        self.cell_pos = np.full((n_slots, n_ctx), -1, np.int64)
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

    # -- low-level ubatch execution ------------------------------------------
    def _kv_span(self, need: int) -> int | None:
        """Attention-span bucket: power of two covering every occupied KV
        cell plus `need` upcoming writes (None = the full cache), so
        attention reads only span cells."""
        cols = np.flatnonzero((self.cell_pos >= 0).any(axis=0))
        occ = int(cols[-1]) + 1 if len(cols) else 0
        s = max(occ + need, self.KV_SPAN_MIN)
        if s >= self.n_ctx:
            return None
        span = 1 << (s - 1).bit_length()
        return None if span >= self.n_ctx else int(span)

    def _step(self, tok: np.ndarray, pos: np.ndarray, cel: np.ndarray,
              slots: torch.Tensor | None) -> torch.Tensor:
        """One forward over a (B, T) batch; returns device logits."""
        # one host-to-device copy for tokens, positions and cells
        host = torch.from_numpy(np.stack([tok, pos, cel]).astype(np.int64))
        t, p, c = host.to(self.device)
        with torch.no_grad():
            logits, self.cache = forward(self.params, self.cfg, t, p,
                                         self.cache, slots, c,
                                         kv_span=self._kv_span(0))
        return logits

    def _slot_arg(self, slot: int) -> torch.Tensor | None:
        if self.n_slots == 1:
            return None
        return torch.full((1,), slot, dtype=torch.long, device=self.device)

    def _run_device(self, slot: int, tokens: np.ndarray,
                    positions: np.ndarray, cells: np.ndarray) -> torch.Tensor:
        """One ubatch for one slot -> (T, vocab) logits on the device."""
        logits = self._step(np.asarray(tokens)[None], np.asarray(positions)[None],
                            np.asarray(cells)[None], self._slot_arg(slot))
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
                f"free of {self.n_ctx} (context shift is not ported yet)")
        cells = free[:n]
        self.cell_pos[slot, cells] = positions
        return cells.astype(np.int32)

    def _check_room(self, slot: int):
        if self.n_past[slot] + 1 > self.n_ctx:
            raise NotImplementedError(
                "context full: context shift (seq_add + defrag) is not "
                "ported yet (ROADMAP queue 1)")

    # -- public API ------------------------------------------------------------
    def reset_slot(self, slot: int):
        self.seq_rm(slot)
        self.n_past[slot] = 0
        self.cell_pos[slot] = -1

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

    def _decode_device(self, slot: int, token: int) -> torch.Tensor:
        self._check_room(slot)
        pos = np.array([self.n_past[slot]], np.int32)
        cells = self._cells_for(slot, 1, pos)
        logits = self._run_device(slot, np.array([token], np.int32), pos,
                                  cells)
        self.n_past[slot] += 1
        return logits[0]

    def decode_one(self, slot: int, token: int) -> np.ndarray:
        """One decode step; returns (vocab,) logits."""
        t0 = time.perf_counter()
        logits = self._decode_device(slot, token).cpu().numpy()
        self.timings.t_eval += time.perf_counter() - t0
        self.timings.n_eval += 1
        return logits

    def decode_batch(self, toks: dict[int, int]) -> dict[int, np.ndarray]:
        """One decode step for several slots at once; idle slots run
        masked (position -1, trash cell)."""
        t0 = time.perf_counter()
        b = self.n_slots
        tok = np.zeros((b, 1), np.int32)
        pos = np.full((b, 1), -1, np.int32)
        cel = np.full((b, 1), self.n_ctx, np.int32)
        for slot, t in toks.items():
            self._check_room(slot)
            p = self.n_past[slot]
            tok[slot, 0] = t
            pos[slot, 0] = p
            cel[slot, 0] = self._cells_for(slot, 1, np.array([p]))[0]
            self.n_past[slot] += 1
        out = self._step(tok, pos, cel, None)[:, 0].cpu().numpy()
        self.timings.t_eval += time.perf_counter() - t0
        self.timings.n_eval += len(toks)
        return {slot: out[slot] for slot in toks}

    def rollback(self, slot: int, n_past: int):
        """Drop KV cells at positions >= n_past."""
        self.seq_rm(slot, int(n_past))
        self.n_past[slot] = n_past

    def seq_rm(self, slot: int, p0: int = 0, p1: int = kv.INT32_MAX):
        kv.seq_rm(self.cache, slot, p0, p1)
        cp = self.cell_pos[slot]
        cp[(cp >= p0) & (cp < p1)] = -1

    # -- generation -------------------------------------------------------------
    def _encode(self, prompt) -> list[int]:
        if isinstance(prompt, str):
            assert self.tokenizer is not None, "model has no tokenizer vocab"
            return self.tokenizer.encode(prompt, special=True)
        return list(prompt)

    def _eos(self) -> int:
        return self.tokenizer.vocab.eos_id if self.tokenizer else 2

    @staticmethod
    def _sample_next(lg: torch.Tensor, temp: float, top_k: int,
                     gen: torch.Generator) -> int:
        """Device sampler: greedy argmax, else top-k (0 = full vocab) +
        softmax at `temp` + one multinomial draw from `gen`."""
        if temp <= 0.0:
            return int(torch.argmax(lg))
        vals, idx = ((lg, None) if top_k <= 0
                     else torch.topk(lg, min(top_k, lg.shape[-1])))
        probs = torch.softmax(vals / max(temp, 1e-6), dim=-1)
        j = torch.multinomial(probs, 1, generator=gen)
        return int(j if idx is None else idx[j])

    def generate_fast(self, prompt, *, n_predict: int = 128,
                      temp: float = 0.0, top_k: int = 40, seed: int = 0,
                      slot: int = 0, stop_on_eos: bool = True):
        """Prefill, then a host loop of single-token decode steps with the
        sampling on the device. Returns (token_ids, text)."""
        tokens = self._encode(prompt)
        self.reset_slot(slot)
        logits = self.prefill(slot, tokens)
        t0 = time.perf_counter()
        first = int(np.argmax(logits))   # first token greedy, as in JAX
        eos = self._eos()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        out = [first]
        while len(out) < n_predict and not (stop_on_eos and out[-1] == eos):
            if self.n_past[slot] + 1 > self.n_ctx:
                break                                   # context full
            lg = self._decode_device(slot, out[-1])
            out.append(self._sample_next(lg, temp, top_k, gen))
        if stop_on_eos and eos in out:
            out = out[:out.index(eos)]
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
