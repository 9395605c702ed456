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
  Sampler, with the JAX engine's grammar, classifier-free guidance (a
  second slot), stop tokens and streaming
- abort_callback (set_abort_callback) is checked before each prefill or
  embed ubatch (AbortError), between generate_fast blocks and before each
  generate token (the partial output); load_abort cancels a model load
- the serving path: decode_batch, decode_batch_fast and
  decode_batch_sampled run over the first _b_rows slots (active-slot
  compaction); the two block methods keep n_steps of sampled tokens on the
  device and copy them back once (decode_batch_sampled's sampler chain
  runs eagerly after each replay of the forward's graph); move_slot
  renumbers a slot (the server keeps active slots a low prefix)
- embed runs the forward without the lm head over a slot's ubatches and
  pools the final-norm hidden states (the server's /embedding);
  eval_embeds feeds precomputed input embeddings (llava's image) in
  n_ubatch chunks at their exact length, with the prefill's kernel choice
- a recurrent model (mamba, models.mamba) carries a MambaState of per-slot
  conv and SSM rows in place of the KV cache, as the JAX engine's
  `recurrent` branches do: no cells, no span, no context shift; rollback
  and position surgery raise; its decode blocks are step graphs over the
  state's static buffers; the megakernel, the sampled block, eval_embeds,
  eval_segmented and speculation are refused
- speculation (runtime.speculative, spec_tree, lookahead): eval_tokens
  (the verify of the host loops), eval_segmented (a compound batch with
  packed segment ranges, the einsum attention with the segment mask), and
  the serving hooks spec_lookup_block, spec_lookup_block_multi,
  attach_draft and spec_draft_block, whose cycles are captured graphs in
  this engine's pool
- the opt-in decode kernels (the JAX package's TPULAMM_MEGAKERNEL,
  TPULAMM_FUSED_FFN and TPULAMM_INT8_INKQ, here Engine options):
  megakernel=True makes each generate_fast step of a one-slot engine one
  launch through every layer (ops.mega_decode) in its own step graph;
  fused_ffn and int8_inkq change the kernels the forward runs on CUDA;
  int8_dot (TPULAMM_INT8_DOT) turns qmm's int8 dots off ("0") or forces
  them ("force") at M <= 16 (tools.int8_kl_audit)
- a (dp, tp) mesh (tp=, dp=; parallel.mesh): the weights cut by the
  megatron shard plan into per-rank tensors, the cache into per-rank
  caches of the rank's kv heads and dp group's slots, every rank on this
  engine's device (a process's one card; several processes through
  parallel.distributed, each holding whole dp groups or a part of one:
  every process gets the whole batch's logits, and a slot copied between
  dp groups moves between processes). As in the JAX engine, prefill and
  single-slot steps then run the all-slots batch with the other rows
  padded to the trash cell, the active-slot compaction and the megakernel
  are off, the speculation hooks need dp == 1 and the draft tier an
  unmeshed target; generate_fast decodes through the all-slots blocks. A step on a
  one-process mesh is still one captured CUDA graph; a multi-process
  mesh (a gloo collective cannot be captured) steps eagerly.
- per-phase timings mirror llama_print_timings (llama.h:949)

Entry points run on CUDA unless the caller asks for the CPU; with no
CUDA device the default raises rather than falling back.
"""

from __future__ import annotations

import codecs
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpulamm_torch.grammar.engine import Grammar
from tpulamm_torch.models import mamba
from tpulamm_torch.models.llama import forward
from tpulamm_torch.models.loader import AbortError, load_model
from tpulamm_torch.ops import device_sampling as ds
from tpulamm_torch.ops.mega_decode import build_mega, mega_decode_layers
from tpulamm_torch.ops.qmm import INT8_MODES
from tpulamm_torch.ops.qtensor import QTensor
from tpulamm_torch.parallel import distributed
from tpulamm_torch.parallel import mesh as pmesh
from tpulamm_torch.runtime import decode_graph as dg
from tpulamm_torch.runtime import kvcache as kv
from tpulamm_torch.runtime.kvcache import KVCache, MeshCache
from tpulamm_torch.runtime.sampling import (Sampler, SamplingParams,
                                           apply_guidance)
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

    def report(self) -> str:
        lines = []
        lines.append(f"load time = {self.t_load * 1e3:10.2f} ms")
        if self.n_sample:
            lines.append(
                f"sample time = {self.t_sample * 1e3:10.2f} ms / "
                f"{self.n_sample:5d} runs ("
                f"{self.t_sample * 1e3 / self.n_sample:8.2f} ms per token, "
                f"{self.n_sample / max(self.t_sample, 1e-9):8.2f} tokens per second)")
        if self.n_prefill:
            lines.append(
                f"prompt eval time = {self.t_prefill * 1e3:10.2f} ms / "
                f"{self.n_prefill:5d} tokens ("
                f"{self.t_prefill * 1e3 / self.n_prefill:8.2f} ms per token, "
                f"{self.n_prefill / max(self.t_prefill, 1e-9):8.2f} tokens per second)")
        if self.n_eval:
            lines.append(
                f"eval time = {self.t_eval * 1e3:10.2f} ms / "
                f"{self.n_eval:5d} runs ("
                f"{self.t_eval * 1e3 / self.n_eval:8.2f} ms per token, "
                f"{self.n_eval / max(self.t_eval, 1e-9):8.2f} tokens per second)")
        return "\n".join(lines)


class Engine:
    KV_SPAN_MIN = 256
    # the decode block lengths (a speculation block's max_steps bucket)
    DECODE_BUCKETS = dg.DECODE_BUCKETS

    def __init__(self, model_path: str, *, n_ctx: int = 2048,
                 n_slots: int = 1, n_ubatch: int = 512,
                 compute_dtype: str | None = None,
                 kv_dtype=torch.bfloat16, kv_dtype_v=None,
                 flash_attn: bool | None = None, grp_attn_n: int = 1,
                 grp_attn_w: int = 512, megakernel: bool = False,
                 fused_ffn: bool = False, int8_inkq: bool = False,
                 int8_dot="1", lora_path: str | None = None, kv_overrides=None,
                 tp: int = 1, dp: int = 1, load_abort=None, device=None):
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
        launch. int8_dot: qmm's int8 activation dots at M <= 16 (the JAX
        TPULAMM_INT8_DOT): "1" (or True) unless f32 compute was asked for,
        "0" (or False) never, "force" under any compute dtype; it changes
        qmm's path choice only (ops.qmm.use_int8), not the megakernel's or
        the fused FFN's. fused_ffn, int8_inkq and int8_dot act on CUDA
        only, as their JAX switches act on the TPU only.
        lora_path: a LoRA adapter GGUF applied to the loaded weights
        (dequantize, add, requantize: train.lora.apply_lora_to_qparams)
        before the projections are fused, so the fused QKV and gate|up
        carry the delta (llama_model_apply_lora_from_file, --lora).
        kv_overrides: GGUF metadata values applied before the model's
        hyperparameters are read (--override-kv, models.loader).
        tp / dp: the tensor- and data-parallel mesh (parallel.mesh): every
        rank on `device`; under an initialized multi-process
        torch.distributed world (parallel.distributed), this process's
        block of the ranks.
        load_abort: () -> bool, checked before each layer loads; True
        cancels the load with AbortError."""
        if int8_dot not in INT8_MODES:
            raise ValueError(f"int8_dot={int8_dot!r}: one of {INT8_MODES}")
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        self.cfg, self.params, self.metadata = load_model(
            model_path, compute_dtype=compute_dtype, device=self.device,
            kv_overrides=kv_overrides, abort=load_abort)
        self.cfg.flash_attn = flash_attn
        self.cfg.fused_ffn = fused_ffn
        self.cfg.int8_inkq = int8_inkq
        self.cfg.int8_dot = int8_dot
        if lora_path:
            # llama_model_apply_lora_from_file parity (llama.h:436)
            from tpulamm_torch.train.lora import (apply_lora_to_qparams,
                                                  load_lora_gguf)
            self.params = apply_lora_to_qparams(
                self.params, load_lora_gguf(lora_path), self.cfg)
        self.tp, self.dp = int(tp), int(dp)
        self.mesh = None
        meshed = self.tp * self.dp > 1 or distributed.world() is not None
        if meshed:
            self._validate_mesh(n_slots)
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
        # recurrent archs (mamba) carry an SSM state instead of a KV cache
        self.recurrent = self.cfg.arch == "mamba"

        def make_cache(rows: int, kv_heads: int):
            if self.recurrent:
                return mamba.MambaState.create(self.cfg, rows, self.device)
            # cell n_ctx is the trash cell for padding rows
            return KVCache.create(
                self.cfg.n_layers, rows, n_ctx + 1, kv_heads,
                self.cfg.head_dim, dtype=kd or torch.bfloat16,
                dtype_v=vd or torch.bfloat16, qtype_k=qk, qtype_v=qv,
                device=self.device)
        self.cfg_step = self.cfg
        if meshed:
            self._setup_mesh(make_cache)
        else:
            self.cache = make_cache(n_slots, self.cfg.n_kv_heads)
        # host mirror of the cache's cell positions: cell allocation
        # (llama_kv_cache_find_slot, llama.cpp:2207) needs no device sync
        self.n_past = np.zeros(n_slots, np.int64)
        self.cell_pos = np.full((n_slots, n_ctx), -1, np.int64)
        self.ga_i = np.zeros(n_slots, np.int64)     # self-extend group index
        # the megakernel is off under a mesh (engine.py:196 of the JAX one)
        self.mega = (self._build_mega() if megakernel and self.mesh is None
                     else None)
        # the step graphs (one memory pool) and the generator of their draws;
        # a gloo collective cannot be captured: eager steps across processes
        self.graphs = dg.DecodeGraphs(
            self.device, n_ctx, eager=self.mesh is not None
            and self.mesh.process_count > 1)
        self._gen = torch.Generator(device=self.device)
        # abort_callback (llama.h:654): checked before each prefill ubatch,
        # between generate_fast blocks and generate tokens; None = never
        self.abort_callback = None
        self.timings = Timings()
        self.timings.t_load = time.perf_counter() - t0

    def set_abort_callback(self, cb) -> None:
        """cb() -> bool; True aborts at the next compute boundary."""
        self.abort_callback = cb

    def _check_abort(self):
        if self.abort_callback is not None and self.abort_callback():
            raise AbortError("aborted by callback")

    # -- the mesh (tensor / data parallel serving) ---------------------------
    def _validate_mesh(self, n_slots: int):
        """Engine-level mesh constraints, checked before any placement
        (engine.py:219-237 of the JAX package). Its device count check has
        no counterpart: every rank of a process shares its device."""
        tp, dp = self.tp, self.dp
        if self.cfg.arch == "mamba" and tp > 1:
            raise ValueError("recurrent (mamba) models support dp only")
        if tp > 1:
            if self.cfg.n_heads % tp:
                raise ValueError(
                    f"n_heads={self.cfg.n_heads} not divisible by tp={tp}")
            if self.cfg.n_kv_heads % tp:
                raise ValueError(
                    f"n_kv_heads={self.cfg.n_kv_heads} not divisible by "
                    f"tp={tp} (choose tp <= n_kv_heads that divides it)")
        if n_slots % dp:
            raise ValueError(f"n_slots={n_slots} not divisible by dp={dp}")
        world = distributed.world()
        if world is not None:
            pmesh.block_size(dp, tp, world[1])

    def _setup_mesh(self, make_cache):
        """Cut the weights by the shard plan into this process's tp ranks
        and make each local rank's cache (its kv heads, its dp group's
        slots); the per-rank config (cfg_step) travels with the weights.
        Prints the placement once."""
        mesh = pmesh.make_mesh(self.dp, self.tp, self.device)
        plan = pmesh.param_plan(self.params, self.tp)
        self.cfg_step = pmesh.step_config(self.cfg, self.tp, self.params,
                                          plan)
        ranks = pmesh.shard_params(self.params, plan, self.tp, mesh.local_tp,
                                   self.cfg.cdtype)
        self.params = pmesh.ShardedParams(mesh, self.cfg_step, ranks)
        n_per = self.n_slots // self.dp
        kv_heads = self.cfg.n_kv_heads // self.tp
        self.cache = MeshCache({d: [make_cache(n_per, kv_heads)
                                    for _ in mesh.local_tp]
                                for d in mesh.local_dp}, n_per, mesh)
        self.mesh = mesh
        print(mesh.describe(), file=sys.stderr, flush=True)

    def _fuse_projections(self):
        """Fuse the QKV and gate+up QTensors into one launch each (plane
        concat along N), and pad a tile-unfriendly lm head (vocab 32000)
        to a multiple of 1024 (under tp also of tp * 128, so each vocab
        shard tiles); forward() slices the logits back. The JAX conditions
        (engine.py:331-414): QKV not under qk-norm (persimmon normalizes q
        and k apart), gate|up of equal shapes without biases; MoE experts
        stay apart.

        Under tp > 1 the fusion is SHARD-INTERLEAVED: a concat over the
        per-rank slices ([q_0|k_0|v_0|q_1|k_1|v_1|...]), so an even N split
        of the fused planes lands [q_i|k_i|v_i] on rank i and each rank
        splits its piece by its local head counts; every part must split
        evenly over tp and each rank's piece still tile (N % 128)."""
        out_w = self.params.get("output")
        tp = self.tp
        quant = 1024 if tp <= 1 else int(np.lcm(1024, tp * 128))
        if (isinstance(out_w, QTensor) and out_w.layout == "mm"
                and out_w.shape[0] % quant != 0 and out_w.shape[0] >= 4096):
            n_pad = -(-out_w.shape[0] // quant) * quant
            self.params["output"] = out_w.pad_n(n_pad)
            if self.params.get("output_b") is not None:
                b = self.params["output_b"]
                self.params["output_b"] = torch.cat(
                    [b, b.new_zeros(n_pad - b.shape[0])])

        def fusable(ws) -> bool:
            if not (all(isinstance(w, QTensor) and w.layout == "mm"
                        for w in ws) and len({w.qtype for w in ws}) == 1):
                return False
            if tp <= 1:
                return True
            if any(w.shape[0] % tp for w in ws):
                return False
            return sum(w.shape[0] for w in ws) // tp % 128 == 0

        def interleave(parts, cut, cat):
            """cat(parts) at tp = 1; the shard-interleaved cat under tp."""
            if tp <= 1:
                return cat(parts)
            return cat([cut(p, s * p.shape[0] // tp,
                            (s + 1) * p.shape[0] // tp)
                        for s in range(tp) for p in parts])

        def fuse(ws):
            return interleave(ws, lambda w, lo, hi: w.slice_n(lo, hi),
                              QTensor.concat_n)

        for layer in self.params.get("layers", []):
            ws = [layer.get(k) for k in ("wq", "wk", "wv")]
            if fusable(ws) and not self.cfg.qk_norm:
                layer["wqkv_fused"] = fuse(ws)
                bs = [layer.get(b) for b in ("bq", "bk", "bv")]
                if any(b is not None for b in bs):
                    layer["bqkv_fused"] = interleave([
                        b if b is not None else torch.zeros(
                            w.shape[0], dtype=torch.float32,
                            device=self.device)
                        for b, w in zip(bs, ws)],
                        lambda b, lo, hi: b[lo:hi], torch.cat)
                # drop the unfused tensors (they would double the weights)
                for key in ("wq", "wk", "wv", "bq", "bk", "bv"):
                    layer.pop(key, None)
            gu = [layer.get("w_gate"), layer.get("w_up")]
            if (fusable(gu) and gu[0].shape == gu[1].shape
                    and layer.get("b_gate") is None
                    and layer.get("b_up") is None):
                layer["wgateup_fused"] = fuse(gu)
                layer.pop("w_gate", None)
                layer.pop("w_up", None)

    def _build_mega(self):
        """The decode megakernel's operands when the model and cache
        qualify (engine.py:196-203 of the JAX package): not recurrent, a
        bf16 cache, an output head and out_norm, no out_norm bias; else
        None."""
        c, p = self.cache, self.params
        if (self.recurrent or c.ks is not None or c.vs is not None
                or c.k[0].dtype != torch.bfloat16
                or c.v[0].dtype != torch.bfloat16
                or p.get("output") is None or p.get("out_norm") is None
                or p.get("out_norm_b") is not None):
            return None
        return build_mega(p, self.cfg)

    def newline_id(self) -> int:
        """llama_token_nl: the vocab's id for a newline (BPE vocabs don't
        use the SPM byte token 13)."""
        if not hasattr(self, "_nl_id"):
            self._nl_id = 13
            if self.tokenizer is not None:
                ids = self.tokenizer.encode("\n", add_bos=False)
                if ids:
                    self._nl_id = ids[-1]
        return self._nl_id

    def token_pieces(self) -> list[bytes]:
        """Raw piece bytes per token id (cached; grammar sampling input)."""
        if not hasattr(self, "_token_pieces"):
            assert self.tokenizer is not None
            self._token_pieces = [self.tokenizer.token_bytes(t)
                                  for t in range(self.cfg.vocab_size)]
        return self._token_pieces

    # -- low-level ubatch execution ------------------------------------------
    def _model_forward(self):
        """The forward of this engine's family: models.mamba's for a
        recurrent model, else this module's `forward` (looked up at each
        call, so a test can substitute it)."""
        return mamba.forward if self.recurrent else forward

    def _kv_span(self, need: int) -> int | None:
        """Attention-span bucket of a forward: _occupied_span(need), so
        attention reads only span cells. None (the full cache) on a
        megakernel engine, as in the JAX one (engine.py:451): its prefill,
        decode_one and decode_batch then make the JAX kernel choice;
        _mega_step keeps its own span view. None for a recurrent model: it
        has no KV span (engine.py:451)."""
        if self.mega is not None or self.recurrent:
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
        megakernel, recurrent and meshed engines keep the full batch, as
        the JAX ones do (a mesh shards the rows over dp)."""
        if self.mega is not None or self.recurrent or self.mesh is not None:
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
              slot: int, params=None, segs: np.ndarray | None = None,
              embeds: np.ndarray | None = None,
              last: bool = False) -> torch.Tensor:
        """One eager forward over one slot's (1, T) prefill ubatch; returns
        device logits, or hidden states where `params` (default the
        engine's) lack the lm head (decode steps replay graphs: _graph).
        segs: (1, T) packed segment ranges (eval_segmented); embeds: (1, T,
        dim) input embeddings in place of the tokens' (eval_embeds). On a
        mesh the batch covers every slot in order (the rows shard over dp):
        only `slot`'s row is live, the others pad to the trash cell. last:
        the logits of the ubatch's last position only, (1, 1, vocab)."""
        n = tok.shape[1]
        row = 0
        if self.mesh is not None:
            tok, pos, cel, segs, embeds = self._all_slots(
                slot, tok, pos, cel, segs, embeds)
            row, slot = slot, None
        # one host-to-device copy for tokens, positions, cells (and segs)
        rows = [tok, pos, cel] + ([] if segs is None else [segs])
        host = torch.from_numpy(np.stack(rows).astype(np.int64))
        t, p, c, *sg = host.to(self.device)
        kw = {} if embeds is None else {"embeds": torch.from_numpy(
            np.array(embeds, np.float32)).to(self.device)}
        with torch.no_grad():
            logits, self.cache = self._model_forward()(
                self.params if params is None else params, self.cfg, t, p,
                self.cache, slot, c, kv_span=self._kv_span(0),
                t_bucket=self._bucket_for(n) if n > 1 else 1,
                segs=sg[0] if sg else None, last_row=last, **kw)
        return logits[row:row + 1]

    def _all_slots(self, slot: int, tok, pos, cel, segs, embeds):
        """A one-slot (1, T) ubatch as the mesh's all-slots batch (engine.py
        :527-534 and :558-566 of the JAX package): token 0, position -1,
        the trash cell (and segment 0, zero embeddings) in every other
        row."""
        R, n = self.n_slots, tok.shape[1]

        def full(a, fill):
            out = np.full((R,) + np.shape(a)[1:], fill,
                          np.asarray(a).dtype)
            out[slot] = a[0]
            return out
        return (full(tok, 0), full(pos, -1), full(cel, self.n_ctx),
                None if segs is None else full(segs, 0),
                None if embeds is None else full(
                    np.asarray(embeds, np.float32), 0.0))

    def _run_device(self, slot: int, tokens: np.ndarray,
                    positions: np.ndarray, cells: np.ndarray,
                    last: bool = False) -> torch.Tensor:
        """One ubatch for one slot -> (T, vocab) logits on the device ((1,
        vocab) for `last`, the last position's)."""
        logits = self._step(np.asarray(tokens)[None], np.asarray(positions)[None],
                            np.asarray(cells)[None], int(slot), last=last)
        return logits[0]

    def _run(self, slot: int, tokens: np.ndarray, positions: np.ndarray,
             cells: np.ndarray, all_logits: bool = True) -> np.ndarray:
        return self._run_device(slot, tokens, positions, cells,
                                last=not all_logits).cpu().numpy()

    def _cells_for(self, slot: int, n: int, positions: np.ndarray) -> np.ndarray:
        """Allocate n free cells (host mirror of llama_kv_cache_find_slot);
        a recurrent state has none (zeros)."""
        if self.recurrent:
            return np.zeros(n, np.int32)
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
        if self.recurrent:
            self.cache.reset_slot(slot)
        else:
            self.seq_rm(slot)
        self.n_past[slot] = 0
        self.cell_pos[slot] = -1
        self.ga_i[slot] = 0

    def _ubatches(self, slot: int, tokens):
        """The n_ubatch pieces of `tokens` for a slot: (tokens, positions,
        cells) each, its cells allocated; n_past advances past a piece
        once the caller has run it. The abort callback is asked before
        each piece (AbortError)."""
        toks = np.asarray(tokens, np.int32)
        for off in range(0, len(toks), self.n_ubatch):
            self._check_abort()
            chunk = toks[off:off + self.n_ubatch]
            pos = (self.n_past[slot] + np.arange(len(chunk))).astype(np.int32)
            yield chunk, pos, self._cells_for(slot, len(chunk), pos)
            self.n_past[slot] += len(chunk)

    def prefill(self, slot: int, tokens: list[int],
                logits_all: bool = False) -> np.ndarray:
        """Feed prompt tokens; returns logits of the final position (or of
        every position)."""
        t0 = time.perf_counter()
        out = []
        for chunk, pos, cells in self._ubatches(slot, tokens):
            logits = self._run(slot, chunk, pos, cells,
                               all_logits=logits_all)
            out.append(logits if logits_all else logits[-1:])
        self.timings.t_prefill += time.perf_counter() - t0
        self.timings.n_prefill += len(tokens)
        return np.concatenate(out) if logits_all else out[-1][0]

    def embed(self, tokens_or_text, pooling: str | None = None,
              slot: int = 0) -> np.ndarray:
        """Sentence embedding (examples/embedding parity): the forward
        without the lm head over n_ubatch ubatches of the slot (reset
        first), its final-norm hidden states pooled. pooling: mean | cls |
        last | none (the (T, dim) rows); default the model's pooling_type,
        else 'last' for causal models (llama_get_embeddings)."""
        tokens = self._encode(tokens_or_text)
        if pooling is None:
            pooling = ("last" if self.cfg.pooling == "none"
                       else self.cfg.pooling)
        if not self.cfg.causal and len(tokens) > self.n_ubatch:
            # bidirectional attention cannot be chunked: later tokens would
            # be invisible to earlier chunks
            raise ValueError(
                f"non-causal embedding input ({len(tokens)} tokens) exceeds "
                f"n_ubatch={self.n_ubatch}; raise n_ubatch/n_ctx")
        params = (self.params.without(("output", "output_b"))
                  if self.mesh is not None else
                  {k: v for k, v in self.params.items()
                   if k not in ("output", "output_b")})
        self.reset_slot(slot)
        h = np.concatenate([                           # (T, dim)
            self._step(chunk[None], pos[None], cells[None], int(slot),
                       params)[0].cpu().numpy()
            for chunk, pos, cells in self._ubatches(slot, tokens)])
        if pooling == "none":
            return h
        if pooling == "mean":
            return h.mean(axis=0)
        if pooling == "cls":
            return h[0]
        return h[-1]

    def eval_tokens(self, slot: int, tokens: list[int]) -> np.ndarray:
        """Evaluate a token chunk from n_past, returning logits at every
        position ((T, vocab)); the verify of the host speculation loops."""
        t0 = time.perf_counter()
        toks = np.asarray(tokens, np.int32)
        pos = (self.n_past[slot] + np.arange(len(toks))).astype(np.int32)
        cells = self._cells_for(slot, len(toks), pos)
        logits = self._run(slot, toks, pos, cells)
        self.n_past[slot] += len(toks)
        self.timings.t_eval += time.perf_counter() - t0
        self.timings.n_eval += len(toks)
        return logits

    def eval_segmented(self, slot: int, tokens: np.ndarray,
                       positions: np.ndarray,
                       segs: np.ndarray) -> np.ndarray:
        """Evaluate a compound batch with explicit per-token positions and
        packed segment ranges (lo | hi << 16) -> logits at every position
        (engine.py:710-751 of the JAX package): the multi-seq_id batch of
        lookahead decoding. Cells are allocated as for any ubatch; n_past
        does not move. The forward takes the einsum attention with the
        segment mask."""
        assert not self.recurrent, "segmented eval needs attention"
        t = len(tokens)
        positions = np.asarray(positions, np.int32)
        cells = self._cells_for(slot, t, positions)
        logits = self._step(np.asarray(tokens, np.int32)[None],
                            positions[None], cells[None], int(slot),
                            segs=np.asarray(segs, np.int32)[None])
        return logits[0].cpu().numpy()

    def eval_embeds(self, slot: int, embeds: np.ndarray) -> np.ndarray:
        """Feed precomputed input embeddings (T, dim) in place of token ids
        -- the reference's llama_batch.embd path (llama.cpp:8530-8537,
        llava.cpp:llava_eval_image_embed; engine.py:766-812 of the JAX
        package): n_ubatch chunks, each at its exact length with the
        prefill's kernel choice, advancing n_past. Returns the final
        position's logits."""
        assert not self.recurrent, "embedding injection needs attention"
        t0 = time.perf_counter()
        embeds = np.asarray(embeds, np.float32)
        out = None
        for off in range(0, len(embeds), self.n_ubatch):
            chunk = embeds[off:off + self.n_ubatch]
            t = len(chunk)
            pos = (self.n_past[slot] + np.arange(t)).astype(np.int32)
            cells = self._cells_for(slot, t, pos)
            logits = self._step(np.zeros((1, t), np.int32), pos[None],
                                cells[None], int(slot), embeds=chunk[None])
            self.n_past[slot] += t
            out = logits[0, t - 1].cpu().numpy()
        self.timings.t_eval += time.perf_counter() - t0
        self.timings.n_eval += len(embeds)
        return out

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
                body = dg.forward_step(self, self._model_forward(), bufs,
                                       span, slots, sample)
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
        if self.mesh is None:
            logits = self._step_logits(int(slot), [token], [pos], [cell],
                                       [1])[0]
        else:
            # the all-slots step: only `slot`'s row is live
            R = self.n_slots
            tok, p, c, a = (np.zeros(R, np.int32), np.full(R, -1, np.int32),
                            np.full(R, self.n_ctx, np.int32),
                            np.zeros(R, np.int32))
            tok[slot], p[slot], c[slot], a[slot] = token, pos, cell, 1
            logits = self._step_logits(None, tok, p, c, a)[slot]
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
        """The guards of a decode block (contiguous cells but for a
        recurrent state, room for n_steps + 1 more), then (B, tok, pos,
        act) host arrays over the _b_rows bucket."""
        for s in toks:
            n = int(self.n_past[s])
            if not self.recurrent and not np.array_equal(
                    self.cell_pos[s, :n], np.arange(n)):
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
            if not self.recurrent:
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
        canonical for the next block. Refused for a recurrent model, as
        in the JAX engine."""
        if self.recurrent:
            raise ValueError("sampled fast path: non-recurrent engines only")
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
        """Drop KV cells at positions >= n_past. A recurrent state cannot
        be rolled back (NotImplementedError)."""
        if self.recurrent:
            raise NotImplementedError("cannot roll back a recurrent state")
        self.seq_rm(slot, int(n_past))
        self.n_past[slot] = n_past

    def _no_surgery(self):
        if self.recurrent:
            raise NotImplementedError("position surgery on a recurrent "
                                      "(mamba) state; use reset_slot")

    def seq_rm(self, slot: int, p0: int = 0, p1: int = kv.INT32_MAX):
        self._no_surgery()
        kv.seq_rm(self.cache, slot, p0, p1)
        cp = self.cell_pos[slot]
        cp[(cp >= p0) & (cp < p1)] = -1

    def seq_cp(self, src: int, dst: int):
        """Copy a slot's KV cells (or recurrent rows) and host state to
        another slot."""
        if self.recurrent:
            self.cache.copy_slot(src, dst)
        else:
            kv.seq_cp(self.cache, src, dst)
        self.n_past[dst] = self.n_past[src]
        self.cell_pos[dst] = self.cell_pos[src]
        self.ga_i[dst] = self.ga_i[src]

    def move_slot(self, src: int, dst: int):
        """Renumber a slot: move its KV rows and host state to `dst`, clear
        `src`. The server uses it to keep active slot ids a low prefix, so
        the _b_rows compaction bucket stays tight when a high-numbered slot
        outlives its neighbours."""
        if src == dst:
            return
        self.seq_cp(src, dst)
        self.reset_slot(src)

    def seq_add(self, slot: int, p0: int, p1: int, delta: int):
        self._no_surgery()
        kv.seq_add(self.cache, slot, p0, p1, delta, self.cfg.rope)
        cp = self.cell_pos[slot]
        m = (cp >= p0) & (cp < p1)
        cp[m] += delta
        cp[m & (cp < 0)] = -1

    def seq_div(self, slot: int, p0: int, p1: int, d: int):
        self._no_surgery()
        kv.seq_div(self.cache, slot, p0, p1, d, self.cfg.rope)
        cp = self.cell_pos[slot]
        m = (cp >= p0) & (cp < p1)
        cp[m] //= d

    # -- context management (main.cpp:540-598) --------------------------------
    def _maybe_shift(self, slot: int):
        if self.recurrent:               # unbounded context; nothing to shift
            return
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
        order, and the host cell mirror with them (nothing for a recurrent
        state)."""
        if self.recurrent:
            return
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

    # -- speculative serving blocks (engine.py:1343-1517 of the JAX
    # package; the cycles are runtime.speculative's captured graphs) ------
    def _spec_preflight(self, slot: int, k: int) -> int:
        if self.mega is not None or self.recurrent:
            raise ValueError("speculation: plain, non-recurrent engines "
                             "only")
        if self.mesh is not None and self.dp != 1:
            raise ValueError("speculation tiers need dp == 1")
        n = int(self.n_past[slot])
        if not np.array_equal(self.cell_pos[slot, :n], np.arange(n)):
            raise ValueError(f"slot {slot}: cells not contiguous")
        if n + k + 1 > self.n_ctx:
            raise ValueError("speculation block would overflow n_ctx")
        return n

    def spec_lookup_block(self, slot: int, carry: int, hist: list[int],
                          k: int, steps: int, budget: int, eos_id: int):
        """One greedy single-slot prompt-lookup speculation block
        (lookup.cpp fused into serving): up to `steps` cycles of the
        n-gram draft and a (1, 1+k) verify on the device, up to
        steps * (k + 1) tokens. Updates n_past / cell_pos for the emitted
        prefix. Returns (rows, accs, n_steps, pos) as host values."""
        from tpulamm_torch.runtime.speculative import lookup_block
        n = self._spec_preflight(slot, k)
        if len(hist) != n:
            raise ValueError(f"hist has {len(hist)} tokens, slot holds {n}")
        st = lookup_block(self, [slot], [carry], [hist], k, steps,
                          self._kv_span(budget + 2 * k + 2), [budget],
                          [eos_id], [0.0], True, 40, 0)
        return st["rows"][:, 0], st["accs"][:, 0], st["i"], int(st["pos"][0])

    def spec_lookup_block_multi(self, active: dict[int, int],
                                hists: dict[int, list[int]],
                                budgets: dict[int, int],
                                eos_ids: dict[int, int],
                                temps: dict[int, float],
                                seed: int, k: int, steps: int,
                                greedy: bool, top_k: int):
        """Multi-slot lookup-speculation block: every active slot drafts
        from its own history and ONE (B, 1+k) compound forward over the
        first _b_rows slots verifies them all a cycle; a slot freezes on
        EOS, budget or context while the rest go on. greedy=False samples
        each position at its slot's temperature and accepts while the
        sample equals the draft. Returns (rows (steps, B, k+1), accs
        (steps, B), n_steps, posv (B,), emitted (B,))."""
        from tpulamm_torch.runtime.speculative import lookup_block
        for s in active:
            n = self._spec_preflight(s, k)
            if len(hists[s]) != n:
                raise ValueError(
                    f"slot {s}: hist has {len(hists[s])}, holds {n}")
        B = self._b_rows(active) or self.n_slots
        self._assert_b_cover(active, B)
        rows = range(B)
        st = lookup_block(
            self, list(rows), [active.get(r, 0) for r in rows],
            [hists[r] if r in active else [] for r in rows], k, steps,
            self._kv_span(steps * (k + 1) + 2 * k + 2),
            [budgets[r] if r in active else 0 for r in rows],
            [eos_ids[r] if r in active else -1 for r in rows],
            [temps[r] if r in active else 0.0 for r in rows], greedy, top_k,
            seed, multi=True)
        return st["rows"], st["accs"], st["i"], st["pos"], st["emitted"]

    def attach_draft(self, draft) -> None:
        """Attach a draft Engine for spec_draft_block (server
        --model-draft)."""
        if (draft.n_slots != 1 or draft.mega is not None or draft.recurrent
                or draft.mesh is not None):
            raise ValueError("draft engine must be single-slot, unmeshed, "
                             "non-recurrent, without the megakernel")
        self.draft = draft
        self._draft_synced: list[int] | None = None

    def spec_draft_block(self, slot: int, carry: int, hist: list[int],
                         k: int, steps: int, temp: float, top_k: int,
                         seed: int, eos_id: int, budget: int):
        """One draft-MODEL speculation block for serving (speculative.cpp
        fused into the scheduler): the attached draft proposes k tokens a
        cycle, one (1, 1+k) target forward verifies. Greedy (temp <= 0) is
        output-exact; temp > 0 runs true speculative sampling over one
        vocabulary. The draft's KV is synced to the slot's history first
        (a no-op when it continues the previous block). Returns (rows,
        accs, n_steps, pos)."""
        from tpulamm_torch.runtime.speculative import draft_block, spec_mode
        draft = getattr(self, "draft", None)
        if draft is None:
            raise ValueError("no draft engine attached")
        if self.mesh is not None:
            # the draft's cycle runs beside an unsharded target only; a
            # meshed server keeps the lookup tier (engine.py:1468-1471)
            raise ValueError("draft tier: unmeshed target engines only")
        n = self._spec_preflight(slot, k)
        if len(hist) != n:
            raise ValueError(f"hist has {len(hist)} tokens, slot holds {n}")
        if n + k + 1 > draft.n_ctx:
            raise ValueError("draft n_ctx too small for this block")
        if self._draft_synced != hist:
            draft.reset_slot(0)
            if hist:
                draft.prefill(0, hist)
            self._draft_synced = list(hist)
        need = budget + 2 * k + 2
        st = draft_block(self, draft, slot, carry, n, k, steps,
                         self._kv_span(need), draft._kv_span(need),
                         spec_mode(self, draft, temp <= 0.0),
                         temp, top_k, seed, eos_id, budget)
        n_steps, pos = st["i"], int(st["pos"][0])
        if n_steps:
            block = [int(t) for r in st["rows"][:n_steps, 0] for t in r
                     if t >= 0]
            # positions n..pos-1 hold [carry] + block[:-1]
            self._draft_synced = list(hist) + [carry] + block[:-1]
        return st["rows"][:, 0], st["accs"][:, 0], n_steps, pos

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
        (token_ids, text).

        A recurrent state cannot be rolled back, where the JAX engine's
        rollback after an over-running block raises: its blocks run exactly
        the steps still wanted (the same step graph, replayed fewer times),
        and a block whose EOS comes before its last step is run again from
        a copy of the slot's rows taken before it, up to the EOS, so the
        state and n_past hold the returned tokens."""
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
            if self.abort_callback is not None and self.abort_callback():
                break                  # the partial output; the slot is valid
            room = self.n_ctx - int(self.n_past[slot]) - 1
            n = (min(n_predict - len(out), dg.DECODE_BUCKETS[-1], room)
                 if self.recurrent else
                 dg.pick_block(n_predict - len(out), room))
            if n <= 0:
                break                  # context full: no shift, as in JAX
            startb = int(self.n_past[slot])
            rows = (self.cache.save_slot(slot)
                    if self.recurrent and stop_on_eos else None)
            toks = self._slot_block(path, slot, out[-1], startb, n, temp,
                                    top_k, seed + len(out))
            if rows is not None and eos in toks[:-1, 0]:
                # the same seed repeats the block's draws up to the EOS
                n = int(np.flatnonzero(toks[:, 0] == eos)[0]) + 1
                self.cache.restore_slot(slot, rows)
                toks = self._slot_block(path, slot, out[-1], startb, n, temp,
                                        top_k, seed + len(out))
            self.n_past[slot] = startb + n
            self.cell_pos[slot, startb:startb + n] = np.arange(startb,
                                                               startb + n)
            out.extend(int(t) for t in toks[:, 0])
        total_written = int(self.n_past[slot]) - start0
        out = out[:n_predict]
        if stop_on_eos and eos in out:
            out = out[:out.index(eos)]
        target = start0 + min(len(out), total_written)
        if target != int(self.n_past[slot]) and not self.recurrent:
            self.rollback(slot, target)
        self.timings.t_eval += time.perf_counter() - t0
        self.timings.n_eval += len(out)
        text = self.tokenizer.decode(out) if self.tokenizer else ""
        return out, text

    def _slot_block(self, path: str, slot: int, tok: int, pos: int, n: int,
                    temp: float, top_k: int, seed: int) -> np.ndarray:
        """One slot's decode block -> (n, 1) tokens: the one-row block, or
        on a mesh the all-slots block with only `slot` active (the JAX
        engine's mesh path through decode_batch_fast, engine.py:1567-1607;
        the host mirrors are generate_fast's to move)."""
        if self.mesh is None:
            return self._block(path, int(slot), [tok], [pos], [1], n, [temp],
                               top_k, seed)
        R = self.n_slots
        t, p = np.zeros(R, np.int64), np.zeros(R, np.int64)
        a, tv = np.zeros(R, bool), np.zeros(R, np.float32)
        t[slot], p[slot], a[slot], tv[slot] = tok, pos, True, temp
        return self._block("step", None, t, p, a, n, tv, top_k,
                           seed)[:, slot:slot + 1]

    def generate(self, prompt: str | list[int], *, n_predict: int = 128,
                 sampling: SamplingParams | None = None, slot: int = 0,
                 stop_on_eos: bool = True, stream=None,
                 grammar: str | object | None = None,
                 cfg_negative_prompt: str | list[int] | None = None,
                 cfg_scale: float = 1.0,
                 stop_tokens: set[int] | None = None):
        """Generate tokens with the host Sampler, one decode_one step a
        token; returns (token_ids, text). The prompt continues the slot
        from n_past (reset it first for a fresh start).

        grammar: GBNF text (or a prebuilt Grammar) constraining the output
        (llama_sample_grammar semantics).
        cfg_negative_prompt / cfg_scale: classifier-free guidance -- slot +
        1 evaluates the negative context, each step is one decode_batch of
        both slots, and the logits are combined as
        llama_sample_apply_guidance does (main.cpp's CFG path).
        stop_tokens: ids that end generation (not emitted).
        stream: called with each piece of text as it decodes (an
        incremental UTF-8 decoder over the tokens' bytes).
        The abort callback is checked before each token: True returns the
        partial output and leaves the slot valid."""
        tokens = self._encode(prompt)
        sampling = sampling or SamplingParams()
        eos = self._eos()
        gobj, pieces = None, None
        if grammar is not None:
            gobj = (Grammar.from_gbnf(grammar) if isinstance(grammar, str)
                    else grammar)
            assert self.tokenizer is not None, "grammar needs a tokenizer"
            pieces = self.token_pieces()
        sampler = Sampler(sampling, self.cfg.vocab_size, eos_id=eos,
                          nl_id=self.newline_id(), grammar=gobj,
                          token_pieces=pieces)
        for t in tokens:
            sampler.accept(t, apply_grammar=False)

        use_cfg = cfg_negative_prompt is not None and cfg_scale != 1.0
        gslot, g_logits = None, None
        if use_cfg:
            gslot = slot + 1
            assert gslot < self.n_slots, \
                "CFG needs a free slot (start the engine with n_slots>=2)"
            self.reset_slot(gslot)
            g_logits = self.prefill(gslot, self._encode(cfg_negative_prompt))

        logits = self.prefill(slot, tokens)
        out_ids: list[int] = []
        # byte tokens may split a multi-byte character across steps
        sdec = codecs.getincrementaldecoder("utf-8")("replace")
        for _ in range(n_predict):
            if self.abort_callback is not None and self.abort_callback():
                break                  # the partial output; the slot is valid
            t0 = time.perf_counter()
            if use_cfg:
                logits = apply_guidance(logits, g_logits, cfg_scale)
            tok = sampler.sample(logits)
            sampler.accept(tok)
            self.timings.t_sample += time.perf_counter() - t0
            self.timings.n_sample += 1
            if stop_on_eos and tok == eos and not sampling.ignore_eos:
                break
            if stop_tokens and tok in stop_tokens:
                break
            out_ids.append(tok)
            if stream is not None and self.tokenizer is not None:
                piece = sdec.decode(self.tokenizer.token_bytes(tok))
                if piece:
                    stream(piece)
            if use_cfg:
                both = self.decode_batch({slot: tok, gslot: tok})
                logits, g_logits = both[slot], both[gslot]
            else:
                logits = self.decode_one(slot, tok)
        text = self.tokenizer.decode(out_ids) if self.tokenizer else ""
        return out_ids, text
