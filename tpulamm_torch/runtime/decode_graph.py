"""Decode steps as captured CUDA graphs: the port's counterpart of the JAX
engine's compiled decode block (tpulamm.runtime.engine: `_build_decode_scan`
:1033, the `_batch_scan_exec` cache :1237, `_build_decode_scan_mega` :956).

The JAX engine runs a block of decode steps as one `lax.scan` dispatch.
Here one decode step -- the (B, 1) forward or the megakernel step, the
sampler, and the advance of the carried tokens, positions and cells -- is
captured once into a `torch.cuda.CUDAGraph` for each key (path, B,
kv_span, slot, sampler), and a block replays it n_steps times: no Python
runs between the kernels of a step.

- `StepBuffers`: the static device buffers a graph reads and writes. The
  int32 input words (tokens, positions, cells, active flags, temperatures
  as f32 bits, the step index) are filled with one host-to-device copy a
  block; the (1 + RING, B) int64 output ring takes step i's tokens in row
  1 + i, and its row 0 holds the error word; a "logits" graph also leaves
  its (B, V) logits. The (n_steps, B) tokens come back in one
  device-to-host copy.
- `DecodeGraphs.get`: capture. The step first runs once eagerly on a side
  stream with idle inputs (every row inactive: position -1, the trash
  cell), so that what the kernels' wrappers make at first use (counters
  and barrier words, pointer tables, SM counts, the nvcc builds,
  cudaFuncSetAttribute) exists outside the capture and no live cell is
  written; then it is captured. Every graph of an engine allocates from
  one memory pool. The cache and the weights keep their storage: every
  cache update (`kvcache` defrag, seq_*, context shift, self-extend) is in
  place.
- The random draw: the engine's torch.Generator is registered with each
  sampling graph, so every replay draws anew and a reseeded block repeats.
- Launch counts: a replay runs no Python, so each graph records what its
  capture added to the `LAUNCHES` counts, takes it back, and adds it on
  every replay. The warm-up's launches are set-up and are taken back too,
  so the counts are the steps the blocks ran times the kernels of a step.

On the CPU the same step runs eagerly through the same buffers and block
code. On CUDA a capture or replay that fails raises; nothing falls back to
the eager loop. A mesh that spans processes (parallel.distributed) steps
eagerly by design: its gloo collectives cannot be captured; the steps and
tokens are the same.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpulamm_torch.ops import ffn_fused, flash_attention, mega_decode, qmm

DECODE_BUCKETS = (16, 32, 64, 128, 256, 512)
RING = DECODE_BUCKETS[-1]          # steps between two copies back


def _counters() -> tuple[dict, ...]:
    """The launch counts of every kernel a decode step can run."""
    return (qmm.LAUNCHES, flash_attention.LAUNCHES, ffn_fused.LAUNCHES,
            mega_decode.LAUNCHES)


def pick_block(remaining: int, room: int) -> int:
    """Steps of the next block (tpulamm engine.py:1555-1566): the smallest
    bucket >= remaining, or the largest <= remaining where that over-runs
    by more than 32 steps; at most `room` (n_ctx - n_past - 1). <= 0: stop."""
    n = next((b for b in DECODE_BUCKETS if b >= remaining), DECODE_BUCKETS[-1])
    if n - remaining > 32:
        n = max(b for b in DECODE_BUCKETS if b <= remaining)
    return min(n, room)


class StepBuffers:
    """Static device buffers of one step graph over B rows."""

    def __init__(self, B: int, device, vocab: int | None = None):
        self.B = B
        self.inp = torch.zeros(5 * B + 1, dtype=torch.int32, device=device)
        rows = self.inp[:5 * B].view(5, B)
        self.tok, self.pos, self.cell, self.act = rows[0], rows[1], rows[2], \
            rows[3]
        self.temp = rows[4].view(torch.float32)
        self.step = self.inp[5 * B:]
        self.out = torch.zeros((1 + RING, B), dtype=torch.int64, device=device)
        self.err = self.out[0].view(torch.int32)[:1]
        self.logits = (None if vocab is None else
                       torch.zeros((B, vocab), dtype=torch.float32,
                                   device=device))

    def stage(self, tok, pos, cell, act, temp=None) -> None:
        """A block's inputs (host arrays of B) in one host-to-device copy;
        the step index and the error word to 0."""
        B = self.B
        host = np.zeros(5 * B + 1, np.int32)
        for i, a in enumerate((tok, pos, cell, act)):
            host[i * B:(i + 1) * B] = np.asarray(a)
        if temp is not None:
            host[4 * B:5 * B] = np.asarray(temp, np.float32).view(np.int32)
        self.inp.copy_(torch.from_numpy(host))
        self.err.zero_()

    def stage_idle(self, trash: int) -> None:
        """Inputs under which a step writes no live cell: every row
        inactive, at position -1 and the trash cell."""
        self.stage(np.zeros(self.B), np.full(self.B, -1),
                   np.full(self.B, trash), np.zeros(self.B))

    def advance(self, nxt: torch.Tensor | None) -> None:
        """The end of a step: an active row's sampled token into the ring
        at the step index and into the carried tokens (None: a logits
        step, the tokens stay); active rows' positions and cells + 1; the
        step index + 1."""
        if nxt is not None:
            nxt = torch.where(self.act.bool(), nxt.to(torch.int32), self.tok)
            self.out.index_copy_(0, self.step.long() + 1, nxt[None].long())
            self.tok.copy_(nxt)
        self.pos.add_(self.act)
        self.cell.add_(self.act)
        self.step.add_(1)


class StepGraph:
    """One decode step over its buffers: a captured graph on CUDA, the step
    itself on the CPU."""

    def __init__(self, bufs: StepBuffers, body, graph=None, delta=()):
        self.bufs = bufs
        self.body = body
        self.graph = graph
        self.delta = delta

    def replay(self) -> None:
        if self.graph is None:
            self.body()
            return
        self.graph.replay()
        for counts, add in zip(_counters(), self.delta):
            for k, v in add.items():
                counts[k] += v

    def run(self, n_steps: int) -> np.ndarray:
        """n_steps steps from the staged inputs -> (n_steps, B) tokens,
        copied back once per RING steps; raises where a step set the
        error word."""
        chunks = []
        for s0 in range(0, n_steps, RING):
            seg = min(RING, n_steps - s0)
            if s0:
                self.bufs.step.zero_()
            for _ in range(seg):
                self.replay()
            # a copy (on the CPU .cpu() would alias the ring)
            host = self.bufs.out[:1 + seg].to("cpu", copy=True).numpy()
            check_error(host[0].view(np.int32)[0])
            chunks.append(host[1:])
        return np.concatenate(chunks)

    def logits(self) -> np.ndarray:
        """One step from the staged inputs -> (B, V) host logits (the
        logits and the error word in one copy back)."""
        self.replay()
        b = self.bufs
        host = torch.cat([b.logits.reshape(-1),
                          b.err.view(torch.float32)]).cpu().numpy()
        check_error(host[-1:].view(np.int32)[0])
        return host[:-1].reshape(b.logits.shape)


def check_error(word) -> None:
    if int(word):
        raise RuntimeError("decode step: the megakernel's cell was outside "
                           "its span; the step wrote nothing")


class DecodeGraphs:
    """An engine's step graphs, one for each key, in one memory pool."""

    def __init__(self, device: torch.device, trash: int,
                 eager: bool = False):
        """eager: never capture (a multi-process mesh's steps)."""
        self.device = device
        self.trash = trash
        self.eager = eager
        self.graphs: dict = {}
        self.pool = None
        self.capture_s = 0.0

    def get(self, key, make) -> StepGraph:
        """The graph of `key`; make() -> (StepBuffers, body, generator or
        None) builds it at first use."""
        g = self.graphs.get(key)
        if g is None:
            bufs, body, gen = make()
            g = self.graphs[key] = self._capture(bufs, body, gen)
        return g

    def _capture(self, bufs: StepBuffers, body, gen) -> StepGraph:
        if self.device.type != "cuda" or self.eager:
            return StepGraph(bufs, body)
        t0 = time.perf_counter()
        before = [dict(c) for c in _counters()]
        bufs.stage_idle(self.trash)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.no_grad(), torch.cuda.stream(side):
            body()                                # warm-up, eagerly
        main.wait_stream(side)
        warm = [dict(c) for c in _counters()]
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        with torch.no_grad(), torch.cuda.graph(graph, pool=self.pool):
            body()
        # the counts keep the blocks' steps: the capture's launches become
        # each replay's, and the warm-up (set-up) is not counted
        delta = []
        for counts, was, w in zip(_counters(), before, warm):
            delta.append({k: counts[k] - w[k] for k in counts
                          if counts[k] != w[k]})
            counts.update(was)
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        return StepGraph(bufs, body, graph, tuple(delta))

    def pool_bytes(self) -> int:
        """Device memory reserved by the graphs' pool (CUDA), else 0."""
        if self.pool is None:
            return 0
        snap = torch.cuda.memory_snapshot()
        return sum(s["total_size"] for s in snap
                   if tuple(s.get("segment_pool_id", ())) == tuple(self.pool))


# -- the steps ------------------------------------------------------------

def greedy(lg: torch.Tensor) -> torch.Tensor:
    return torch.argmax(lg, dim=-1)


def top_k_sampler(bufs: StepBuffers, top_k: int, gen: torch.Generator):
    """Top-k (0 = the full vocab) at each row's temperature, one Gumbel-max
    draw a row from `gen` (ops.device_sampling.gumbel_argmax: the draw of
    softmax(top-k / temp) with no host sync); rows at temp <= 0 take the
    argmax."""
    from tpulamm_torch.ops.device_sampling import gumbel_argmax

    def sample(lg):
        vals, idx = ((lg, None) if top_k <= 0
                     else torch.topk(lg, min(top_k, lg.shape[-1])))
        j = gumbel_argmax(vals / torch.clamp(bufs.temp, min=1e-6)[:, None],
                          gen)
        pick = j if idx is None else idx.gather(-1, j[:, None])[:, 0]
        return torch.where(bufs.temp > 0.0, pick, torch.argmax(lg, dim=-1))
    return sample


def _finish(bufs: StepBuffers, lg: torch.Tensor, sample) -> None:
    """Sample (or keep the logits: sample None) and advance."""
    if sample is None:
        bufs.logits.copy_(lg)
        bufs.advance(None)
    else:
        bufs.advance(sample(lg))


def forward_step(eng, forward, bufs: StepBuffers, span, slots, sample):
    """The step of `_build_decode_scan` / `_batch_scan_body`: the (B, 1)
    forward over the engine's cache (slots: an int slot for B = 1, or None
    for the first B slots), inactive rows at position -1 and the trash
    cell, then the sampler. `forward` is passed in (the engine passes its
    module's name, so a test can substitute it)."""
    cfg, params, cache, trash = eng.cfg, eng.params, eng.cache, eng.n_ctx

    def body():
        act = bufs.act.bool()
        p = torch.where(act, bufs.pos, -1)[:, None]
        c = torch.where(act, bufs.cell, trash)[:, None]
        logits, _ = forward(params, cfg, bufs.tok[:, None], p, cache, slots,
                            c, kv_span=span, t_bucket=1)
        _finish(bufs, logits[:, 0], sample)
    return body


def mega_step(eng, mega_fn, bufs: StepBuffers, span: int, slot: int, sample):
    """The step of `_build_decode_scan_mega` for one slot (B = 1): embed,
    the rope lane vectors, the megakernel over the slot's span view (it
    reads the position and cell words and writes the K / V rows at the
    cell), out_norm, the lm head, the cell's position, then the sampler.
    `mega_fn`: mega_decode_layers, passed in as `forward` is."""
    from tpulamm_torch.models.transformer import _proj, embed
    from tpulamm_torch.ops.layers import rms_norm
    from tpulamm_torch.ops.mega_decode import rope_lane_vectors
    cfg, params, cache, mega = eng.cfg, eng.params, eng.cache, eng.mega
    rows = slice(slot, slot + 1)
    kpos = cache.pos[rows, :span]
    kc = [k[rows, :, :span] for k in cache.k]
    vc = [v[rows, :, :span] for v in cache.v]

    def body():
        h = embed(params, cfg, bufs.tok.view(1, 1))
        if cfg.emb_scale != 1.0:
            h = (h.to(torch.float32) * cfg.emb_scale).to(cfg.cdtype)
        lanes = rope_lane_vectors(mega.rope, cfg.head_dim, cfg.n_heads,
                                  cfg.n_kv_heads, bufs.pos)
        x_out, _, _ = mega_fn(mega, h[:, 0].to(torch.float32), bufs.pos,
                              bufs.cell, kpos, kc, vc, *lanes, bufs.err)
        hh = rms_norm(x_out.to(cfg.cdtype), params["out_norm"], cfg.norm_eps)
        if cfg.logit_scale != 1.0:
            hh = (hh.to(torch.float32) * cfg.logit_scale).to(cfg.cdtype)
        logits = _proj(hh, params["output"], cfg, params.get("output_b"))
        # the cell's position, which the kernel read as empty
        cache.pos[slot].index_copy_(
            0, bufs.cell.long(), torch.where(bufs.act.bool(), bufs.pos, -1))
        _finish(bufs, logits[:, :cfg.vocab_size].to(torch.float32), sample)
    return body
