"""Generic transformer forward for every attention architecture of
models.config (counterpart of tpulamm.models.transformer; mamba's
recurrent blocks are models/mamba.py, which the engine picks for it).

One feature-flagged forward, as in the JAX package, with the axes of the
reference's per-arch graph functions (build_*, llama.cpp:5708-8308):

- pre-norm (llama & co) / post-norm (bert) / parallel residual (falcon,
  phi2, plamo, gptj, gptneox; falcon-40B's second attention norm and
  gptneox's own FFN norm)
- RMSNorm or LayerNorm with optional biases; optional per-head q/k
  LayerNorm (persimmon); fused-QKV clamping (mpt)
- RoPE norm / neox / none with partial n_rot; ALiBi added to the scores
  by key position (ggml's slopes); causal or non-causal (bert) masks
- FFN: gated (silu / gelu) or plain (gelu, relu, relu²) with optional
  biases and mpt's act scales; MoE top-k mixing, computed densely over
  all experts as the JAX package does (transformer.py:415-450)
- learned positions, token-type embedding and embedding norm; embedding,
  residual and logit scales (gemma, minicpm)

Every projection of a quantized weight goes through qmatmul (ops.qmm's
kernels on CUDA); the MoE router (E rows, which do not tile) stays dense.
The forward makes no host sync and no host-to-device copy, so a decode
step of it can be captured in a CUDA graph (runtime.decode_graph).

Attention: the JAX forward picks its flash kernels on the TPU by the
predicates at transformer.py:169-187 and :249-259. The same predicates
decide here (`flash_choice`) with "on CUDA" in place of "on TPU", on the
ubatch length the JAX engine would pad to (its bucket); where they pick a
kernel, ops.flash_attention runs it at the exact length, masking by qlen
(ALiBi keeps the einsum path, as in the JAX package). Elsewhere the
einsum path runs, with the q8_0 scale folds in the JAX order. A forward
given packed segment ranges (`segs`: lookahead, tree speculation,
eval_segmented) takes the einsum path with the segment mask
(transformer.py:183, :256, :340-351): a key cell of segment 0 is visible
to every query, any other only to a query whose id lo falls in the key's
[lo, hi].
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.ops.ffn_fused import ffn_fused, ffn_fused_eligible
from tpulamm_torch.ops.flash_attention import flash_attention, flash_decode
from tpulamm_torch.ops.layers import (act, alibi_slopes, layer_norm,
                                      masked_softmax, rms_norm)
from tpulamm_torch.ops.qmatmul import dense_matmul, qmatmul
from tpulamm_torch.ops.qtensor import QTensor, gather_dequant_rows
from tpulamm_torch.ops.rope import apply_rope, rope_angles
from tpulamm_torch.parallel.mesh import ShardedParams, TPGroup, run_forward
from tpulamm_torch.runtime.kvcache import KVCache, write_kv

Params = dict[str, Any]


def unsupported_features(cfg: ModelConfig) -> list[str]:
    """Structural features of cfg the port does not run: none since mamba
    (models/mamba.py) came; the loader asks before it reads a tensor."""
    return []


def _proj(x: torch.Tensor, w, cfg: ModelConfig, bias=None) -> torch.Tensor:
    if isinstance(w, QTensor):
        y = qmatmul(x, w, compute_dtype=cfg.cdtype, inkq=cfg.int8_inkq)
    else:
        y = dense_matmul(x, w)
    if bias is not None:
        y = (y + bias.to(torch.float32)).to(y.dtype)
    return y


def _proj_parts(xs: list, ws: list, cfg: ModelConfig, mode: str,
                g: TPGroup) -> list:
    """Each tp rank's product of a row-parallel projection, before its
    reduction: x_r @ w_r. mode "gather" (the weight replicated while the
    activation is feature-local) first concatenates the ranks'
    activations, and every rank multiplies the whole of it, as each JAX
    shard does."""
    if mode == "gather":
        xs = [g.gather(xs)] * len(ws)
    return [_proj(x, w, cfg) for x, w in zip(xs, ws)]


def _proj_row(xs: list, ws: list, cfg: ModelConfig, bias, mode: str,
              g: TPGroup) -> torch.Tensor:
    """Row-parallel projection (input features sharded on tp;
    transformer.py:57-76 of the JAX package): "psum" sums the ranks'
    partial products over their K-slices, in rank order in f32; "gather"
    and "none" take rank 0's product (every rank's is the same). The
    (replicated) bias is added once, after the reduction; with one rank
    and mode "none" this is _proj."""
    ys = _proj_parts(xs, ws, cfg, mode, g)
    y = g.psum(ys) if mode == "psum" else ys[0]
    if bias is not None:
        y = (y + bias.to(torch.float32)).to(y.dtype)
    return y


def _norm(x: torch.Tensor, p: Params, name: str,
          cfg: ModelConfig) -> torch.Tensor:
    """llm_build_norm (llama.cpp:5178): RMS or LN with optional bias."""
    if cfg.norm_type == "rms":
        return rms_norm(x, p[name], cfg.norm_eps)
    return layer_norm(x, p[name], p.get(name + "_b"), cfg.norm_eps)


def embed(params: Params, cfg: ModelConfig,
          tokens: torch.Tensor) -> torch.Tensor:
    emb = params["tok_emb"]
    if isinstance(emb, QTensor):
        return gather_dequant_rows(emb, tokens.to(torch.long), dtype=cfg.cdtype)
    return emb[tokens.to(torch.long)].to(cfg.cdtype)


def flash_choice(cfg: ModelConfig, T: int, span: int, on_cuda: bool
                 ) -> str | None:
    """Which flash kernel the JAX dispatch would run for a (T, span)
    attention call on the accelerator, or None for the einsum path
    (transformer.py:169-187 decode predicate, :249-259 general one)."""
    group = cfg.n_heads // cfg.n_kv_heads
    hd_ok = cfg.max_alibi_bias == 0.0 and cfg.head_dim in (64, 128, 256)
    small_q = T * group < 64
    fd_auto = on_cuda and small_q and (
        span >= 8192 or (span >= 6144 and T * group >= 8))
    force = cfg.flash_attn
    fd_on = small_q and hd_ok and (force if force is not None else fd_auto)
    auto = fd_on or (on_cuda and ((T >= 64 and span >= 1024)
                                  or (span >= 6144 and T * group >= 8)))
    if not (hd_ok and (force if force is not None else auto)):
        return None
    return "flash_decode" if (fd_on or small_q) else "flash_attention"


def attention(layer: Params, cfg: ModelConfig, h: torch.Tensor,
              positions: torch.Tensor, cache: KVCache, layer_idx: int,
              slots: int | torch.Tensor | None, cells: torch.Tensor,
              kv_span: int | None = None, angles: tuple | None = None,
              t_bucket: int | None = None,
              segs: torch.Tensor | None = None) -> tuple:
    """angles: rope_angles(cfg.rope, positions), shared by every layer;
    t_bucket: the padded ubatch length the kernel choice is made on
    (None = T); segs: (B, T) packed segment ranges of the queries (None:
    the main sequence, no segment mask)."""
    out = _attention([layer], cfg, h, positions, TPGroup.single(None, cache),
                     layer_idx, slots, cells, kv_span, angles, t_bucket, segs)
    return out, cache


def _attention(layers: list, cfg: ModelConfig, h, positions, g: TPGroup,
               layer_idx: int, slots, cells, kv_span, angles, t_bucket,
               segs) -> torch.Tensor:
    """Every tp rank's attention over its heads and cache, then the output
    projection completed across the ranks (cfg.row_attn)."""
    outs = [_attend(lyr, cfg, h, positions, c, layer_idx, slots, cells,
                    kv_span, angles, t_bucket, segs, r)
            for lyr, c, r in zip(layers, g.caches, g.index)]
    return _proj_row(outs, [lyr["wo"] for lyr in layers], cfg,
                     layers[0].get("bo"), cfg.row_attn, g)


def _attend(layer: Params, cfg: ModelConfig, h: torch.Tensor,
            positions: torch.Tensor, cache: KVCache, layer_idx: int,
            slots, cells, kv_span, angles, t_bucket, segs,
            rank: int) -> torch.Tensor:
    """One rank's attention before the output projection: its q / k / v
    heads (cfg's local counts), its cache, -> (B, T, n_heads * hd)."""
    B, T, _ = h.shape
    hd = cfg.head_dim
    if layer.get("wqkv_fused") is not None:
        qkv = _proj(h, layer["wqkv_fused"], cfg, layer.get("bqkv_fused"))
        nq = cfg.n_heads * hd
        nkv = cfg.n_kv_heads * hd
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        q = _proj(h, layer["wq"], cfg, layer.get("bq"))
        k = _proj(h, layer["wk"], cfg, layer.get("bk"))
        v = _proj(h, layer["wv"], cfg, layer.get("bv"))
    if cfg.clamp_kqv > 0.0:
        c = cfg.clamp_kqv
        q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        # per-head LayerNorm over head_dim (build_persimmon, llama.cpp:6240)
        q = layer_norm(q, layer["attn_q_norm"], layer.get("attn_q_norm_b"),
                       cfg.norm_eps)
        k = layer_norm(k, layer["attn_k_norm"], layer.get("attn_k_norm_b"),
                       cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope, angles)
    k = apply_rope(k, positions, cfg.rope, angles)

    S_full = cache.k[layer_idx].shape[2]
    span = kv_span if kv_span is not None and kv_span < S_full else S_full
    # segment ranges only the einsum path masks (transformer.py:183, :256)
    kernel = (None if segs is not None else
              flash_choice(cfg, T if t_bucket is None else t_bucket, span,
                           h.device.type == "cuda"))

    # always an in-place write, whichever path reads the cache below
    write_kv(cache, layer_idx, k, v, slots, cells, positions, segs)

    def rows(arr):
        """This batch's cache rows: slots=None covers the FIRST B rows in
        order and an int slot its one row (views); a tensor of slot ids
        gathers (a copy)."""
        if slots is None:
            return arr if arr.shape[0] == B else arr[:B]
        if isinstance(slots, int):
            return arr[slots:slots + 1]
        return arr[slots.to(torch.long)]

    # span views of the cache: never copied for the kernels (they take
    # strides); the einsum reads them as f32
    kc = rows(cache.k[layer_idx])[:, :, :span]
    vc = rows(cache.v[layer_idx])[:, :, :span]
    kpos = rows(cache.pos)[:, :span]
    ksc = (rows(cache.ks[layer_idx])[:, :, :span] if cache.ks is not None
           else None)
    vsc = (rows(cache.vs[layer_idx])[:, :, :span] if cache.vs is not None
           else None)
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, T, cfg.n_kv_heads, group, hd)

    if kernel is not None:
        qf = qg.permute(0, 2, 1, 3, 4).reshape(B, cfg.n_kv_heads, T * group,
                                               hd)
        # device tensors: no host round trip per layer
        qbase = positions[:, 0].to(torch.int32)
        qlen = (positions >= 0).sum(1).to(torch.int32)
        fn = flash_decode if kernel == "flash_decode" else flash_attention
        o = fn(qf, kc, vc, kpos, qbase, qlen, ksc, vsc,
               scale=float(1.0 / math.sqrt(hd)), g=group, causal=cfg.causal)
        o = o.reshape(B, cfg.n_kv_heads, T, group, hd).permute(0, 2, 1, 3, 4)
        return o.reshape(B, T, cfg.n_heads * hd).to(cfg.cdtype)

    # scores (B, Hkv, G, T, S) in f32, as the JAX path computes off the TPU
    torch.backends.cuda.matmul.allow_tf32 = False
    scores = torch.einsum("bthgd,bhsd->bhgts", qg.to(torch.float32),
                          kc.to(torch.float32))
    if ksc is not None:
        # q8_0 K: (q . k_i8) * ks == q . k_dequant, folded before the scale
        scores = scores * ksc[:, :, None, None, :]
    # 1/sqrt(hd) rounded to f32 as JAX computes it; a Python scalar holding
    # that f32 value multiplies on the device without a host copy
    scores = scores * float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    if cfg.max_alibi_bias > 0.0:
        # ggml_soft_max_ext ALiBi: scores += slope[h] * key position. The
        # slopes depend on the GLOBAL head index: under tp, this rank's
        # contiguous block of the global table (transformer.py:320-330)
        slopes = alibi_slopes(cfg.n_heads * cfg.tp, cfg.max_alibi_bias,
                              h.device)[rank * cfg.n_heads:
                                        (rank + 1) * cfg.n_heads]
        scores = scores + (slopes.reshape(1, cfg.n_kv_heads, group, 1, 1)
                           * kpos[:, None, None, None, :].to(torch.float32))
    # KQ_mask (llama_set_inputs, llama.cpp:8523): key cell live; causal
    # archs also require key pos <= query pos
    live = kpos[:, None, :] >= 0
    if cfg.causal:
        mask = live & (kpos[:, None, :] <= positions[:, :, None])
    else:
        mask = live.expand(B, T, kpos.shape[-1])
    if segs is not None:
        # segment visibility (transformer.py:340-351): key seg 0 is the
        # main sequence; else the query id must lie in the key's [lo, hi]
        kseg = rows(cache.seg)[:, :span]
        klo = (kseg & 0xFFFF)[:, None, :]
        khi = (kseg >> 16)[:, None, :]
        qid = (segs & 0xFFFF)[:, :, None]
        mask = mask & ((klo == 0) | ((klo <= qid) & (qid <= khi)))
    probs = masked_softmax(scores, mask[:, None, None, :, :])
    if vsc is not None:
        # q8_0 V: the row scale folds into probs (s is the contracted axis)
        probs = probs * vsc[:, :, None, None, :]
    out = torch.einsum("bhgts,bhsd->bthgd", probs, vc.to(torch.float32))
    return out.reshape(B, T, cfg.n_heads * hd).to(cfg.cdtype)


def ffn(layer: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """llm_build_ffn (llama.cpp:5203) of one rank's weights."""
    return _ffn([layer], cfg, h, TPGroup.single(layer, None))


def _ffn(layers: list, cfg: ModelConfig, h: torch.Tensor,
         g: TPGroup) -> torch.Tensor:
    """llm_build_ffn (llama.cpp:5203) over the tp ranks: gated (PAR) when
    ffn_gate exists, else act(up) (SEQ, with mpt's act scales); each rank
    its N-slice of gate / up, the down projection completed across the
    ranks (cfg.row_ffn). With cfg.fused_ffn, a decode-size gated silu /
    gelu batch on CUDA runs the one-launch FFN kernel on each rank's
    gate|up and down shards, as the JAX forward does on the TPU with
    TPULAMM_FUSED_FFN (transformer.py:377-394), its partial outputs summed
    over the ranks; a replicated w_down under a sharded gate|up ("gather")
    needs the gathered activation between the two products and keeps the
    unfused path. On the CPU the flag changes nothing."""
    l0 = layers[0]
    if l0.get("wgateup_fused") is not None:
        B, T, dim = h.shape
        if (cfg.fused_ffn and h.device.type == "cuda"
                and cfg.row_ffn in ("none", "psum")
                and all(isinstance(lyr["w_down"], QTensor) for lyr in layers)
                and ffn_fused_eligible(l0["wgateup_fused"], l0["w_down"],
                                       B * T)
                and cfg.ffn_act in ("silu", "gelu")):
            ys = [ffn_fused(h.reshape(B * T, dim), lyr["wgateup_fused"],
                            lyr["w_down"], act=cfg.ffn_act) for lyr in layers]
            y = g.psum(ys) if cfg.row_ffn == "psum" else ys[0]
            if l0.get("b_down") is not None:
                y = y + l0["b_down"].to(torch.float32)
            return y.reshape(B, T, dim)
    mids = [_ffn_mid(lyr, cfg, h) for lyr in layers]
    return _proj_row(mids, [lyr["w_down"] for lyr in layers], cfg,
                     l0.get("b_down"), cfg.row_ffn, g)


def _ffn_mid(lyr: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """One rank's FFN activation, the input of its down projection."""
    if lyr.get("wgateup_fused") is not None:
        gu = _proj(h, lyr["wgateup_fused"], cfg)
        half = gu.shape[-1] // 2
        mid = (act(gu[..., :half].to(torch.float32), cfg.ffn_act)
               * gu[..., half:].to(torch.float32))
        return mid.to(cfg.cdtype)
    up = _proj(h, lyr["w_up"], cfg, lyr.get("b_up"))
    if lyr.get("w_gate") is not None:
        gate = _proj(h, lyr["w_gate"], cfg, lyr.get("b_gate"))
        mid = act(gate.to(torch.float32), cfg.ffn_act) * up.to(torch.float32)
    else:
        mid = act(up.to(torch.float32), cfg.ffn_act)
        if lyr.get("ffn_act_scales") is not None:  # mpt (llm_build_ffn :5260)
            mid = mid / lyr["ffn_act_scales"].to(torch.float32)
    return mid.to(cfg.cdtype)


def moe_ffn(layer: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The MoE branch of build_llama of one rank's weights."""
    return _moe_ffn([layer], cfg, h, TPGroup.single(layer, None))


def _moe_ffn(layers: list, cfg: ModelConfig, h: torch.Tensor,
             g: TPGroup) -> torch.Tensor:
    """The MoE branch of build_llama (llama.cpp:5797-5858) as the JAX
    package computes it (transformer.py:415-450): softmax over the router,
    the top n_expert_used renormalized, then every expert computed densely
    and mixed with its (mostly zero) routing weight, in expert order. Under
    tp each rank mixes its partial expert outputs and ONE sum over the
    ranks completes all of them (row_moe "psum": the sum is linear and the
    routing weights are the same on every rank); "gather" gathers each
    expert's activation for its replicated down weight."""
    l0 = layers[0]
    router = _proj(h, l0["ffn_gate_inp"], cfg)             # (B, T, E)
    probs = torch.exp(router - router.amax(-1, keepdim=True)).to(
        torch.float32)
    probs = probs / probs.sum(-1, keepdim=True)
    topv, topi = torch.topk(probs, cfg.n_expert_used, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)               # renormalize
    weights = torch.zeros_like(probs).scatter_(-1, topi, topv)
    outs = [None] * len(layers)
    for e in range(cfg.n_expert):
        mids = []
        for lyr in layers:
            gate = _proj(h, lyr["ffn_gate_exp"][e], cfg)
            up = _proj(h, lyr["ffn_up_exp"][e], cfg)
            mids.append((act(gate.to(torch.float32), cfg.ffn_act)
                         * up.to(torch.float32)).to(cfg.cdtype))
        mode = "gather" if cfg.row_moe == "gather" else "none"
        exs = _proj_parts(mids, [lyr["ffn_down_exp"][e] for lyr in layers],
                          cfg, mode, g)
        for i, ex in enumerate(exs):
            ex = ex.to(torch.float32) * weights[..., e:e + 1]
            outs[i] = ex if outs[i] is None else outs[i] + ex
    out = g.psum(outs) if cfg.row_moe == "psum" else outs[0]
    return out.to(cfg.cdtype)


def _layer_ffn(layers: list, cfg: ModelConfig, h: torch.Tensor,
               g: TPGroup) -> torch.Tensor:
    if layers[0].get("ffn_gate_inp") is not None and cfg.n_expert > 0:
        return _moe_ffn(layers, cfg, h, g)
    return _ffn(layers, cfg, h, g)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            slots: int | torch.Tensor | None, cells: torch.Tensor,
            kv_span: int | None = None, t_bucket: int | None = None,
            segs: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, KVCache]:
    """tokens/positions/cells: (B, T); slots: (B,) slot ids, the slot of a
    one-row batch as an int, or None for the first B slots; t_bucket: the
    length the JAX engine pads this ubatch to, on which the attention
    kernel is chosen (None = T); segs: (B, T) packed segment ranges
    (lo | hi << 16) of the tokens, written to the cache's segment plane
    and masking attention (None: all 0, the main sequence) -> (logits (B, T, vocab) f32, cache updated
    in place); without params["output"] (embedding models such as bert)
    the final hidden states (B, T, dim) f32 take the logits' place.
    embeds (B, T, dim), when given, replaces the token-embedding lookup:
    the reference's llama_batch.embd input (llama.cpp:8530-8537), through
    which llava splices projected image embeddings into the stream.

    params may be a mesh's ShardedParams (with cache its MeshCache): each
    dp group's rows then run through every local tp rank's weights and
    cache (parallel.mesh.run_forward), with the per-rank config it holds
    in place of cfg."""
    kw = dict(kv_span=kv_span, t_bucket=t_bucket, segs=segs, embeds=embeds)
    if isinstance(params, ShardedParams):
        return run_forward(_forward, params, tokens, positions, cache, slots,
                           cells, **kw)
    return _forward(TPGroup.single(params, cache), cfg, tokens, positions,
                    slots, cells, **kw), cache


def _forward(g: TPGroup, cfg: ModelConfig, tokens, positions, slots, cells,
             kv_span=None, t_bucket=None, segs=None, embeds=None
             ) -> torch.Tensor:
    """The forward of one tp group's ranks (g) -> logits (or the final
    hidden states). Replicated work (embeddings, norms, residuals) runs
    once; each layer's attention and FFN run every rank and complete
    their collectives; a vocab-sharded head is gathered back in vocab
    order before the tile padding is cut (transformer.py:531-538)."""
    params = g.params[0]
    h = (embeds.to(cfg.cdtype) if embeds is not None
         else embed(params, cfg, tokens))
    angles = (rope_angles(cfg.rope, positions) if cfg.rope.kind != "none"
              else None)
    if cfg.emb_scale != 1.0:
        h = (h.to(torch.float32) * cfg.emb_scale).to(cfg.cdtype)
    if cfg.pos_emb:
        # pad rows carry position -1: clamped (masked downstream); past
        # the table, the last row, as the JAX gather clamps
        p = torch.clamp(positions, min=0,
                        max=params["pos_emb"].shape[0] - 1).to(torch.long)
        h = h + params["pos_emb"][p].to(cfg.cdtype)
    if params.get("type_emb") is not None:
        # token type 0, "sentence A" (build_bert :6475)
        h = h + params["type_emb"][0].to(cfg.cdtype)
    if cfg.tok_norm:
        h = _norm(h, params, "tok_norm", cfg)

    def attn(layers, il, x):
        return _attention(layers, cfg, x, positions, g, il, slots, cells,
                          kv_span, angles, t_bucket, segs)

    for il, layer in enumerate(params["layers"]):
        lys = [p["layers"][il] for p in g.params]
        if cfg.post_norm:
            # bert: x -> attn -> +res -> LN -> ffn -> +res -> LN
            h = _norm((h + attn(lys, il, h)).to(cfg.cdtype), layer,
                      "attn_out_norm", cfg)
            h = _norm((h + _layer_ffn(lys, cfg, h, g)).to(cfg.cdtype),
                      layer, "layer_out_norm", cfg)
        elif cfg.parallel_residual:
            hn = _norm(h, layer, "attn_norm", cfg)
            # falcon-40B feeds attention from a second norm (build_falcon
            # :6055); gptneox feeds the FFN from its own norm of the same
            # input; falcon / phi2 / plamo / gptj share the attention norm
            ha = (_norm(h, layer, "attn_norm_2", cfg)
                  if layer.get("attn_norm_2") is not None else hn)
            attn_out = attn(lys, il, ha)
            hf = (_norm(h, layer, "ffn_norm", cfg)
                  if layer.get("ffn_norm") is not None else hn)
            h = (h + attn_out + _layer_ffn(lys, cfg, hf, g)).to(cfg.cdtype)
        else:
            attn_out = attn(lys, il, _norm(h, layer, "attn_norm", cfg))
            if cfg.res_scale != 1.0:
                attn_out = attn_out * cfg.res_scale
            h = (h + attn_out).to(cfg.cdtype)
            ffn_out = _layer_ffn(lys, cfg, _norm(h, layer, "ffn_norm", cfg),
                                 g)
            if cfg.res_scale != 1.0:
                ffn_out = ffn_out * cfg.res_scale
            h = (h + ffn_out).to(cfg.cdtype)
    if params.get("out_norm") is not None:
        h = _norm(h, params, "out_norm", cfg)
    if params.get("output") is None:
        return h.to(torch.float32)                   # embedding model
    if cfg.logit_scale != 1.0:
        h = (h.to(torch.float32) * cfg.logit_scale).to(cfg.cdtype)
    heads = [_proj(h, p["output"], cfg, p.get("output_b")) for p in g.params]
    # a vocab-sharded head: the contiguous shards concatenate back in
    # vocab order (the tile padding sits in the last shard)
    logits = g.gather(heads) if cfg.head_sharded else heads[0]
    if logits.shape[-1] != cfg.vocab_size:
        # the lm head was tile-padded; padded columns are exact zeros
        logits = logits[..., : cfg.vocab_size]
    return logits.to(torch.float32)
