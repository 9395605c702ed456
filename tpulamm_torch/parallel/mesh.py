"""The (dp, tp) mesh and its sharding policy (counterpart of
tpulamm.parallel.mesh).

Policy (megatron-style for the transformer block), the JAX package's rule
table as it is:
- attn q/k/v and ffn gate/up projections: output features (N) sharded on
  tp (contiguous N-shards are head-aligned: n_heads % tp is required)
- attn output and ffn down projections: input features (K) sharded on tp;
  the contraction completes with a sum over tp
- KV cache: kv heads sharded on tp, slots (batch) on dp; a recurrent
  (mamba) state: slots on dp only
- embeddings / norms / routers: replicated; lm head: vocab sharded on tp
- biases of N-sharded weights: sharded on tp; of K-sharded: replicated
  (added once, after the sum)
- MoE experts: the same col / row rules per expert; one sum after the mix

Where the JAX package builds PartitionSpec trees for device_put and
shard_map, this module writes a SHARD PLAN: for each weight the axis it
splits on ("N", "K" or None), mirroring the params tree. shard_params cuts
the global tensors into contiguous per-rank tensors by that plan; the
forward (models.transformer) runs every rank's products one after another
on the device's stream and completes the collectives as tensor ops (a sum
of the partials in rank order in f32, a concatenation for the gathers), so
a decode step stays one capturable CUDA graph.

All the ranks of one process live on that process's one device (the
engine's `device`). A mesh spans processes through parallel.distributed:
each process owns a contiguous block of ranks, and a collective whose tp
group crosses processes is finished over torch.distributed (gloo).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from tpulamm_torch.ops.qtensor import QTensor, dequant_mm

N, K = "N", "K"

# per-layer weight name -> orientation. COL = output features (N) on tp,
# ROW = input features (K) on tp (the matmul result is a tp-sum).
# wqkv_fused / wgateup_fused are SHARD-INTERLEAVED under tp (the engine's
# _fuse_projections): an even N-split lands [q_i|k_i|v_i] / [gate_i|up_i]
# on rank i, so they plan as plain col weights.
_COL_W = ("wq", "w_gate", "w_up", "wqkv_fused", "wgateup_fused")
_KV_W = ("wk", "wv")
_ROW_W = ("wo", "w_down")
_COL_B = ("bq", "b_gate", "b_up", "ffn_act_scales", "bqkv_fused")
_KV_B = ("bk", "bv")
# Everything else in a layer (norms, qk-norm planes, router, ssm_* mamba
# tensors) is replicated.


def _n_ok(w, tp: int) -> bool:
    """Divisibility is the only constraint: a shard too small for the
    kernels' tiles is stored dense at placement (shard_params) and takes
    the dequantize-then-dot path."""
    return w.shape[0] % tp == 0


def _mm_or_dense(w) -> bool:
    return not isinstance(w, QTensor) or w.layout == "mm"


def param_plan(params: dict, tp: int) -> dict:
    """The shard plan mirroring `params` for ANY architecture's tree: "N",
    "K" or None for each weight, lists for the layers and the expert lists.
    Covers separate QKV, biases, qk-norm, MoE expert lists, the extra norms
    of post-norm / parallel-residual archs and mamba's ssm tensors
    (replicated); unknown keys are replicated. Requires n_heads % tp == 0
    and n_kv_heads % tp == 0 (the Engine validates first)."""

    def col(w):
        return N if _mm_or_dense(w) and _n_ok(w, tp) else None

    def row(w, partner_ok=True):
        # quantized planes interleave elements within 256-element K-chunks
        # (quant/repack.py), so a K-shard splits at chunk granularity; and
        # a row-parallel weight only helps when its upstream col weight was
        # sharded (otherwise the activation is already global)
        quantum = 256 * tp if isinstance(w, QTensor) else tp
        ok = partner_ok and _mm_or_dense(w) and w.shape[1] % quantum == 0
        return K if ok else None

    def bias(b):
        return N if b.shape[0] % tp == 0 else None

    out = {}
    for key, val in params.items():
        if val is None:
            out[key] = None
        elif key == "layers":
            out[key] = [_layer_plan(lyr, tp, col, row, bias) for lyr in val]
        elif key == "output":
            out[key] = col(val)          # lm head: vocab sharded on tp
        elif key == "output_b":
            out[key] = bias(val)
        else:
            out[key] = _repl(val)        # embeddings, final norms, ...
    return out


def _repl(val):
    return [_repl(v) for v in val] if isinstance(val, list) else None


def _layer_plan(lyr: dict, tp: int, col, row, bias) -> dict:
    # partner coupling: wo pairs with wq (always sharded once the Engine
    # validated n_heads % tp); w_down pairs with the FUSED gate tensor
    # where the engine's fusion popped w_gate / w_up -- otherwise w_down
    # would lose its K-shard and every rank recompute the largest FFN
    # weight in full
    gate = lyr.get("wgateup_fused")
    if gate is None:
        gate = (lyr.get("w_gate") if lyr.get("w_gate") is not None
                else lyr.get("w_up"))
    gate_ok = gate is not None and _n_ok(gate, tp)
    exps = lyr.get("ffn_gate_exp") or lyr.get("ffn_up_exp") or [None]
    exp_ok = exps[0] is not None and _n_ok(exps[0], tp)
    out = {}
    for key, val in lyr.items():
        if val is None:
            out[key] = None
        elif key in _COL_W or key in _KV_W:
            out[key] = col(val)
        elif key == "wo":
            out[key] = row(val)
        elif key == "w_down":
            out[key] = row(val, partner_ok=gate_ok)
        elif key in _COL_B or key in _KV_B:
            out[key] = bias(val)
        elif key in ("ffn_gate_exp", "ffn_up_exp"):
            out[key] = [col(w) for w in val]
        elif key == "ffn_down_exp":
            out[key] = [row(w, partner_ok=exp_ok) for w in val]
        else:
            out[key] = _repl(val)
    return out


def row_modes(params: dict, plan: dict) -> tuple[str, str, str]:
    """(row_attn, row_ffn, row_moe) of layer 0 (engine.py:264-312 of the
    JAX package, read from the plan): "psum" where the row weight is
    K-sharded, "gather" where it is replicated but its upstream col weight
    is N-sharded, else "none"."""
    layers = params.get("layers") or []
    if not layers:
        return "none", "none", "none"
    lyr, lp = layers[0], plan["layers"][0]

    def mode(wkey, colkey):
        if lyr.get(wkey) is None:
            return "none"
        if lp.get(wkey) == K:
            return "psum"
        colax = lp.get(colkey)
        if isinstance(colax, list):
            colax = colax[0] if colax else None
        return "gather" if colax == N else "none"

    qcol = "wqkv_fused" if lyr.get("wqkv_fused") is not None else "wq"
    if lyr.get("wgateup_fused") is not None:
        gate_key = "wgateup_fused"
    else:
        gate_key = "w_gate" if lyr.get("w_gate") is not None else "w_up"
    row_moe = "none"
    if lyr.get("ffn_down_exp") is not None:
        if lp["ffn_down_exp"][0] == K:
            row_moe = "psum"
        else:
            gkey = ("ffn_gate_exp" if lyr.get("ffn_gate_exp") is not None
                    else "ffn_up_exp")
            row_moe = "gather" if (lp.get(gkey) or [None])[0] == N else "none"
    return mode("wo", qcol), mode("w_down", gate_key), row_moe


def step_config(cfg, tp: int, params: dict, plan: dict):
    """The per-rank config the forward runs with: local head counts, the
    global head geometry frozen, the row modes and whether the head is
    vocab-sharded (which must mirror the plan's decision for "output"
    exactly: a sharded head without the gather misshapes the logits)."""
    row_attn, row_ffn, row_moe = (row_modes(params, plan) if tp > 1
                                  else ("none",) * 3)
    return replace(
        cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
        head_dim_kv=cfg.head_dim, tp=tp,
        tp_axis="tp" if tp > 1 else None,
        head_sharded=tp > 1 and plan.get("output") == N,
        row_attn=row_attn, row_ffn=row_ffn, row_moe=row_moe)


def _cut(w, axis, r: int, tp: int, dtype):
    """Rank r's contiguous piece of one weight. A QTensor piece whose N %
    128 or K % 256 is not 0 does not tile: it is stored dense (dequantized
    to the compute dtype), the path the JAX qmatmul takes for such a shard
    (qmatmul.py:41-42), decided here as the loader decides for a whole
    weight."""
    if axis is None or w is None:
        return w
    if isinstance(w, QTensor):
        n, k = w.shape
        s = (w.slice_n(r * n // tp, (r + 1) * n // tp) if axis == N
             else w.slice_k(r * k // tp, (r + 1) * k // tp))
        if s.shape[0] % 128 or s.shape[1] % 256:
            return dequant_mm(s, dtype=dtype).T.contiguous()
        return s
    if axis == N:
        n = w.shape[0]
        return w[r * n // tp:(r + 1) * n // tp].contiguous()
    k = w.shape[1]
    return w[:, r * k // tp:(r + 1) * k // tp].contiguous()


def _apply(val, ax, fn):
    if isinstance(val, list):
        axs = ax if isinstance(ax, list) else [ax] * len(val)
        return [_apply(v, a, fn) for v, a in zip(val, axs)]
    if isinstance(val, dict):
        return {k: _apply(v, (ax or {}).get(k), fn) for k, v in val.items()}
    return fn(val, ax)


def shard_params(params: dict, plan: dict, tp: int, ranks, dtype) -> list:
    """The per-rank params of the tp indices `ranks`: each a params dict
    of contiguous local tensors (replicated ones shared, not copied)."""
    return [_apply(params, plan, lambda w, a, r=r: _cut(w, a, r, tp, dtype))
            for r in ranks]


@dataclass
class Mesh:
    """A (dp, tp) mesh whose ranks of this process share its one device.
    Rank i is (i // tp, i % tp); process p owns the contiguous ranks
    [p * n_local, (p + 1) * n_local). comm finishes the collectives of a
    tp group that crosses processes (parallel.distributed.CrossProcess)."""

    dp: int
    tp: int
    device: torch.device
    process_index: int = 0
    process_count: int = 1
    comm: object = None

    @property
    def n_ranks(self) -> int:
        return self.dp * self.tp

    @property
    def n_local(self) -> int:
        return self.n_ranks // self.process_count

    @property
    def local_ranks(self) -> range:
        lo = self.process_index * self.n_local
        return range(lo, lo + self.n_local)

    @property
    def local_dp(self) -> list[int]:
        return sorted({r // self.tp for r in self.local_ranks})

    @property
    def local_tp(self) -> list[int]:
        """The tp indices this process holds (the same in every local dp
        group: a multi-process mesh has dp == 1)."""
        return sorted({r % self.tp for r in self.local_ranks})

    def describe(self) -> str:
        head = f"mesh (dp {self.dp}, tp {self.tp}): "
        if self.process_count == 1:
            return f"{head}{self.n_ranks} ranks on {self.device}, 1 process"
        r = self.local_ranks
        mine = f"rank {r[0]}" if len(r) == 1 else f"ranks {r[0]}-{r[-1]}"
        return (f"{head}{mine} of {self.n_ranks} on "
                f"{self.device}, process {self.process_index} of "
                f"{self.process_count}")


def make_mesh(n_dp: int, n_tp: int, device="cpu") -> Mesh:
    """The mesh of this process: every rank on `device`; under an
    initialized torch.distributed world of several processes, this
    process's contiguous block of the ranks (parallel.distributed)."""
    from tpulamm_torch.parallel import distributed
    dev = torch.device(device)
    world = distributed.world()
    if world is None:
        return Mesh(n_dp, n_tp, dev)
    index, count = world
    n = n_dp * n_tp
    if n % count:
        raise ValueError(f"mesh ({n_dp}, {n_tp}) has {n} ranks, which "
                         f"{count} processes cannot own in equal blocks")
    if n_dp != 1:
        raise ValueError(f"a mesh across {count} processes shards tp only "
                         f"(dp={n_dp}): dp across processes is not built")
    return Mesh(n_dp, n_tp, dev, index, count, distributed.CrossProcess())


class TPGroup:
    """The tp ranks of one dp group that this process runs: each rank's
    params and cache, its global tp index, and the group's collectives.
    The sum of partials runs in rank order in f32, the gathers concatenate
    in rank order; across processes both first gather every rank's part
    (CrossProcess), so a mesh split over processes computes bit for bit
    what the one-process mesh computes."""

    def __init__(self, params: list, caches: list, index: list, comm=None):
        self.params, self.caches, self.index = params, caches, index
        self.comm = comm

    @classmethod
    def single(cls, params, cache) -> "TPGroup":
        return cls([params], [cache], [0])

    def _all(self, parts: list) -> list:
        return parts if self.comm is None else self.comm.gather_parts(parts)

    def psum(self, parts: list) -> torch.Tensor:
        parts = self._all(parts)
        acc = parts[0].to(torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(torch.float32)
        return acc

    def gather(self, parts: list) -> torch.Tensor:
        return torch.cat(self._all(parts), dim=-1)


@dataclass
class ShardedParams:
    """An engine's weights on a mesh: the params of each local tp rank
    (`ranks`, in tp order) and the per-rank config the forward runs."""

    mesh: Mesh
    cfg: object
    ranks: list

    def without(self, keys) -> "ShardedParams":
        """The same ranks without `keys` (e.g. the lm head for embed)."""
        return ShardedParams(self.mesh, self.cfg, [
            {k: v for k, v in p.items() if k not in keys}
            for p in self.ranks])


def run_forward(body, sp: ShardedParams, tokens, positions, cache, slots,
                cells, segs=None, embeds=None, **kw):
    """A forward over the mesh: each local dp group's rows through
    body(TPGroup, cfg, tokens, positions, slots, cells, segs=, embeds=,
    **kw) -> logits, concatenated in dp order. dp > 1 needs the all-slots
    batch (slots None, B = n_slots: dp group d holds rows [d * B / dp,
    (d + 1) * B / dp)); dp == 1 takes any slots argument."""
    mesh = sp.mesh
    if mesh.dp == 1:
        g = TPGroup(sp.ranks, cache.groups[0], mesh.local_tp, mesh.comm)
        return body(g, sp.cfg, tokens, positions, slots, cells, segs=segs,
                    embeds=embeds, **kw), cache
    B = tokens.shape[0]
    if slots is not None or B != mesh.dp * cache.n_per:
        raise ValueError(f"a dp={mesh.dp} step runs every slot in order "
                         f"(B={B}, slots={slots!r})")
    outs = []
    for d in mesh.local_dp:
        rows = slice(d * cache.n_per, (d + 1) * cache.n_per)
        g = TPGroup(sp.ranks, cache.groups[d], mesh.local_tp, mesh.comm)
        outs.append(body(
            g, sp.cfg, tokens[rows], positions[rows], None,
            None if cells is None else cells[rows],
            segs=None if segs is None else segs[rows],
            embeds=None if embeds is None else embeds[rows], **kw))
    return torch.cat(outs), cache
