"""Pipeline parallelism (the GPipe schedule) over "pp" stages (counterpart
of tpulamm.parallel.pipeline).

The reference's layer-pipeline distribution slot (ggml-mpi.c:105-201: each
rank owns a layer span, activations hop ranks by blocking MPI_Send/Recv;
hooked at llama.cpp:8736-8758, disabled at b2430). The JAX package runs it
as one shard_map program whose scan computes every stage on every one of
the M + P - 1 ticks and masks the dead ones; here:

- the per-layer params are stacked (L, ...) (stack_layer_params) and the
  stacks split on axis 0 over the stages (pipeline_specs' plan): stage s
  holds layers [s L / P, (s + 1) L / P) and runs them with
  train.model._layer_fwd;
- the schedule runs only the live (stage, microbatch) pairs of each tick:
  stage 0 embeds microbatch t, the last stage runs out_norm, the head and
  the NLL of microbatch t - (P - 1); the loss is the mean over the
  microbatches and every process returns it (the JAX psum). Loss and
  gradients are the JAX scan's, with less work;
- in one process the stages run in turn on the one device; across
  processes (parallel.distributed, gloo) each process owns n_pp / count
  consecutive stages (shard_stages cuts its part of the stacks) and the
  activations hop by parallel.distributed.send / recv, whose backwards
  carry the gradients the other way: ggml-mpi.c's pipeline;
- torch autograd differentiates through the schedule and the hops, so the
  same loss serves training (make_train_step_pp, with the port's
  train.optim).

Two traps of the multi-process run, handled here:
- Replicated gradients. tok_emb gets a gradient on stage 0 only, out_norm
  and output on the last stage only: the step sums them over the
  processes in process order, so every process applies the same update;
  and the clip's global norm covers every process's layer stack once
  (the vdot of make_train_step_pp).
- Deadlock. gloo's sends and receives must pair up on every process. The
  forward's hops run in tick order on every process; the backward's
  receives block while its sends do not (parallel.distributed), and each
  hop carries its own tag (microbatch m forward, n_micro + m backward), so
  no process waits on the order in which another's autograd engine
  reaches its hops.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.ops.layers import rms_norm
from tpulamm_torch.parallel import distributed
from tpulamm_torch.train import optim
from tpulamm_torch.train.model import _layer_fwd


@dataclass
class PPMesh:
    """n_pp pipeline stages on this process's device; process p of count
    owns the stages [p * n_pp / count, (p + 1) * n_pp / count)."""

    n_pp: int
    device: torch.device
    process_index: int = 0
    process_count: int = 1
    # the backward's asynchronous sends (distributed.flush_sends)
    pending: list = field(default_factory=list)

    @property
    def stages(self) -> range:
        """This process's stages."""
        n = self.n_pp // self.process_count
        return range(self.process_index * n, (self.process_index + 1) * n)

    @property
    def comm(self):
        return (distributed.CrossProcess() if self.process_count > 1
                else None)


def make_pp_mesh(n_pp: int, device=None) -> PPMesh:
    """The ("pp",) mesh of this process: every stage of this process on
    `device` (default "cuda"; raises without CUDA); under an initialized
    torch.distributed world of several processes, this process's
    contiguous block of the stages."""
    from tpulamm_torch.runtime.engine import resolve_device
    dev = resolve_device(device)
    world = distributed.world()
    if world is None:
        return PPMesh(n_pp, dev)
    index, count = world
    if n_pp % count:
        raise ValueError(f"{n_pp} stages cannot split over {count} "
                         "processes in equal blocks")
    return PPMesh(n_pp, dev, index, count)


def stack_layer_params(params: dict) -> dict:
    """List-of-layer-dicts -> one dict of (L, ...) stacked leaves (the
    shardable representation: axis 0 splits over "pp")."""
    layers = params["layers"]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {k: torch.stack([lyr[k] for lyr in layers])
                     for k in layers[0]}
    return out


def unstack_layer_params(stacked: dict) -> dict:
    """The inverse of stack_layer_params: the layer list in layer order
    (the tree train.model.save_params_gguf writes)."""
    st = stacked["layers"]
    n = next(iter(st.values())).shape[0]
    out = {k: v for k, v in stacked.items() if k != "layers"}
    out["layers"] = [{k: v[i] for k, v in st.items()} for i in range(n)]
    return out


def pipeline_specs(stacked: dict) -> dict:
    """The plan of a stacked tree: "pp" on axis 0 of the layer stacks,
    everything else replicated (None)."""
    return {k: ({n: "pp" for n in v} if k == "layers" else None)
            for k, v in stacked.items()}


def shard_stages(stacked: dict, mesh: PPMesh) -> dict:
    """This process's part of a stacked tree by pipeline_specs' plan: its
    stages' rows of each layer stack (copies), the rest as it is. In one
    process the tree itself."""
    if mesh.process_count == 1:
        return stacked
    n = next(iter(stacked["layers"].values())).shape[0]
    per = n // mesh.n_pp
    rows = slice(mesh.stages[0] * per, (mesh.stages[-1] + 1) * per)

    def cut(v, axis):
        if isinstance(v, dict):
            return {k: cut(x, axis[k]) for k, x in v.items()}
        return v if axis is None else v[rows].clone()
    return cut(stacked, pipeline_specs(stacked))


@torch.no_grad()
def gather_stages(local: dict, mesh: PPMesh) -> dict:
    """The whole stacked tree from every process's part (shard_stages'
    inverse); in one process the tree itself."""
    if mesh.process_count == 1:
        return local
    comm = mesh.comm
    out = {k: v for k, v in local.items() if k != "layers"}
    out["layers"] = {k: torch.cat(comm.gather_parts([v]))
                     for k, v in local["layers"].items()}
    return out


def make_pipeline_loss(cfg: ModelConfig, mesh: PPMesh, n_micro: int):
    """Returns loss_fn(stacked_params, tokens) -> the scalar CE loss, where
    tokens is (n_micro, mb, T+1) and the forward runs the GPipe schedule
    over the mesh's stages. stacked_params is this process's part
    (shard_stages; in one process the whole stacked tree). Differentiable:
    torch autograd goes through the schedule and the hops."""
    n_pp = mesh.n_pp
    if cfg.n_layers % n_pp:
        raise ValueError(f"n_layers={cfg.n_layers} must divide pp={n_pp}")
    per = cfg.n_layers // n_pp
    stages = mesh.stages
    first, last = stages[0], stages[-1]
    proc = mesh.process_index

    def head_loss(params, h, tgt):
        h = rms_norm(h, params["out_norm"], cfg.norm_eps)
        logits = (h @ params["output"].T).to(torch.float32)
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(lp, -1, tgt[..., None])[..., 0].mean()

    def loss_fn(stacked_params, tokens):
        distributed.flush_sends(mesh.pending)
        layers = stacked_params["layers"]
        have = next(iter(layers.values())).shape[0]
        if have != per * len(stages):
            raise ValueError(f"the layer stacks hold {have} layers; this "
                             f"process's {len(stages)} stages hold "
                             f"{per * len(stages)} (shard_stages)")
        emb = stacked_params["tok_emb"]
        dev = emb.device
        tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
        M = n_micro
        toks_in, targets = tokens[:, :, :-1], tokens[:, :, 1:]
        mb, T = toks_in.shape[1], toks_in.shape[2]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=dev).expand(mb, T)
        mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
        mask = mask[None, None, None]

        def run_stage(s, x):
            lo = (s - first) * per
            for i in range(lo, lo + per):
                x = _layer_fwd([{k: v[i] for k, v in layers.items()}], cfg,
                               x, positions, mask)
            return x

        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        acts, hops = {}, []
        for t in range(M + n_pp - 1):
            for s in stages:
                m = t - s
                if not 0 <= m < M:
                    continue
                if s == 0:
                    x = emb[toks_in[m]]
                elif s == first:
                    x = distributed.recv(layers["attn_norm"],
                                         (mb, T, cfg.dim), emb.dtype,
                                         proc - 1, m, M + m, mesh.pending)
                else:
                    x = acts.pop((s - 1, m))
                h = run_stage(s, x)
                if s == n_pp - 1:
                    loss_sum = loss_sum + head_loss(stacked_params, h,
                                                    targets[m])
                elif s == last:
                    hops.append(distributed.send(h, proc + 1, m, M + m))
                else:
                    acts[(s, m)] = h
        if mesh.process_count > 1:
            # every process returns the last stage's loss; a process's
            # hops join its loss as zeros so the backward reaches them
            total = mesh.comm.gather_parts([loss_sum.detach()])[-1]
            if last != n_pp - 1:
                loss_sum = total
            for tok in hops:
                loss_sum = loss_sum + tok
        return loss_sum / M

    return loss_fn


def _pp_vdot(mesh: PPMesh, per: int, n_st: int):
    """The inner product over the whole pipeline of a stacked tree's
    leaves (optim.tree_leaves order: the n_st layer stacks first, then the
    replicated leaves): the replicated leaves once, then each stage's rows
    of every stack, stage after stage, in one fixed order on every process
    (distributed.ordered_sum)."""
    def vdot(xs, ys):
        repl = [torch.dot(x.reshape(-1), y.reshape(-1))
                for x, y in zip(xs[n_st:], ys[n_st:])]
        pieces = []
        for j in range(len(mesh.stages)):
            rows = slice(j * per, (j + 1) * per)
            pieces += [torch.dot(x[rows].reshape(-1), y[rows].reshape(-1))
                       for x, y in zip(xs[:n_st], ys[:n_st])]
        return distributed.ordered_sum(repl + pieces, len(repl), mesh.comm)
    return vdot


def make_train_step_pp(cfg: ModelConfig, mesh: PPMesh, opt, n_micro: int):
    """The pipeline step with the port's train.optim optimizer `opt`
    (make_optimizer): step(params, opt_state, tokens) -> (params,
    opt_state, loss), params this process's stacked part, updated in place;
    opt_state = opt.init(optim.tree_leaves(params)). As in JAX no `value`
    goes to the update, so L-BFGS raises here."""
    from tpulamm_torch.train.train import value_and_grad
    loss_fn = make_pipeline_loss(cfg, mesh, n_micro)
    per = cfg.n_layers // mesh.n_pp

    def step(stacked_params, opt_state, tokens):
        leaves = optim.tree_leaves(stacked_params)
        n_st = len(stacked_params["layers"])
        loss, grads = value_and_grad(lambda p: loss_fn(p, tokens),
                                     stacked_params, leaves)
        distributed.flush_sends(mesh.pending)
        if mesh.process_count > 1:
            # the replicated leaves (after the stacks: out_norm, output,
            # tok_emb) got their gradients on one stage each: the sum over
            # the processes, in process order, on every process
            for i in range(n_st, len(grads)):
                parts = mesh.comm.gather_parts([grads[i]])
                acc = parts[0]
                for g in parts[1:]:
                    acc = acc + g
                grads[i] = acc
        updates, opt_state = opt.update(grads, opt_state, leaves,
                                        vdot=_pp_vdot(mesh, per, n_st))
        optim.apply_updates(leaves, updates)
        return stacked_params, opt_state, loss

    return step


def train_step_pp(cfg: ModelConfig, mesh: PPMesh, stacked_params, opt,
                  opt_state, tokens, n_micro: int):
    """One optimizer step under pipeline parallelism; returns (params,
    opt_state, loss). A caller that loops can keep the step of
    make_train_step_pp."""
    return make_train_step_pp(cfg, mesh, opt, n_micro)(stacked_params,
                                                       opt_state, tokens)
