"""Training loop: AdamW / L-BFGS over the causal-LM loss (counterpart of
tpulamm.train.train).

Parity with the reference's optimizer layer (ggml_opt_init + ADAM/LBFGS,
ggml.h:2004-2160) and examples/train-text-from-scratch's loop (tokenize a
raw text corpus, sample windows, optimize, checkpoint). The optimizers are
the port's copy of optax's arithmetic (train.optim); torch autograd gives
the gradients; the step runs eagerly on the params' device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.train import optim
from tpulamm_torch.train.model import causal_lm_loss


@dataclass
class TrainConfig:
    optimizer: str = "adamw"      # adamw | lbfgs (GGML_OPT_TYPE_{ADAM,LBFGS})
    lr: float = 1e-3
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    batch_size: int = 8
    seq_len: int = 128
    n_steps: int = 100
    warmup_steps: int = 10
    remat: bool = False           # gradient checkpointing
    seed: int = 0


def make_optimizer(tc: TrainConfig):
    if tc.optimizer == "adamw":
        return optim.AdamW(tc)
    if tc.optimizer == "lbfgs":
        return optim.LBFGS(tc.lr)
    raise ValueError(tc.optimizer)


def sample_batches(data: np.ndarray, tc: TrainConfig):
    """Random windows over the token stream (train-text-from-scratch
    get_example_targets-style sampling); the JAX package's draws."""
    rng = np.random.default_rng(tc.seed)
    n = len(data) - tc.seq_len - 1
    assert n > 0, "corpus shorter than seq_len"
    while True:
        idx = rng.integers(0, n, size=tc.batch_size)
        yield np.stack([data[i:i + tc.seq_len + 1] for i in idx])


def value_and_grad(loss_fn, tree, leaves: list):
    """(loss, d loss / d leaves) of loss_fn(tree rebuilt from `leaves`); a
    leaf the loss does not reach (a pipeline stage's tok_emb on another
    process) gets zeros."""
    xs = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(optim.tree_unflatten(tree, xs))
        grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def device_batch(b, device):
    """A batch array (or a tuple of them) on `device`: integer arrays as
    int64 token ids, float arrays as f32."""
    if isinstance(b, tuple):
        return tuple(device_batch(x, device) for x in b)
    a = np.asarray(b)
    dt = torch.long if a.dtype.kind in "iu" else torch.float32
    return torch.as_tensor(a, dtype=dt, device=device)


def optimize(tree, loss_fn, tc: TrainConfig, batches, log_every: int = 10,
             log=print, prefix: str = "step", grad_mask=None, stats=None,
             vdot=None):
    """The training loop over any tree of tensors: n_steps of
    make_optimizer(tc) on loss_fn(tree, batch), a batch from `batches`
    each (device_batch). Returns (tree, losses). stats, a dict, gets each
    step's wall seconds ("step_s", ending in the loss's copy back) and the
    line-search trials of an L-BFGS step ("trials"). vdot: the optimizer's
    inner product where the tree is one process's part of a whole
    (AdamW.update)."""
    opt = make_optimizer(tc)
    leaves = [x.detach() for x in optim.tree_leaves(tree)]
    mask = optim.tree_leaves(grad_mask) if grad_mask is not None else None
    state = opt.init(leaves)
    losses = []
    t0 = time.perf_counter()
    for i in range(tc.n_steps):
        ts = time.perf_counter()
        batch = device_batch(next(batches), leaves[0].device)

        def vg(xs, batch=batch):
            return value_and_grad(lambda t: loss_fn(t, batch), tree, xs)
        loss, grads = vg(leaves)
        if mask is not None:
            grads = [g * m for g, m in zip(grads, mask)]
        if tc.optimizer == "lbfgs":
            updates, state = opt.update(grads, state, leaves, value=loss,
                                        grad=grads, value_and_grad_fn=vg,
                                        vdot=vdot)
        else:
            updates, state = opt.update(grads, state, leaves, vdot=vdot)
        optim.apply_updates(leaves, updates)
        losses.append(float(loss))
        if stats is not None:
            stats.setdefault("step_s", []).append(time.perf_counter() - ts)
            if tc.optimizer == "lbfgs":
                stats.setdefault("trials", []).append(state["trials"])
        if log_every and (i % log_every == 0 or i == tc.n_steps - 1):
            dt = time.perf_counter() - t0
            log(f"{prefix} {i:5d}  loss {losses[-1]:.4f}  "
                f"({dt / (i + 1):.3f}s/step)")
    return optim.tree_unflatten(tree, leaves), losses


def train(params: dict, cfg: ModelConfig, data: np.ndarray,
          tc: TrainConfig, log_every: int = 10, log=print,
          grad_mask=None, mesh=None, batches=None, stats=None):
    """Optimize params on a token stream; returns (params, losses). The
    params are updated in place on their device.

    grad_mask: optional tree of {0,1} matching params — zeroes gradients
    of frozen tensors.

    batches: optional generator of (batch_size, seq_len+1) int arrays
    overriding the default random-window sampler (document-aligned tasks
    like tools/passkey_train need episode boundaries respected).

    mesh: a (dp, tp) parallel.mesh.Mesh (make_mesh). The params are cut
    by the megatron shard plan into per-rank tensors (TrainShards), each
    batch's rows split over the dp groups (a batch dp does not divide
    raises, as the JAX NamedSharding does), the loss is the mean over all
    rows and the tp collectives go through autograd (parallel.distributed);
    the products stay torch matmuls, as the JAX step's are XLA dots. The
    caller's tensors get the trained values in the global layout. Across
    processes (tp groups, dp groups or both split over them) every process
    runs the same loop over the same batches: the dp groups' token losses
    and gradients are exchanged in dp order, so every process gets the
    losses and params of the one-process mesh, bit for bit.
    stats: see optimize."""
    if batches is None:
        batches = sample_batches(data, tc)
    if mesh is not None:
        return _train_mesh(params, cfg, tc, batches, mesh, grad_mask,
                           log_every, log, stats)
    return optimize(params,
                    lambda p, b: causal_lm_loss(p, cfg, b, remat=tc.remat),
                    tc, batches, log_every=log_every, log=log,
                    grad_mask=grad_mask, stats=stats)


def _train_mesh(params, cfg, tc, batches, mesh, grad_mask, log_every, log,
                stats):
    """train(mesh=...): the loop over the mesh's unique leaves."""
    from tpulamm_torch.parallel.distributed import fan_out, gather_ranks
    from tpulamm_torch.parallel.mesh import step_config
    from tpulamm_torch.train.model import forward_train, token_nll
    from tpulamm_torch.train.shards import TrainShards
    tp = mesh.tp
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} and n_kv_heads="
                         f"{cfg.n_kv_heads} must both be divisible by "
                         f"tp={tp}")
    shards = TrainShards(params, mesh)
    cfg_step = step_config(cfg, tp, params, shards.plan)

    def loss_fn(leaves, batch):
        """The mean token loss over every dp group's rows. Each leaf is
        fanned out to the local dp groups (fan_out over the dp exchange),
        so its gradient is the sum of every dp group's in dp order, in one
        process or across processes; the local groups' token losses are
        gathered over the dp exchange before the mean."""
        if batch.shape[0] % mesh.dp:
            raise ValueError(f"a batch of {batch.shape[0]} rows does not "
                             f"split over dp={mesh.dp}")
        local = mesh.local_dp
        fans = [fan_out(x, len(local), mesh.dp_comm) for x in leaves]
        n = batch.shape[0] // mesh.dp
        nll = []
        for j, d in enumerate(local):
            rows = batch[d * n:(d + 1) * n]
            ranks = shards.ranks([f[j] for f in fans])
            nll.append(token_nll(forward_train(ranks, cfg_step, rows,
                                               remat=tc.remat,
                                               comm=mesh.comm), rows))
        return torch.cat(gather_ranks([torch.cat(nll)],
                                      mesh.dp_comm)).mean()
    mask = shards.cut(grad_mask) if grad_mask is not None else None
    leaves, losses = optimize(shards.leaves, loss_fn, tc, batches,
                              log_every=log_every, log=log, grad_mask=mask,
                              stats=stats, vdot=shards.vdot)
    with torch.no_grad():
        for dst, src in zip(optim.tree_leaves(params), shards.gather(leaves)):
            dst.copy_(src)
    return params, losses
