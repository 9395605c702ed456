"""A dense training tree cut over a (dp, tp) mesh's ranks by the megatron
shard plan (parallel.mesh.param_plan): the optimizer leaves of
train.train(mesh=), the counterpart of the JAX train(mesh=)'s
shard_params."""

from __future__ import annotations

import torch

from tpulamm_torch.parallel.distributed import ordered_sum
from tpulamm_torch.parallel.mesh import N, Mesh, _cut, param_plan
from tpulamm_torch.train.optim import tree_unflatten


def _walk(tree, plan):
    """(tensor, axis) for each leaf of a params tree in JAX's leaf order
    (dict keys sorted; None skipped), the axis read from the plan that
    mirrors it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], (plan or {}).get(k))
    elif isinstance(tree, (list, tuple)):
        plans = plan if isinstance(plan, list) else [plan] * len(tree)
        for v, a in zip(tree, plans):
            yield from _walk(v, a)
    elif tree is not None:
        yield tree, plan


class TrainShards:
    """A dense training tree (train.model.init_params' layout: separate wq /
    wk / wv and w_gate / w_up) cut over a mesh's local tp ranks by
    param_plan, the counterpart of the JAX train(mesh=)'s shard_params. The
    cuts are plain contiguous slices of the f32 tensors (the 256-element
    K-chunk and stored-dense rules are for QTensors only).

    leaves: the optimizer's leaves, the unique tensors of this process:
    each replicated tensor once, then each local rank's shards, rank after
    rank, in JAX leaf order. A replicated tensor counted once a rank would
    enter clip_by_global_norm and L-BFGS's inner products tp times.
    ranks(leaves) rebuilds the local ranks' trees over them (replicated
    tensors shared); cut(tree) cuts a tree of the same structure (a
    grad_mask) into a list aligned with the leaves; vdot is the inner
    product over the whole mesh; gather(leaves) returns the global
    tensors in leaf order."""

    def __init__(self, params: dict, mesh: Mesh):
        self.mesh, self.tree = mesh, params
        self.plan = param_plan(params, mesh.tp)
        self.axes = [a for _, a in _walk(params, self.plan)]
        self.n_repl = sum(a is None for a in self.axes)
        self.leaves = self.cut(params)

    def cut(self, tree) -> list:
        flat = [t for t, _ in _walk(tree, self.plan)]
        dev, tp = self.mesh.device, self.mesh.tp
        out = [t.to(dev) for t, a in zip(flat, self.axes) if a is None]
        for r in self.mesh.local_tp:
            out += [_cut(t, a, r, tp, None).to(dev)
                    for t, a in zip(flat, self.axes) if a is not None]
        return out

    def _split(self, leaves: list) -> tuple[list, list]:
        n = len(self.axes) - self.n_repl
        rest = leaves[self.n_repl:]
        return (leaves[:self.n_repl],
                [rest[i * n:(i + 1) * n]
                 for i in range(len(self.mesh.local_tp))])

    def ranks(self, leaves: list) -> list:
        repl, shards = self._split(leaves)
        out = []
        for sh in shards:
            it_r, it_s = iter(repl), iter(sh)
            out.append(tree_unflatten(self.tree, [
                next(it_r) if a is None else next(it_s)
                for a in self.axes]))
        return out

    def vdot(self, xs: list, ys: list) -> torch.Tensor:
        return ordered_sum([torch.dot(x.reshape(-1), y.reshape(-1))
                            for x, y in zip(xs, ys)], self.n_repl,
                           self.mesh.comm)

    @torch.no_grad()
    def gather(self, leaves: list) -> list:
        repl, shards = self._split(leaves)
        it_r, j, out = iter(repl), 0, []
        for a in self.axes:
            if a is None:
                out.append(next(it_r))
                continue
            parts = [sh[j] for sh in shards]
            j += 1
            if self.mesh.comm is not None:
                parts = self.mesh.comm.gather_parts(parts)
            out.append(torch.cat(parts, dim=0 if a == N else 1))
        return out
