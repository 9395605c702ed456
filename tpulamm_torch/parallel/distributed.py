"""Multi-process runs of a mesh (counterpart of
tpulamm.parallel.distributed).

One process for each block of mesh ranks, every process running the same
host program over the same inputs (the JAX package's multi-controller
contract, distributed.py:56-72): the Engine's host mirrors (cell_pos,
n_past, request feeding) stay identical across processes by determinism,
and a collective whose tp group crosses processes is finished over
torch.distributed (CrossProcess).

The backend is gloo: on the tests' CPU tensors, and on the card, where
two processes share one device and NCCL refuses two ranks on one device.
A gloo collective cannot be captured in a CUDA graph, so a multi-process
mesh steps eagerly (runtime.decode_graph).

Training's collectives are autograd Functions over the same gathers
(gather_ranks, reduce_ranks, fan_out: megatron's "g" and "f") and the
pipeline's hops go through send / recv, whose backwards carry the gradients
the other way (parallel.pipeline); ordered_sum gives every process the
same inner product of a tree split over them.

Usage, each process of N:

    from tpulamm_torch.parallel.distributed import init_distributed
    init_distributed(coordinator="host0:8476", num_processes=N,
                     process_id=i)
    # or, under torchrun (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK):
    init_distributed(coordinator="")

then build the same Engine(tp=, dp=) in every process.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     ranks: int | None = None) -> dict:
    """Join the process group; returns the topology: process_index,
    process_count, and the mesh ranks it counts (`ranks`, default one a
    process) as local_devices (this process's block) and global_devices.

    coordinator "HOST:PORT" rendezvouses at tcp://HOST:PORT (process 0
    listens there); None or "" reads torchrun's environment (env://)."""
    import torch.distributed as dist
    if coordinator:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    else:
        kw = {}
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
        dist.init_process_group("gloo", init_method="env://", **kw)
    count = dist.get_world_size()
    total = ranks if ranks is not None else count
    return {
        "process_index": dist.get_rank(),
        "process_count": count,
        "local_devices": total // count,
        "global_devices": total,
    }


def world() -> tuple[int, int] | None:
    """(process index, process count) of an initialized torch.distributed
    world of more than one process, else None."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    return (dist.get_rank(), n) if n > 1 else None


class CrossProcess:
    """The collectives of a group of processes: a tp group whose ranks
    span processes, or a dp exchange (the processes that hold one tp
    index, one dp group after another). `group` is a torch.distributed
    process group (None: the whole world); `rank` is this process's index
    in it. gather_parts all-gathers each member's local parts and returns
    every part in member order (rank order in a tp group, dp order in a dp
    exchange): a sum or concatenation then runs over them as in one
    process, so the result is the one-process mesh's bit for bit. The
    parts travel as raw bytes (gloo reduces no bf16; a gather needs
    none). gather_first and scatter_first move a tensor to or from the
    first member alone (`first`, its global rank), through host memory:
    a session's cache, which only process 0 writes or reads."""

    def __init__(self, group=None, first: int = 0):
        import torch.distributed as dist
        self.group, self.first = group, first
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def gather_parts(self, parts: list) -> list:
        import torch.distributed as dist
        local = torch.stack(parts).contiguous()
        raw = local.view(torch.uint8).reshape(-1)
        out = [torch.empty_like(raw) for _ in range(self.size)]
        dist.all_gather(out, raw, group=self.group)
        return [p for blk in out
                for p in blk.view(local.dtype).reshape(local.shape).unbind(0)]

    def gather_first(self, x: torch.Tensor) -> list | None:
        """x from every member in member order, as host tensors, on the
        first member; None on the others."""
        import torch.distributed as dist
        raw = x.contiguous().reshape(-1).view(torch.uint8).cpu()
        out = ([torch.empty_like(raw) for _ in range(self.size)]
               if self.rank == 0 else None)
        dist.gather(raw, out, dst=self.first, group=self.group)
        return None if out is None else [
            b.view(x.dtype).reshape(x.shape) for b in out]

    def scatter_first(self, parts: list | None, shape, dtype
                      ) -> torch.Tensor:
        """The first member's parts[i] to member i (parts None on the
        others), each of `shape` and `dtype`; returns this member's part
        as a host tensor."""
        import torch.distributed as dist
        raw = torch.empty(torch.Size(shape).numel() * dtype.itemsize,
                          dtype=torch.uint8)
        src = None if parts is None else [
            p.contiguous().reshape(-1).view(torch.uint8).cpu() for p in parts]
        dist.scatter(raw, src, src=self.first, group=self.group)
        return raw.view(dtype).reshape(shape)


def gather_rows(x: torch.Tensor, comm=None, dim: int = 0) -> torch.Tensor:
    """x from every member of `comm`, concatenated on `dim` in member order
    (x itself without comm): a dp exchange's rows in dp order."""
    return x if comm is None else torch.cat(comm.gather_parts([x]), dim)


def mesh_comms(n_dp: int, n_tp: int, index: int, count: int) -> tuple:
    """(tp comm, dp comm) of process `index` of `count` on a (n_dp, n_tp)
    mesh whose contiguous rank blocks (parallel.mesh.block_size) are
    whole dp groups or lie inside one. The tp comm spans the processes of
    this process's dp group, the dp comm those that hold its tp indices;
    either is None where it would be this process alone. gloo makes every
    process create every group, in one order, member or not."""
    import torch.distributed as dist
    n_local = n_dp * n_tp // count
    span = max(n_tp // n_local, 1)       # processes a dp group spans
    tp_sets = [list(range(d * span, (d + 1) * span)) for d in range(n_dp)]
    dp_sets = [list(range(j, count, span)) for j in range(span)]

    def comm(sets):
        mine = None
        for members in sets:
            if len(members) == 1:
                continue
            group = (None if len(members) == count
                     else dist.new_group(members))
            if index in members:
                mine = CrossProcess(group, members[0])
        return mine
    return comm(tp_sets), comm(dp_sets)


# -- collectives that autograd goes through (training) ----------------------
# Megatron's pair of operators for a tp group: "f" on a column-parallel
# product's input (fan_out) and "g" on a row-parallel product's output
# (reduce_ranks), plus the vocab-sharded head's gather (gather_ranks). In
# one process (comm None) they are tensor ops in rank order; across
# processes the same sums run over every rank's part, gathered as raw bytes
# (CrossProcess), so both give the same bits.

class _Gather(torch.autograd.Function):
    """Every rank's part in rank order from this process's local parts. The
    backward hands each local part its own slice of the incoming gradients
    and sums nothing over processes: every process computes the same loss
    from the gathered parts, so each already holds the whole gradient."""

    @staticmethod
    def forward(ctx, comm, *parts):
        ctx.lo, ctx.n = comm.rank * len(parts), len(parts)
        return tuple(comm.gather_parts(list(parts)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads[ctx.lo:ctx.lo + ctx.n])


class _Fan(torch.autograd.Function):
    """"f": n local copies of a replicated activation (the identity). The
    backward sums the input gradients of every rank in rank order, gathered
    across processes first: without it a replicated tensor upstream (a
    norm's weight, the residual, tok_emb) gets only the local ranks'
    share of its gradient."""

    @staticmethod
    def forward(ctx, comm, n, x):
        ctx.comm = comm
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        parts = list(grads)
        if ctx.comm is not None:
            parts = ctx.comm.gather_parts(parts)
        acc = parts[0]
        for g in parts[1:]:
            acc = acc + g
        return None, None, acc


def gather_ranks(parts: list, comm=None) -> list:
    """Every rank's part in rank order (the local parts themselves in one
    process); differentiable."""
    return list(parts) if comm is None else list(_Gather.apply(comm, *parts))


def reduce_ranks(parts: list, comm=None) -> torch.Tensor:
    """"g": the f32 sum in rank order of every rank's partial product (a
    row-parallel product's output); differentiable."""
    parts = gather_ranks(parts, comm)
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc


def fan_out(x: torch.Tensor, n: int, comm=None) -> list:
    """"f": `x` for each of the n local ranks (a column-parallel product's
    input); see _Fan."""
    return list(_Fan.apply(comm, n, x))


def ordered_sum(dots: list, n_repl: int, comm=None) -> torch.Tensor:
    """The f32 sum, in one fixed order, of the scalars of a tree split over
    the processes of `comm` (an inner product's leaf by leaf terms):
    `dots` holds this process's n_repl replicated terms, counted on the
    group's first process only, then the terms of its own pieces. Across
    processes every member's list is gathered and added member by member,
    so every member gets the same bits, and the bits one process holding
    every piece gets."""
    vec = torch.stack(dots).to(torch.float32)
    if comm is not None:
        if comm.rank != 0:
            vec = torch.cat([torch.zeros_like(vec[:n_repl]), vec[n_repl:]])
        vec = torch.cat(comm.gather_parts([vec]))
    acc = np.float32(0)
    for v in vec.cpu().numpy():
        acc = np.float32(acc + v)
    return torch.tensor(acc, device=dots[0].device)


def send_tensors(xs: list, dst: int, tag: int) -> None:
    """The tensors xs to process dst as one host byte buffer (gloo's send
    takes CPU tensors); recv_tensors takes them."""
    import torch.distributed as dist
    buf = torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                     for x in xs])
    dist.send(buf.cpu(), dst, tag=tag)


def recv_tensors(xs: list, src: int, tag: int) -> None:
    """Fill the tensors xs in place from process src's send_tensors of
    tensors of the same shapes and dtypes."""
    import torch.distributed as dist
    sizes = [x.numel() * x.element_size() for x in xs]
    buf = torch.empty(sum(sizes), dtype=torch.uint8)
    dist.recv(buf, src, tag=tag)
    buf = buf.to(xs[0].device)
    for x, piece in zip(xs, buf.split(sizes)):
        x.copy_(piece.clone().view(x.dtype).reshape(x.shape))


# -- point to point (the pipeline's hops) -------------------------------------
# The hops go through host copies: gloo's send / recv take CPU tensors.
# Sends in a backward are asynchronous (isend), so no process waits on the
# order in which another's autograd engine reaches its hops: a process
# blocks only on a receive, whose matching send a later stage makes without
# waiting. Each such send goes on the caller's `pending` list (its buffer
# kept alive), which flush_sends completes.


def flush_sends(pending: list) -> None:
    """Wait for the asynchronous sends on `pending` and empty it."""
    while pending:
        work, _buf = pending.pop(0)
        work.wait()


class _Send(torch.autograd.Function):
    """Send x to process dst (tag); returns a 0-d zero that the caller adds
    to its loss so the backward reaches this hop, which receives x's
    gradient from dst (back_tag)."""

    @staticmethod
    def forward(ctx, x, dst, tag, back_tag):
        import torch.distributed as dist
        dist.send(x.detach().to("cpu").contiguous(), dst, tag=tag)
        ctx.meta = (x.shape, x.dtype, x.device, dst, back_tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        import torch.distributed as dist
        shape, dtype, device, dst, back_tag = ctx.meta
        buf = torch.empty(shape, dtype=dtype)
        dist.recv(buf, dst, tag=back_tag)
        return buf.to(device), None, None, None


class _Recv(torch.autograd.Function):
    """Receive a tensor from process src (tag). `anchor`, a parameter of
    this process that the received tensor flows into, puts the hop on the
    backward's path to the parameters (torch.autograd.grad runs only the
    nodes on a path to its inputs): the backward sends the gradient back to
    src and gives the anchor none."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, tag, back_tag, pending):
        import torch.distributed as dist
        buf = torch.empty(shape, dtype=dtype)
        dist.recv(buf, src, tag=tag)
        ctx.meta = (src, back_tag, pending)
        return buf.to(anchor.device)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        src, back_tag, pending = ctx.meta
        buf = grad.detach().to("cpu").contiguous()
        pending.append((dist.isend(buf, src, tag=back_tag), buf))
        return None, None, None, None, None, None, None


def send(x: torch.Tensor, dst: int, tag: int, back_tag: int) -> torch.Tensor:
    """Send x to process dst with `tag`; returns the 0-d token (see _Send).
    Its gradient comes back with `back_tag`."""
    return _Send.apply(x, dst, tag, back_tag)


def recv(anchor: torch.Tensor, shape, dtype, src: int, tag: int,
         back_tag: int, pending: list) -> torch.Tensor:
    """A tensor from process src with `tag`, on anchor's device (see
    _Recv); its gradient goes back with `back_tag`, an asynchronous send
    put on `pending` (flush_sends)."""
    return _Recv.apply(anchor, tuple(shape), dtype, src, tag, back_tag,
                       pending)


def add_distributed_args(p) -> None:
    """Multi-process flags shared by main / bench / server (the reference's
    mpirun -n N slot, ggml-mpi.c / SURVEY 5.8)."""
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process rendezvous address (process 0 "
                        "listens there); '' reads torchrun's environment; "
                        "omit for one process")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index")


def init_from_args(args) -> dict | None:
    """Join the process group when any --coordinator / --num-processes /
    --process-id flag was given (None = one process, no-op); counts the
    mesh's ranks from --tp / --dp. Every process must then run the same
    host program over the same inputs: the server keeps HTTP on process 0
    and mirrors its engine calls to the others (server.multihost)."""
    coord = getattr(args, "coordinator", None)
    nproc = getattr(args, "num_processes", None)
    ppid = getattr(args, "process_id", None)
    if coord is None and nproc is None and ppid is None:
        return None
    ranks = getattr(args, "tp", 1) * getattr(args, "dp", 1)
    info = init_distributed(coordinator=coord or None,
                            num_processes=nproc, process_id=ppid,
                            ranks=ranks)
    print(f"distributed: process {info['process_index']}/"
          f"{info['process_count']}, {info['local_devices']} local / "
          f"{info['global_devices']} global mesh ranks", file=sys.stderr)
    return info
