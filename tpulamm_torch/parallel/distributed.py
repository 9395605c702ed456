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
    """The collectives of a tp group that spans every process of the world
    (a multi-process mesh has dp == 1). gather_parts all-gathers each
    process's local parts and returns every rank's part in rank order:
    the sum and the concatenation then run over them as in one process,
    so the result is the one-process mesh's bit for bit. The parts travel
    as raw bytes (gloo reduces no bf16; a gather needs none)."""

    def gather_parts(self, parts: list) -> list:
        import torch.distributed as dist
        local = torch.stack(parts).contiguous()
        raw = local.view(torch.uint8).reshape(-1)
        out = [torch.empty_like(raw) for _ in range(dist.get_world_size())]
        dist.all_gather(out, raw)
        return [p for blk in out
                for p in blk.view(local.dtype).reshape(local.shape).unbind(0)]


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
