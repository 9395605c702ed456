"""Shared CLI helpers."""

from __future__ import annotations

import os

MESH_ITEM = "ROADMAP queue 1, item 14 (parallelism)"
DISTRIBUTED_FLAGS = ("coordinator", "num_processes", "process_id")


def require_file(parser, path: str | None, what: str = "model") -> None:
    """Exit with a clean argparse error when a user-supplied file is
    missing (instead of a FileNotFoundError traceback from deep inside
    the loader)."""
    if path is not None and not os.path.isfile(path):
        parser.error(f"{what} not found: {path}")


def add_unported_args(p) -> None:
    """The JAX CLIs' mesh and multi-host flags (--tp, --dp, --coordinator,
    --num-processes, --process-id): accepted so a command line carries
    over, refused by refuse_unported when set."""
    p.add_argument("--tp", type=int, default=1,
                   help=f"tensor-parallel shards: not ported ({MESH_ITEM})")
    p.add_argument("--dp", type=int, default=1,
                   help=f"data-parallel slot sharding: not ported "
                        f"({MESH_ITEM})")
    for flag in DISTRIBUTED_FLAGS:
        p.add_argument("--" + flag.replace("_", "-"), default=None,
                       help=f"multi-host runs: not ported ({MESH_ITEM})")


def refuse_unported(tp: int = 1, dp: int = 1,
                    multihost: bool = False) -> None:
    """Raise for the mesh and multi-host options of the JAX CLIs and
    server, which the port does not run yet, naming the ROADMAP item that
    brings them."""
    if tp > 1 or dp > 1 or multihost:
        what = (f"--tp {tp} / --dp {dp}" if tp > 1 or dp > 1
                else "multi-host runs")
        raise NotImplementedError(
            f"{what}: the mesh and the multi-host transport are not ported "
            f"yet ({MESH_ITEM})")
