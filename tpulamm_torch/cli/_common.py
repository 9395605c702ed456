"""Shared CLI helpers."""

from __future__ import annotations

import os

# what the port still lacks of item 14: sharded training
MESH_TRAIN_ITEM = ("ROADMAP queue 1, item 14's training half (train(mesh=) "
                   "and parallel/pipeline.py)")


def require_file(parser, path: str | None, what: str = "model") -> None:
    """Exit with a clean argparse error when a user-supplied file is
    missing (instead of a FileNotFoundError traceback from deep inside
    the loader)."""
    if path is not None and not os.path.isfile(path):
        parser.error(f"{what} not found: {path}")
