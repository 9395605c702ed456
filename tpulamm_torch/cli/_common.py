"""Shared CLI helpers."""

from __future__ import annotations

import os


def require_file(parser, path: str | None, what: str = "model") -> None:
    """Exit with a clean argparse error when a user-supplied file is
    missing (instead of a FileNotFoundError traceback from deep inside
    the loader)."""
    if path is not None and not os.path.isfile(path):
        parser.error(f"{what} not found: {path}")
