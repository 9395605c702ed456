"""File logging + log callback (reference: common/log.h, llama.h:959).

Copy of tpulamm.utils.log.

The reference's log layer has three capabilities the CLIs rely on:

- LOG(...):      write to the log file only (debug trail of a run)
- LOG_TEE(...):  write to the log file AND stderr (user-visible progress)
- llama_log_set: route every library log line through a user callback

plus `--logdir` YAML result dumps (llama_dump_timing_info_yaml,
main.cpp run dumps). This module reproduces that surface in idiomatic
Python: a module-level sink configured once per process by the CLI
(`setup` / `add_args`), `log()` / `log_tee()` writers, a `set_callback`
override, and `dump_yaml` for structured end-of-run records.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional, TextIO

_file: Optional[TextIO] = None
_callback: Optional[Callable[[str, str], None]] = None
_disabled = False


def default_filename(prog: str) -> str:
    """Reference default target: <prog>.<pid>.log (common/log.h)."""
    return f"{prog}.{os.getpid()}.log"


def set_callback(cb: Optional[Callable[[str, str], None]]) -> None:
    """Route log lines through cb(level, text) instead of the file/stderr
    (llama_log_set parity). Pass None to restore default routing."""
    global _callback
    _callback = cb


def open_file(path: str, append: bool = False) -> None:
    global _file
    close_file()
    _file = open(path, "a" if append else "w", buffering=1,
                 encoding="utf-8")


def close_file() -> None:
    global _file
    if _file is not None:
        _file.close()
        _file = None


def disable() -> None:
    global _disabled
    _disabled = True
    close_file()


def log(text: str, level: str = "info") -> None:
    """File-only log line (LOG macro semantics)."""
    if _disabled:
        return
    if _callback is not None:
        _callback(level, text)
        return
    if _file is not None:
        _file.write(text.rstrip("\n") + "\n")


def log_tee(text: str, level: str = "info") -> None:
    """File + stderr log line (LOG_TEE macro semantics)."""
    if _callback is not None:
        _callback(level, text)
        return
    print(text, file=sys.stderr)
    if not _disabled and _file is not None:
        _file.write(text.rstrip("\n") + "\n")


def add_args(parser) -> None:
    """Reference log CLI surface (common/log.h log_param_* parsing)."""
    g = parser.add_argument_group("logging")
    g.add_argument("--log-file", default=None, metavar="FILE",
                   help="write a debug log to FILE "
                        "(default name: <prog>.<pid>.log with --log-enable)")
    g.add_argument("--log-enable", action="store_true",
                   help="enable file logging with the default filename")
    g.add_argument("--log-append", action="store_true",
                   help="append to the log file instead of truncating")
    g.add_argument("--log-disable", action="store_true",
                   help="disable all file logging")
    g.add_argument("--logdir", default=None, metavar="DIR",
                   help="dump a YAML run record (timings + settings) "
                        "into DIR at exit (llama_dump_timing_info_yaml)")


def setup(args, prog: str) -> None:
    """Apply parsed log args for this process."""
    if getattr(args, "log_disable", False):
        disable()
        return
    path = getattr(args, "log_file", None)
    if path is None and getattr(args, "log_enable", False):
        path = default_filename(prog)
    if path:
        open_file(path, append=getattr(args, "log_append", False))


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    if s == "" or any(c in s for c in ":#{}[]&*!|>'\"%@`\n"):
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return s


def dump_yaml(logdir: str, prog: str, record: dict) -> str:
    """Write a YAML run record; returns the file path.

    Mirrors main.cpp's --logdir dumps: one timestamped file per run with
    flat scalar keys (timings, settings, results)."""
    os.makedirs(logdir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    path = os.path.join(logdir, f"{prog}-{stamp}-{os.getpid()}.yml")
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"# {prog} run record\n")
        for k, v in record.items():
            if isinstance(v, (list, tuple)):
                f.write(f"{k}:\n")
                for item in v:
                    f.write(f"  - {_yaml_scalar(item)}\n")
            else:
                f.write(f"{k}: {_yaml_scalar(v)}\n")
    return path


def timings_record(timings) -> dict:
    """Engine Timings -> flat dict for dump_yaml
    (llama_dump_timing_info_yaml field parity)."""
    t = timings
    return {
        "t_load_ms": round(t.t_load * 1e3, 3),
        "t_sample_ms": round(t.t_sample * 1e3, 3),
        "n_sample": t.n_sample,
        "t_prompt_eval_ms": round(t.t_prefill * 1e3, 3),
        "n_prompt_eval": t.n_prefill,
        "t_eval_ms": round(t.t_eval * 1e3, 3),
        "n_eval": t.n_eval,
        "prompt_tokens_per_s": round(
            t.n_prefill / max(t.t_prefill, 1e-9), 3) if t.n_prefill else 0.0,
        "eval_tokens_per_s": round(
            t.n_eval / max(t.t_eval, 1e-9), 3) if t.n_eval else 0.0,
    }
