"""GGUF inspection CLI — role of the reference's examples/gguf +
gguf-py/scripts/gguf-dump.py: print header, KV metadata and tensor infos
(counterpart of tpulamm.cli.gguf_dump).

    python -m tpulamm_torch.cli.gguf_dump MODEL.gguf [--no-tensors] [--json]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-gguf-dump")
    p.add_argument("model")
    p.add_argument("--no-tensors", action="store_true")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model, "model")

    from tpulamm_torch.gguf.reader import GGUFReader
    r = GGUFReader(args.model)

    if args.json:
        import json

        def jval(v):
            if isinstance(v, np.ndarray):
                return v[:16].tolist() + (["..."] if v.size > 16 else [])
            if isinstance(v, list) and len(v) > 16:
                return v[:16] + ["..."]
            return v
        out = {
            "version": r.version,
            "alignment": r.alignment,
            "metadata": {k: jval(v) for k, v in r.metadata.items()},
        }
        if not args.no_tensors:
            out["tensors"] = [
                {"name": t.name, "shape": list(t.shape),
                 "type": t.ggml_type.name, "offset": t.offset,
                 "bytes": t.n_bytes}
                for t in r.tensors.values()]
        print(json.dumps(out, indent=1, default=str))
        return 0

    print(f"GGUF v{r.version}, alignment {r.alignment}, "
          f"{len(r.metadata)} KV pairs, {len(r.tensors)} tensors")
    print("\n* metadata")
    for k, v in r.metadata.items():
        if isinstance(v, np.ndarray):
            v = f"array[{v.dtype}, {v.size}] {v[:6].tolist()}..."
        elif isinstance(v, list) and len(v) > 6:
            v = f"list[{len(v)}] {v[:6]}..."
        elif isinstance(v, str) and len(v) > 80:
            v = v[:77] + "..."
        print(f"  {k:48s} = {v}")
    if not args.no_tensors:
        print("\n* tensors")
        total = 0
        for t in r.tensors.values():
            total += t.n_bytes
            print(f"  {t.name:48s} {str(tuple(t.shape)):>20s} "
                  f"{t.ggml_type.name:6s} {t.n_bytes / 1e6:10.2f} MB")
        print(f"  total data: {total / 1e6:.2f} MB")
    r.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
