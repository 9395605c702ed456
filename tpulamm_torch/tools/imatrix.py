"""Importance-matrix files for the quantizer (counterpart of
tpulamm.tools.imatrix, its reading half).

An imatrix file is an .npz holding, for each weight tensor, the sum over
calibration tokens of the square of every matmul input column
(`sum::<tensor name>`) and the number of tokens (`count::<tensor name>`).
`cli.quantize --imatrix` reads one written by either package for weighted
rounding (quant.weighted). Collecting one (the JAX package's
`collect_imatrix`, an instrumented forward) comes with the training path,
ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import numpy as np


def load_imatrix(path: str) -> dict[str, np.ndarray]:
    """name -> per-column mean square activation (the quantizer's qw)."""
    z = np.load(path)
    out = {}
    for key in z.files:
        if key.startswith("sum::"):
            name = key[5:]
            cnt = int(z[f"count::{name}"])
            out[name] = z[key] / max(cnt, 1)
    return out
