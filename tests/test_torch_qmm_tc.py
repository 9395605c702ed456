"""The numerics of csrc/qmm.cu on the CPU: a torch function that rounds
the operands as the tensor-core kernel does (x split into bf16 x_hi +
x_lo, integer weight codes, Q2_K's sub-scale folded into the code, the
scale applied per 32-K group in f32 after the product, the mins times the
per-group sums of x as one more product of bf16 hi + lo halves) held
against the plain version `qmm_ref` and the
JAX package's `_qmm_call` in f32, interpret mode.

Tolerance: 1e-4 of max|out|, the kernel's contract on the card (each row
on its own where one row spans six decades). One bf16 pass over x misses
it; the split puts the error near 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulamm.gguf.constants import GGMLType
from tpulamm.ops import pallas_qmm
from tpulamm.ops.qtensor import QTensor as JQTensor
from tpulamm.quant import formats
from tpulamm_torch.ops import qmm as tqmm
from tpulamm_torch.ops.qtensor import (QTensor, f16_bits_to_f32,
                                       unpack_mm_values)

QTYPES = {
    "q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1, "q5_0": GGMLType.Q5_0,
    "q5_1": GGMLType.Q5_1, "q8_0": GGMLType.Q8_0, "q2_k": GGMLType.Q2_K,
}
N, K = 256, 768
TOL = 1e-4


def tc_mirror(x: torch.Tensor, qt: QTensor, split: bool = True
              ) -> torch.Tensor:
    """x (M, K) @ dequant(qt) with the kernel's operand rounding; split
    False: one bf16 pass over x (what the kernel does not do)."""
    m, k = x.shape
    n = qt.mm_dims[0]
    spec = qt.spec
    x = x.to(torch.float32)
    xh = x.to(torch.bfloat16).to(torch.float32)
    xl = (x - xh).to(torch.bfloat16).to(torch.float32)
    vals = unpack_mm_values(qt.planes, qt.qtype, k)              # (K, N)
    mins = None
    if qt.qtype == GGMLType.Q2_K:
        scd = qt.planes["scd"].to(torch.int32)                   # (K/16, N)
        dm = f16_bits_to_f32(qt.planes["dm"]).reshape(k // 256, 8, n)
        codes = vals * torch.repeat_interleave(scd & 15, 16, dim=0)
        scale = torch.repeat_interleave(dm[:, 0], 8, dim=0)      # d per 32
        mins = (scd >> 4).to(torch.float32) * -torch.repeat_interleave(
            dm[:, 1], 16, dim=0)                                 # per 16
    else:
        codes = vals - int(spec.zero)
        scale = qt.planes["scales"].to(torch.float32)            # (K/32, N)
        if spec.has_min:
            mins = qt.planes["mins"].to(torch.float32)
    cf = codes.to(torch.float32)
    assert torch.equal(cf.to(torch.bfloat16).to(torch.float32), cf)
    g = k // 32
    c3 = cf.reshape(g, 32, n)

    def part(xp):                                    # (G, M, N) f32 sums
        return torch.bmm(xp.reshape(m, g, 32).transpose(0, 1), c3)
    p = part(xh) + part(xl) if split else part(xh)
    out = (p * scale[:, None, :]).sum(0)
    if mins is not None:
        # one more tensor-core product: sums and mins split into bf16 hi +
        # lo (the mins exactly), hi.hi + lo.hi + hi.lo
        gw = spec.group
        gsum = x.reshape(m, k // gw, gw).sum(-1)                 # (M, K/gw)
        gh, gl = _split(gsum)
        mh, ml = _split(mins)
        assert torch.equal(mh + ml, mins)
        out = out + (gh @ mh + gl @ mh + gh @ ml)
    return out


def _split(v):
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi, (v - hi).to(torch.bfloat16).to(torch.float32)


def _weights(name, seed=0):
    qtype = QTYPES[name]
    rng = np.random.default_rng(seed)
    raw = formats.quantize((rng.normal(size=(N, K)) * 0.7).astype(np.float32),
                           qtype)
    return (JQTensor.from_gguf_raw(raw, qtype, (N, K)),
            QTensor.from_gguf_raw(raw, qtype, (N, K)))


def _x(m, seed, wide_row=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, K)).astype(np.float32)
    if wide_row is not None:                   # ~1e-3 with outliers ~1e3
        x[wide_row] = rng.normal(size=K) * 1e-3
        hot = rng.choice(K, size=8, replace=False)
        x[wide_row, hot] = rng.choice([-1e3, 1e3], size=8)
    return x


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pallas(jt, x):
    return np.asarray(pallas_qmm._qmm_call(
        jnp.asarray(x), jt.planes, qtype=jt.qtype, n=N, k=K, tn=128, kc=2,
        compute_dtype=jnp.dtype(jnp.float32), interpret=True))[:x.shape[0]]


@pytest.mark.parametrize("m", [1, 20, 130])
@pytest.mark.parametrize("name", list(QTYPES))
def test_tc_numerics_match_ref_and_pallas(name, m):
    jt, tt = _weights(name, seed=m)
    x = _x(m, seed=100 + m)
    got = tc_mirror(torch.from_numpy(x), tt).numpy()
    assert np.isfinite(got).all() and got.shape == (m, N)
    assert _rel(got, tqmm.qmm_ref(torch.from_numpy(x), tt).numpy()) <= TOL
    assert _rel(got, _pallas(jt, x)) <= TOL


@pytest.mark.parametrize("name", list(QTYPES))
def test_tc_numerics_wide_range_row(name):
    """Row 2 holds values ~1e-3 and outliers ~1e3: every row stays within
    1e-4 of its own max|out| (the split keeps 16 bits of each element)."""
    jt, tt = _weights(name, seed=7)
    x = _x(5, seed=8, wide_row=2)
    got = tc_mirror(torch.from_numpy(x), tt).numpy()
    ref = tqmm.qmm_ref(torch.from_numpy(x), tt).numpy()
    for r in range(x.shape[0]):
        assert _rel(got[r], ref[r]) <= TOL, r
    assert _rel(got, _pallas(jt, x)) <= TOL


def test_one_bf16_pass_misses_the_contract():
    """Why the kernel runs two passes: x rounded once to bf16 leaves
    ~2^-9 of each product, well past 1e-4 of max|out|."""
    _, tt = _weights("q4_0", seed=3)
    x = torch.from_numpy(_x(64, seed=4))
    ref = tqmm.qmm_ref(x, tt).numpy()
    assert _rel(tc_mirror(x, tt, split=False).numpy(), ref) > 10 * TOL
    assert _rel(tc_mirror(x, tt).numpy(), ref) <= TOL / 10
