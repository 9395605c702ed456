"""The numerics of csrc/ffn_fused.cu on the CPU: a torch function that
rounds the operands as the tensor-core kernel does (x, and then mid, split
into bf16 hi + lo; integer weight codes minus the zero point; each group's
dot in f32, multiplied by its f32 scale; the mins times the f32 sums of x
over the group) held against the plain version `ffn_fused_ref` and the
JAX package's `pallas_ffn.ffn_fused` in interpret mode.

Tolerance: 1e-4 of max|out|, the kernel's contract on the card. One bf16
pass over x and mid misses it; the split puts the error near 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulamm.gguf.constants import GGMLType
from tpulamm.ops import pallas_ffn
from tpulamm.ops.qtensor import QTensor as JQTensor
from tpulamm.quant import formats
from tpulamm_torch.ops import ffn_fused as F
from tpulamm_torch.ops.qtensor import (QTensor, f16_bits_to_f32,
                                       unpack_mm_values)

QTYPES = {
    "q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1, "q5_0": GGMLType.Q5_0,
    "q5_1": GGMLType.Q5_1, "q8_0": GGMLType.Q8_0, "q2_k": GGMLType.Q2_K,
}
DIM, FFN = 256, 512
TOL = 1e-4


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def tc_product(x: torch.Tensor, qt: QTensor, split: bool = True
               ) -> torch.Tensor:
    """x (M, K) @ dequant(qt) as the kernel rounds it: per group of G
    elements (32; Q2_K 16) the f32 dot of the codes with x's bf16 hi and
    (split) lo halves, times the group's f32 scale, plus min * the f32 sum
    of x over the group; the groups' terms added in f32."""
    m, k = x.shape
    n = qt.mm_dims[0]
    spec = qt.spec
    x = x.to(torch.float32)
    vals = unpack_mm_values(qt.planes, qt.qtype, k)              # (K, N)
    mins = None
    if qt.qtype == GGMLType.Q2_K:
        gsz = 16
        scd = qt.planes["scd"].to(torch.int32)                   # (K/16, N)
        dm = f16_bits_to_f32(qt.planes["dm"]).reshape(k // 256, 8, n)
        d = torch.repeat_interleave(dm[:, 0], 16, dim=0)
        dmin = torch.repeat_interleave(dm[:, 1], 16, dim=0)
        codes = vals
        scale = (scd & 15).to(torch.float32) * d
        mins = (scd >> 4).to(torch.float32) * -dmin
    else:
        gsz = 32
        codes = vals - int(spec.zero)
        scale = qt.planes["scales"].to(torch.float32)            # (K/32, N)
        if spec.has_min:
            mins = qt.planes["mins"].to(torch.float32)
    cf = codes.to(torch.float32)
    assert torch.equal(_bf16(cf), cf)                 # exact in bf16
    g = k // gsz
    c3 = cf.reshape(g, gsz, n)

    def part(xp):                                    # (G, M, N) f32 dots
        return torch.bmm(xp.reshape(m, g, gsz).transpose(0, 1), c3)
    xh = _bf16(x)
    dots = part(xh) + part(_bf16(x - xh)) if split else part(xh)
    terms = dots * scale[:, None, :]
    if mins is not None:
        gsum = x.reshape(m, g, gsz).sum(-1).transpose(0, 1)     # (G, M)
        terms = terms + gsum[:, :, None] * mins[:, None, :]
    return terms.sum(0)


def tc_mirror(x: torch.Tensor, gu: QTensor, dn: QTensor, act: str = "silu",
              split: bool = True) -> torch.Tensor:
    """The fused FFN as the kernel rounds it: mid = act(gate) * up in f32,
    then the down product over mid."""
    ffn = dn.mm_dims[1]
    g = tc_product(x, gu, split)
    mid = F._act_fn(g[:, :ffn], act) * g[:, ffn:]
    return tc_product(mid, dn, split)


def _pair(qtype, n, k, rng):
    raw = formats.quantize((rng.normal(size=(n, k)) * 0.1).astype(np.float32),
                           qtype)
    return (JQTensor.from_gguf_raw(raw, qtype, (n, k)),
            QTensor.from_gguf_raw(raw, qtype, (n, k)))


def _weights(name, seed):
    rng = np.random.default_rng(seed)
    qtype = QTYPES[name]
    (jgu, tgu), (jdn, tdn) = (_pair(qtype, 2 * FFN, DIM, rng),
                              _pair(qtype, DIM, FFN, rng))
    return jgu, jdn, tgu, tdn, rng


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("m,act", [(1, "silu"), (7, "gelu"), (16, "silu")])
@pytest.mark.parametrize("name", list(QTYPES))
def test_tc_numerics_match_ref_and_pallas(name, m, act):
    jgu, jdn, tgu, tdn, rng = _weights(name, seed=m)
    x = rng.normal(size=(m, DIM)).astype(np.float32)
    got = tc_mirror(torch.from_numpy(x), tgu, tdn, act).numpy()
    assert got.shape == (m, DIM) and np.isfinite(got).all()
    ref = F.ffn_fused_ref(torch.from_numpy(x), tgu, tdn, act=act).numpy()
    assert _rel(got, ref) <= TOL
    want = np.asarray(pallas_ffn.ffn_fused(jnp.asarray(x), jgu, jdn, act=act,
                                           interpret=True))
    assert _rel(got, want) <= TOL


def test_one_bf16_pass_misses_the_contract():
    """Why the kernel splits x and mid: rounded once to bf16 they leave
    ~2^-9 of each product, well past 1e-4 of max|out|."""
    _, _, tgu, tdn, rng = _weights("q4_0", seed=3)
    x = torch.from_numpy(rng.normal(size=(16, DIM)).astype(np.float32))
    ref = F.ffn_fused_ref(x, tgu, tdn).numpy()
    assert _rel(tc_mirror(x, tgu, tdn, split=False).numpy(), ref) > 10 * TOL
    assert _rel(tc_mirror(x, tgu, tdn).numpy(), ref) <= TOL / 10
