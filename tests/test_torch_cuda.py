"""The CUDA kernels on the card: each wrapper against its plain version
for all six formats, its launch count, and what it refuses.

These tests need an NVIDIA GPU (marker `cuda`) and skip without one. The
file imports no JAX, so on a machine with the card it runs without the
JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: qmm within 1e-4 of max|out| (the f32 sums
run in another order), qmm_int8 within 1e-5 with identical activation
codes.
"""

import numpy as np
import pytest
import torch

from chip_smoke import FLASH_CASES, FORMATS, random_blocks
from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import qmm as Q
from tpulamm_torch.ops.qtensor import QTensor

N, K = 1024, 768          # three 256-element chunks along K


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(qtype, m, dev, seed=0):
    rng = np.random.default_rng(seed)
    qt = QTensor.from_gguf_raw(random_blocks(qtype, N, K, rng), qtype,
                               (N, K), device=dev)
    x = torch.from_numpy(rng.normal(size=(m, K)).astype(np.float32)).to(dev)
    return x, qt


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", FORMATS, ids=lambda q: q.name)
@pytest.mark.parametrize("m", [1, 8, 64])
def test_kernels_match_plain(dev, qtype, m):
    x, qt = _case(qtype, m, dev)
    Q.reset_launches()
    assert _rel(Q.qmm_cuda(x, qt), Q.qmm_ref(x, qt)) <= 1e-4
    if m <= Q.INT8_MAX_M:
        qx, sx, _ = Q.quantize_acts_cuda(x, qt.spec.group)
        rq, rs, _ = Q.quantize_acts(x, qt.spec.group)
        assert torch.equal(qx, rq) and torch.equal(sx, rs)
        assert _rel(Q.qmm_int8_cuda(x, qt), Q.qmm_int8_ref(x, qt)) <= 1e-5
    torch.cuda.synchronize()
    assert Q.LAUNCHES == {"qmm": 1, "qmm_int8": int(m <= Q.INT8_MAX_M)}


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, qt = _case(GGMLType.Q4_0, 1, dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        Q.qmm_cuda(x, qt.to("cpu"))
    with pytest.raises(ValueError, match="M <= 16"):
        Q.qmm_int8_cuda(torch.zeros((17, K), device=dev), qt)
    with pytest.raises(ValueError, match="does not match K"):
        Q.qmm_cuda(torch.zeros((1, K + 256), device=dev), qt)


# -- flash attention (csrc/flash_attention.cu) --------------------------------
# Tolerance as in chip_smoke.py phase 3b: |got - ref| <= 2e-2 + 2e-2 |ref|
# (tests/test_flash_attention.py, bf16 operands against the f32 plain
# version); against the plain version on q rounded to bf16, max |got -
# ref| <= 5e-3 max |ref| and rms(got - ref) <= 5e-3 rms(ref); rows with
# qlen = 0 exactly 0.

def _flash_args(case, dev, seed=0):
    from chip_smoke import flash_case
    c = flash_case(np.random.default_rng(seed), dev, **case)
    hd = c["q"].shape[-1]
    kw = dict(scale=float(1.0 / np.sqrt(hd)), g=case["G"], causal=True)
    return c, kw


def _call(fn, c, kw):
    return fn(c["q"], c["k"], c["v"], c["kpos"], c["qbase"], c["qlen"],
              c["ks"], c["vs"], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_kernels_match_plain(dev, case):
    from chip_smoke import flash_err, flash_refs
    from tpulamm_torch.ops import flash_attention as FA
    c, kw = _flash_args(FLASH_CASES[case], dev)
    refs = flash_refs(c, kw)
    FA.reset_launches()
    flash_err(_call(FA.flash_attention, c, kw), refs, c["qlen"])
    flash_err(_call(FA.flash_decode, c, kw), refs, c["qlen"])
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_attention": 1, "flash_decode": 1}


@pytest.mark.cuda
def test_flash_strided_span_view(dev):
    """The span view of a longer cache buffer goes to the kernel as it is
    (no copy) and gives the plain version's result."""
    from chip_smoke import flash_err, flash_refs
    from tpulamm_torch.ops import flash_attention as FA
    c, kw = _flash_args(dict(hd=128, G=1, T=1, S=1025, kind="q8"), dev)
    span = 512
    kpos = c["kpos"][:, :span].clone()
    kpos[:, span - 3:] = -1
    c = dict(c, k=c["k"][:, :, :span], v=c["v"][:, :, :span],
             ks=c["ks"][:, :, :span], vs=c["vs"][:, :, :span], kpos=kpos,
             qbase=c["qbase"] * 0 + span)
    refs = flash_refs(c, kw)
    assert not c["k"].is_contiguous()
    flash_err(_call(FA.flash_decode, c, kw), refs, c["qlen"])
    flash_err(_call(FA.flash_attention, c, kw), refs, c["qlen"])


@pytest.mark.cuda
def test_flash_wrappers_refuse(dev):
    from tpulamm_torch.ops import flash_attention as FA
    c, kw = _flash_args(dict(hd=64, G=1, T=1, S=161), dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        FA.flash_decode(c["q"].cpu(), c["k"], c["v"], c["kpos"], c["qbase"],
                        c["qlen"], **kw)
    q96 = torch.zeros((2, 2, 1, 96), device=dev)
    k96 = torch.zeros((2, 2, 161, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 96"):
        FA.flash_attention(q96, k96, k96, c["kpos"], c["qbase"], c["qlen"],
                           **kw)
