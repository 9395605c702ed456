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

from chip_smoke import FORMATS, random_blocks
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
