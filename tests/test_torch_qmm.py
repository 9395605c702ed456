"""Port parity: the plain versions in tpulamm_torch.ops.qmm against the
JAX package's Pallas kernels run in interpret mode (the CUDA kernels
against the plain versions: tests/test_torch_cuda.py).

Tolerances: 1e-5 of max|out| -- both sides dequantize to identical f32
weights (see test_torch_qtensor) and differ only in the order of f32
sums; the int8 activation codes must be identical.
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
from tpulamm_torch.ops.qtensor import QTensor

QTYPES = {
    "q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1, "q5_0": GGMLType.Q5_0,
    "q5_1": GGMLType.Q5_1, "q8_0": GGMLType.Q8_0, "q2_k": GGMLType.Q2_K,
}
N, K = 256, 768          # 3 chunks of 256: a tail chunk at kc = 2


def _pair(dtype, n=N, k=K, seed=0):
    if dtype == "f32":
        pytest.skip("f32 weights have no quantized planes")
    qtype = QTYPES[dtype]
    rng = np.random.default_rng(seed)
    raw = formats.quantize((rng.normal(size=(n, k)) * 0.7).astype(np.float32),
                           qtype)
    return (JQTensor.from_gguf_raw(raw, qtype, (n, k)),
            QTensor.from_gguf_raw(raw, qtype, (n, k)))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_qmm_ref_matches_pallas(dtype):
    jt, tt = _pair(dtype)
    x = np.random.default_rng(1).normal(size=(20, K)).astype(np.float32)
    want = np.asarray(pallas_qmm._qmm_call(
        jnp.asarray(x), jt.planes, qtype=jt.qtype, n=N, k=K, tn=128, kc=2,
        compute_dtype=jnp.dtype(jnp.float32), interpret=True))[:20]
    got = tqmm.qmm_ref(torch.from_numpy(x), tt).numpy()
    assert _rel(got, want) <= 1e-5


def test_qmm_int8_ref_matches_pallas(dtype):
    jt, tt = _pair(dtype, seed=2)
    x = np.random.default_rng(3).normal(size=(3, K)).astype(np.float32)
    x[1, :40] = 0.0                    # an all-zero group: scale 1
    group = tt.spec.group
    qxT, sxT, gsT = pallas_qmm._quantize_acts(jnp.asarray(x), group)
    qx, sx, gsum = tqmm.quantize_acts(torch.from_numpy(x), group)
    np.testing.assert_array_equal(
        qx.numpy().reshape(3, -1, group), np.asarray(qxT).transpose(1, 0, 2))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sxT).T)
    np.testing.assert_allclose(gsum.numpy(), np.asarray(gsT).T, rtol=1e-6,
                               atol=1e-6)
    want = np.asarray(pallas_qmm._qmm_int8_call(
        jnp.asarray(x), jt.planes, qtype=jt.qtype, n=N, k=K, tn=128, kc=2,
        interpret=True))[:3]
    got = tqmm.qmm_int8_ref(torch.from_numpy(x), tt).numpy()
    assert _rel(got, want) <= 1e-5


def test_qmm_int8_inkq_ref_matches_pallas(dtype):
    """The in-kernel quantization (_make_int8_kernel_inkq's quant body, on
    x transposed) gives quantize_acts' codes and scales; the plain version
    is qmm_int8_ref's function and matches _qmm_int8_call_inkq."""
    jt, tt = _pair(dtype, seed=6)
    x = np.random.default_rng(7).normal(size=(3, K)).astype(np.float32)
    x[2, 64:96] = 0.0                  # an all-zero group: scale 1
    gw = tt.spec.group
    xb = jnp.asarray(x).T.reshape(K // gw, gw, 3)          # (G, gw, m)
    s = jnp.max(jnp.abs(xb), axis=1, keepdims=True) * jnp.float32(1 / 127)
    s = jnp.where(s > 0, s, jnp.float32(1.0))
    q = jnp.clip(jnp.round(xb / s), -127, 127).astype(jnp.int8)
    qx, sx, _ = tqmm.quantize_acts(torch.from_numpy(x), gw)
    np.testing.assert_array_equal(
        qx.numpy(), np.asarray(q).transpose(2, 0, 1).reshape(3, K))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(s)[:, 0, :].T)
    want = np.asarray(pallas_qmm._qmm_int8_call_inkq(
        jnp.asarray(x), jt.planes, qtype=jt.qtype, n=N, k=K, tn=128, kc=2,
        interpret=True))[:3]
    got = tqmm.qmm_int8_inkq_ref(torch.from_numpy(x), tt)
    assert torch.equal(got, tqmm.qmm_int8_ref(torch.from_numpy(x), tt))
    assert _rel(got.numpy(), want) <= 1e-5


def test_wrappers_take_plain_version_on_cpu():
    """On a CPU tensor each wrapper returns its plain version and counts
    no launch."""
    _, tt = _pair("q4_0", seed=4)
    x = torch.from_numpy(
        np.random.default_rng(5).normal(size=(2, K)).astype(np.float32))
    tqmm.reset_launches()
    torch.testing.assert_close(tqmm.qmm_cuda(x, tt), tqmm.qmm_ref(x, tt),
                               rtol=0, atol=0)
    torch.testing.assert_close(tqmm.qmm_int8_cuda(x, tt),
                               tqmm.qmm_int8_ref(x, tt), rtol=0, atol=0)
    torch.testing.assert_close(tqmm.qmm_int8_inkq_cuda(x, tt),
                               tqmm.qmm_int8_ref(x, tt), rtol=0, atol=0)
    assert tqmm.LAUNCHES == {"qmm": 0, "qmm_int8": 0, "qmm_int8_inkq": 0}


def test_library_name_follows_its_headers(tmp_path, monkeypatch):
    """A library is named by a hash of its source and every csrc header it
    includes (through other headers too), so an edited header rebuilds it."""
    import shutil
    from tpulamm_torch.ops import kernels
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    assert [p.name for p in kernels.sources("mega_decode")] == [
        "mega_decode.cu", "gemv_tc.cuh", "gemv_stage.cuh", "quant_planes.cuh"]
    before = {n: kernels.lib_path(n) for n in kernels.LIBS}
    with open(csrc / "quant_planes.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: kernels.lib_path(n) for n in kernels.LIBS}
    changed = {n for n in kernels.LIBS if before[n] != after[n]}
    assert changed == {"qmm", "qmm_int8", "ffn_fused", "mega_decode"}


@pytest.mark.parametrize("m,n,cdt,want", [
    (1, 4096, torch.bfloat16, True),      # decode gemv
    (16, 12288, torch.bfloat16, True),    # 16 is still the gemv regime
    (17, 4096, torch.bfloat16, False),    # prefill
    (1, 4096, torch.float32, False),      # explicit f32 opts out
    (1, 22016, torch.bfloat16, True),     # 43 * 512: divisor tile 5504
    (1, 32768, torch.bfloat16, True),     # padded lm head
    (1, 768, torch.bfloat16, False),      # no divisor tile >= 1024
])
def test_path_choice(m, n, cdt, want):
    """qmm_pallas's int8/f32 choice (pallas_qmm.py:648-763)."""
    assert tqmm.use_int8(m, n, cdt) is want


@pytest.mark.parametrize("m,n,k,want", [
    (512, 4096, 4096, 1),      # 4 x 32 output tiles nearly fill 132 SMs
    (512, 22016, 4096, 1),
    (128, 4096, 11008, 4),     # the reference shape: 32 tiles
    (1, 384, 768, 3),          # capped at 4 stages of 64 K a range
    (1, 384, 256, 1),
])
def test_qmm_splits(m, n, k, want):
    """qmm.cu's K ranges on a 132-SM card, and the workspace they need."""
    assert tqmm.qmm_splits(m, n, k, 132) == want
    mpad = -(-m // 128) * 128
    extra = want * m * n * 4 if want > 1 else 0
    assert tqmm.qmm_ws_bytes(m, n, k, want) == (mpad * k * 4
                                                + mpad * k // 2 + extra)

