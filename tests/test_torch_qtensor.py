"""Port parity: tpulamm_torch.ops.qtensor against tpulamm.ops.qtensor.

The same GGUF bytes (quantized from a seeded numpy draw) go through both
packages' repack and dequant; the results must be bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulamm.gguf.constants import GGMLType
from tpulamm.ops import qtensor as jq
from tpulamm.quant import formats
from tpulamm_torch.ops import qtensor as tq

QTYPES = {
    "q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1, "q5_0": GGMLType.Q5_0,
    "q5_1": GGMLType.Q5_1, "q8_0": GGMLType.Q8_0, "q2_k": GGMLType.Q2_K,
}


def _raw(dtype, n, k, seed):
    if dtype == "f32":
        pytest.skip("f32 weights have no quantized planes")
    qtype = QTYPES[dtype]
    w = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    return qtype, formats.quantize(w, qtype)


def test_dequant_mm_exact(dtype):
    n, k = 256, 768                    # three 256-element chunks
    qtype, raw = _raw(dtype, n, k, 11)
    jt = jq.QTensor.from_gguf_raw(raw, qtype, (n, k), layout="mm")
    tt = tq.QTensor.from_gguf_raw(raw, qtype, (n, k), layout="mm")
    assert tt.mm_dims == (n, k)
    for name, plane in jt.planes.items():
        got = tt.planes[name].numpy()
        want = np.asarray(plane)
        if want.dtype == np.uint16:
            got = got.view(np.uint16)
        np.testing.assert_array_equal(got, want, err_msg=name)
    want = np.asarray(jq.dequant_mm(jt, jnp.float32))
    got = tq.dequant_mm(tt, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_dequant_rows_exact(dtype):
    n, k = 64, 512
    qtype, raw = _raw(dtype, n, k, 12)
    jt = jq.QTensor.from_gguf_raw(raw, qtype, (n, k), layout="rows")
    tt = tq.QTensor.from_gguf_raw(raw, qtype, (n, k), layout="rows")
    idx = np.random.default_rng(13).integers(0, n, size=(2, 5))
    want = np.asarray(jq.gather_dequant_rows(jt, jnp.asarray(idx)))
    got = tq.gather_dequant_rows(tt, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_concat_slice_pad_n(dtype):
    """Plane-level N surgery matches the JAX QTensor's and pads with
    columns that dequantize to exact zeros."""
    k = 512
    qtype, raw_a = _raw(dtype, 128, k, 14)
    _, raw_b = _raw(dtype, 256, k, 15)
    ja = jq.QTensor.from_gguf_raw(raw_a, qtype, (128, k))
    jb = jq.QTensor.from_gguf_raw(raw_b, qtype, (256, k))
    ta = tq.QTensor.from_gguf_raw(raw_a, qtype, (128, k))
    tb = tq.QTensor.from_gguf_raw(raw_b, qtype, (256, k))
    jc = jq.QTensor.concat_n([ja, jb]).slice_n(64, 320).pad_n(384)
    tc = tq.QTensor.concat_n([ta, tb]).slice_n(64, 320).pad_n(384)
    assert tc.shape == jc.shape == (384, k)
    got = tq.dequant_mm(tc).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.dequant_mm(jc)))
    assert not got[:, 256:].any()
