"""Port parity: tpulamm_torch.ops.ffn_fused's plain version and dispatch
guard against the JAX package's fused-FFN kernel (interpret mode) and its
guard, on the same planes made with numpy from a seed (the CUDA kernel
against the plain version: tests/test_torch_cuda.py).

Tolerance: 1e-5 of max|out|. Both sides dequantize to identical f32
weights and keep the intermediate f32; only the order of the f32 sums
differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.ops import pallas_ffn
from tpulamm.ops.qtensor import QTensor as JQTensor
from tpulamm.quant import formats
from tpulamm_torch.ops import ffn_fused as F
from tpulamm_torch.ops.qtensor import QTensor

QTYPES = {
    "q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1, "q5_0": GGMLType.Q5_0,
    "q5_1": GGMLType.Q5_1, "q8_0": GGMLType.Q8_0, "q2_k": GGMLType.Q2_K,
}
DIM, FFN = 256, 512


def _pair(qtype, n, k, rng):
    raw = formats.quantize((rng.normal(size=(n, k)) * 0.1).astype(np.float32),
                           qtype)
    return (JQTensor.from_gguf_raw(raw, qtype, (n, k)),
            QTensor.from_gguf_raw(raw, qtype, (n, k)))


def _ffn_pair(dtype, seed=0):
    if dtype == "f32":
        pytest.skip("f32 weights have no quantized planes")
    rng = np.random.default_rng(seed)
    qtype = QTYPES[dtype]
    (jgu, tgu), (jdn, tdn) = (_pair(qtype, 2 * FFN, DIM, rng),
                              _pair(qtype, DIM, FFN, rng))
    return jgu, jdn, tgu, tdn, rng


def test_ffn_fused_ref_matches_pallas(dtype):
    jgu, jdn, tgu, tdn, rng = _ffn_pair(dtype)
    for m, act in ((1, "silu"), (7, "gelu"), (16, "silu")):
        x = rng.normal(size=(m, DIM)).astype(np.float32)
        want = np.asarray(pallas_ffn.ffn_fused(jnp.asarray(x), jgu, jdn,
                                               act=act, interpret=True))
        got = F.ffn_fused_ref(torch.from_numpy(x), tgu, tdn, act=act).numpy()
        assert got.shape == want.shape == (m, DIM)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_wrapper_takes_plain_version_on_cpu():
    _, _, tgu, tdn, rng = _ffn_pair("q4_0", seed=1)
    x = torch.from_numpy(rng.normal(size=(3, DIM)).astype(np.float32))
    F.reset_launches()
    torch.testing.assert_close(F.ffn_fused(x, tgu, tdn),
                               F.ffn_fused_ref(x, tgu, tdn), rtol=0, atol=0)
    assert F.LAUNCHES == {"ffn_fused": 0}
    with pytest.raises(ValueError, match="M <= 16"):
        F.ffn_fused(torch.zeros((17, DIM)), tgu, tdn)


@pytest.mark.parametrize("m,layout", [(1, "mm"), (16, "mm"), (17, "mm"),
                                      (1, "rows"), (1, "dense")])
def test_eligibility_matches_jax(m, layout):
    """ffn_fused_eligible decides as pallas_ffn.ffn_fused_eligible does:
    decode-size batches of mm-layout QTensors only."""
    rng = np.random.default_rng(2)
    qtype = GGMLType.Q4_0
    (jgu, tgu), (jdn, tdn) = (_pair(qtype, 2 * FFN, DIM, rng),
                              _pair(qtype, DIM, FFN, rng))
    if layout == "rows":
        raw = formats.quantize(rng.normal(size=(DIM, FFN)).astype(np.float32),
                               qtype)
        jdn = JQTensor.from_gguf_raw(raw, qtype, (DIM, FFN), layout="rows")
        tdn = QTensor.from_gguf_raw(raw, qtype, (DIM, FFN), layout="rows")
    elif layout == "dense":
        jdn, tdn = jnp.zeros((DIM, FFN)), torch.zeros((DIM, FFN))
    want = pallas_ffn.ffn_fused_eligible(jgu, jdn, m)
    assert F.ffn_fused_eligible(tgu, tdn, m) is want
    assert want is (layout == "mm" and m <= 16)


def test_opt_in_flags_change_nothing_on_cpu(tmp_path):
    """fused_ffn and int8_inkq act on CUDA only (as their JAX switches act
    on the TPU only): on the CPU the engine's logits are unchanged."""
    from tpulamm_torch.runtime.engine import Engine
    path = write_tiny_llama(str(tmp_path / "q4.gguf"), GGMLType.Q4_0, seed=5)
    base = Engine(path, n_ctx=64, device="cpu")
    opt = Engine(path, n_ctx=64, device="cpu", fused_ffn=True,
                 int8_inkq=True)
    assert opt.cfg.fused_ffn and opt.cfg.int8_inkq and opt.mega is None
    toks = list(range(3, 20))
    np.testing.assert_array_equal(base.prefill(0, toks), opt.prefill(0, toks))
    np.testing.assert_array_equal(base.decode_one(0, 7), opt.decode_one(0, 7))
