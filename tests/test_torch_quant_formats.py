"""The port's quantizers against the JAX package's numpy quantizers, byte for
byte: its own numpy copies (tpulamm_torch.quant.formats, the plain
versions) and its host codec (quant.native, csrc/tl_codec.cpp, what
`formats.quantize` / `dequantize` run), in all ten types, on seeded rows
and on edge blocks. The dequantizers (eleven, BF16 included) and the
importance-weighted quantizers are held to the JAX ones the same way:
every comparison is exact (no tolerance)."""

import numpy as np
import pytest

from tpulamm.gguf.constants import GGMLType as JT
from tpulamm.quant import formats as J
from tpulamm.quant import weighted as JW
from tpulamm_torch.gguf.constants import GGMLType as PT
from tpulamm_torch.quant import formats as P
from tpulamm_torch.quant import native
from tpulamm_torch.quant import weighted as PW

TYPES = [t.name for t in J.QUANTIZERS]
BLOCK_TYPES = [t.name for t in native.CODEC_TYPES]


def _qk(name: str) -> int:
    return 256 if name in ("Q2_K", "Q8_K") else 32


def _rows(seed: int, k: int = 512) -> np.ndarray:
    """Seeded rows at several scales, with constant and one-hot rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(12, k)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-4, 3, size=(12, 1)).astype(np.float32)
    x[3] = np.float32(0.25)
    x[4] = 0
    x[4, 7] = -3.0
    x[5] = np.abs(x[5])                     # all positive: Q4_1 min > 0
    return x


def _edge_rows(name: str) -> np.ndarray:
    """Blocks that decide rounding: all zeros, exact .5 ties, a negative
    absmax, tiny (fp16 subnormal scales and below) and huge values."""
    qk = _qk(name)
    k = 2 * qk
    rows = [np.zeros(k, np.float32)]
    tie = np.zeros(k, np.float32)           # amax 127 -> d = 1: x.5 ties
    tie[0] = 127.0
    tie[1:9] = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -126.5]
    tie[qk] = -127.0
    tie[qk + 1:qk + 5] = [3.5, -3.5, 4.5, -4.5]
    rows.append(tie)
    neg = np.linspace(-1, 0.5, k, dtype=np.float32)   # the absmax is < 0
    rows.append(neg)
    step = np.zeros(k, np.float32)          # -8 .. 7 on the Q4 grid
    step[:16] = np.arange(-8, 8, dtype=np.float32)
    step[qk:qk + 32] = np.arange(-16, 16, dtype=np.float32)
    rows.append(step)
    rng = np.random.default_rng(7)
    for scale in (1e-5, 1e-7, 1e-9, 3e4):
        rows.append((rng.normal(size=k) * scale).astype(np.float32))
    return np.stack(rows)


CASES = ["seed0", "seed1", "grid", "edges"]


def _case(name: str, case: str) -> np.ndarray:
    if case == "edges":
        return _edge_rows(name)
    if case == "grid":      # values on a quarter grid: many rounding ties
        return np.round(_rows(2, 1024) * 4) / 4 + np.float32(0.0)
    return _rows(int(case[-1]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", TYPES)
def test_numpy_quantizer_bytes(name, case):
    x = _case(name, case)
    want = J.QUANTIZERS[JT[name]](x)
    got = P.QUANTIZERS[PT[name]](x)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", TYPES)
def test_quantize_bytes(name, case):
    """formats.quantize: the codec for the block types, numpy for F32/F16."""
    x = _case(name, case)
    want = J.QUANTIZERS[JT[name]](x)
    assert np.array_equal(P.quantize(x, PT[name]), want)
    if name in BLOCK_TYPES:
        assert np.array_equal(native.quantize(x, PT[name]), want)


def _raw(name: str, rng, n: int = 6, k: int = 512) -> np.ndarray:
    if name == "BF16":
        return np.frombuffer(rng.bytes(n * k * 2), np.uint8).reshape(n, -1)
    return J.QUANTIZERS[JT[name]](_rows(int(rng.integers(1 << 30)), k)[:n])


@pytest.mark.parametrize("name", [t.name for t in J.DEQUANTIZERS])
def test_dequantizers(name):
    rng = np.random.default_rng(3)
    k = 512
    for raw in (_raw(name, rng), _raw(name, rng)):
        want = J.DEQUANTIZERS[JT[name]](raw, k)
        for got in (P.DEQUANTIZERS[PT[name]](raw, k),
                    P.dequantize(raw, PT[name], k)):
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_codec_dequantize_round_trip(name):
    """Edge blocks through the codec both ways, against the JAX numpy
    decode of the JAX numpy bytes; leading axes are kept."""
    x = _edge_rows(name)
    raw = native.quantize(x[None], PT[name])
    assert raw.shape[:2] == (1, x.shape[0])
    want = J.DEQUANTIZERS[JT[name]](J.QUANTIZERS[JT[name]](x), x.shape[-1])
    got = native.dequantize(raw, PT[name], x.shape[-1])
    assert got.shape == (1, *x.shape)
    assert np.array_equal(got[0].view(np.uint32), want.view(np.uint32))


def test_signed_zero_blocks():
    """A block of +0 and -0: numpy's min / max pick a zero's sign by the
    order of their SIMD reduction, the codec keeps the first; the bytes
    differ at most in the sign bit of a zero fp16 scale or min, and every
    value decodes to zero either way."""
    x = np.zeros((4, 256), np.float32)
    x[:, 1::3] = -0.0
    for name in BLOCK_TYPES:
        want = J.QUANTIZERS[JT[name]](x)
        got = native.quantize(x, PT[name])
        assert np.all((got == want) | ((got ^ want) == 0x80)), name
        y = native.dequantize(got, PT[name], x.shape[-1])
        assert np.array_equal(y, J.DEQUANTIZERS[JT[name]](want, 256))
        assert not y.any()


def test_codec_refuses():
    x = np.ones((2, 64), np.float32)
    with pytest.raises(ValueError, match="multiple of 256"):
        native.quantize(x, PT.Q2_K)
    with pytest.raises(ValueError, match="no"):
        native.quantize(x, PT.F16)
    with pytest.raises(ValueError, match="unsupported"):
        P.quantize(x, PT.BF16)
    with pytest.raises(ValueError, match="unsupported"):
        P.dequantize(np.zeros((1, 8), np.uint8), PT.I8, 8)


def test_codec_build_failure_raises_with_compiler_message(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "tl_codec.cpp"
    bad.write_text("int broken(\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("name", ["Q4_0", "Q5_0", "Q4_1", "Q8_0", "Q2_K"])
def test_quantize_weighted(name):
    x = _rows(5)
    x[0] = 0                                     # an all-zero row
    qw = np.random.default_rng(9).uniform(0.1, 4.0, size=x.shape[-1])
    qw = qw.astype(np.float32)
    for w in (qw, None):
        if w is not None and name in ("Q4_0", "Q5_0"):
            want = JW.quantize_weighted(x, JT[name], w)
        else:                       # plain rounding: the numpy quantizer
            want = J.QUANTIZERS[JT[name]](x)
        assert np.array_equal(PW.quantize_weighted(x, PT[name], w), want)


def test_make_qx_quants_and_row_bytes():
    xb = _rows(6).reshape(-1, 16, 32)
    w = np.abs(xb) + np.float32(0.5)
    for nmax in (8, 16):
        ds, ls = JW.make_qx_quants(xb, nmax, w)
        dp, lp = PW.make_qx_quants(xb, nmax, w)
        assert np.array_equal(dp, ds) and np.array_equal(lp, ls)
    for name in TYPES:
        k = 4 * _qk(name) * 2
        assert P.row_bytes(PT[name], k) == J.row_bytes(JT[name], k)
    assert [t.name for t in P.WEIGHT_TYPES] == [t.name for t in J.WEIGHT_TYPES]
