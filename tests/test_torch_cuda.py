"""The CUDA kernels on the card: each wrapper against its plain version
for all six formats, its launch count, and what it refuses.

These tests need an NVIDIA GPU (marker `cuda`) and skip without one. The
file imports no JAX, so on a machine with the card it runs without the
JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: qmm within 1e-4 of max|out| (its tensor
cores see x as two bf16 halves, ~2^-17 of each element left), the same
bits on a second call, qmm_int8 within 1e-5 with identical activation
codes, qmm_int8_inkq bit-identical to qmm_int8, ffn_fused within 1e-4,
mega_decode within 1e-2 of max|ref| (bf16 rounding flips of the residual
stream from the f32 sum order).
"""

import numpy as np
import pytest
import torch

from chip_smoke import FLASH_CASES, FORMATS, mega_call, mega_case, random_blocks
from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import ffn_fused as FF
from tpulamm_torch.ops import mega_decode as MD
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
    got = Q.qmm_cuda(x, qt)
    assert _rel(got, Q.qmm_ref(x, qt)) <= 1e-4
    assert torch.equal(got, Q.qmm_cuda(x, qt))            # fixed order
    if m <= Q.INT8_MAX_M:
        qx, sx, _ = Q.quantize_acts_cuda(x, qt.spec.group)
        rq, rs, _ = Q.quantize_acts(x, qt.spec.group)
        assert torch.equal(qx, rq) and torch.equal(sx, rs)
        assert _rel(Q.qmm_int8_cuda(x, qt), Q.qmm_int8_ref(x, qt)) <= 1e-5
    torch.cuda.synchronize()
    assert Q.LAUNCHES == {"qmm": 2, "qmm_int8": int(m <= Q.INT8_MAX_M),
                          "qmm_int8_inkq": 0}


# qmm.cu at the path's widths: every format at M past and inside a 128-row
# tile, N from the tests' 384 to the fused gate|up 22016 (172 tiles), K of
# one chunk and of the 7B down projection (43 chunks); within 1e-4 of
# max|out| of qmm_ref, the same bits on a second call
QMM_NK = [(384, 256), (384, 11008), (4096, 256), (4096, 11008), (22016, 256),
          (22016, 11008)]
QMM_CASES = [(q, n, k, m) for q in FORMATS for n, k in QMM_NK
             for m in (1, 17, 100, 512, 513)]
_weights: dict = {}


def _planes(qtype, n, k, dev):
    """Random planes of one (format, N, K), kept while the cases use them."""
    key = (qtype, n, k)
    if key not in _weights:
        _weights.clear()
        rng = np.random.default_rng(n + k)
        _weights[key] = QTensor.from_gguf_raw(random_blocks(qtype, n, k, rng),
                                              qtype, (n, k), device=dev)
    return _weights[key]


@pytest.mark.cuda
@pytest.mark.parametrize("qtype,n,k,m", QMM_CASES,
                         ids=[f"{q.name}-N{n}-K{k}-M{m}"
                              for q, n, k, m in QMM_CASES])
def test_qmm_matches_plain_at_path_shapes(dev, qtype, n, k, m):
    qt = _planes(qtype, n, k, dev)
    x = torch.randn((m, k), generator=torch.Generator(dev).manual_seed(m),
                    device=dev)
    got = Q.qmm_cuda(x, qt)
    assert torch.isfinite(got).all()
    assert _rel(got, Q.qmm_ref(x, qt)) <= 1e-4
    assert torch.equal(got, Q.qmm_cuda(x, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", FORMATS, ids=lambda q: q.name)
def test_qmm_wide_range_row(dev, qtype):
    """A row of values ~1e-3 with outliers ~1e3 among N(0, 1) rows: each
    row within 1e-4 of its own max|out| (x_hi + x_lo keep 16 bits of every
    element, whatever its size)."""
    rng = np.random.default_rng(11)
    n, k = 384, 11008
    qt = _planes(qtype, n, k, dev)
    x = rng.normal(size=(17, k)).astype(np.float32)
    x[3] = rng.normal(size=k) * 1e-3
    hot = rng.choice(k, size=k // 100, replace=False)
    x[3, hot] = rng.choice([-1e3, 1e3], size=hot.size) * rng.uniform(
        0.5, 1.5, size=hot.size)
    x = torch.from_numpy(x).to(dev)
    got, want = Q.qmm_cuda(x, qt), Q.qmm_ref(x, qt)
    for r in range(x.shape[0]):
        assert _rel(got[r], want[r]) <= 1e-4, r


# qmm_int8.cu carries 1, 8 or 16 rows a launch: rows past M and inside a
# carrier, each format; activation codes and scales identical to the plain
# quantize_acts, within 1e-5 of max|out| of qmm_int8_ref, the same bits on
# a second call
@pytest.mark.cuda
@pytest.mark.parametrize("qtype", FORMATS, ids=lambda q: q.name)
@pytest.mark.parametrize("m", [2, 8, 9, 16])
def test_qmm_int8_matches_plain_at_batch_rows(dev, qtype, m):
    x, qt = _case(qtype, m, dev, seed=m)
    qx, sx, _ = Q.quantize_acts_cuda(x, qt.spec.group)
    rq, rs, _ = Q.quantize_acts(x, qt.spec.group)
    assert torch.equal(qx, rq) and torch.equal(sx, rs)
    got = Q.qmm_int8_cuda(x, qt)
    assert torch.isfinite(got).all()
    assert _rel(got, Q.qmm_int8_ref(x, qt)) <= 1e-5
    assert torch.equal(got, Q.qmm_int8_cuda(x, qt))


# the 7B down projection (N 4096, K 11008: 43 chunks, a split K)
@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q8_0],
                         ids=lambda q: q.name)
@pytest.mark.parametrize("m", [1, 16])
def test_qmm_int8_at_llama_7b_width(dev, qtype, m):
    qt = _planes(qtype, 4096, 11008, dev)
    x = torch.randn((m, 11008), generator=torch.Generator(dev).manual_seed(m),
                    device=dev)
    qx, sx, _ = Q.quantize_acts_cuda(x, qt.spec.group)
    rq, rs, _ = Q.quantize_acts(x, qt.spec.group)
    assert torch.equal(qx, rq) and torch.equal(sx, rs)
    got = Q.qmm_int8_cuda(x, qt)
    assert _rel(got, Q.qmm_int8_ref(x, qt)) <= 1e-5
    assert torch.equal(got, Q.qmm_int8_cuda(x, qt))
    assert torch.equal(Q.qmm_int8_inkq_cuda(x, qt), got)


# one block taking three units of other K ranges: it stages each window
# anew and is the last of the tile's three partials
@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q2_K],
                         ids=lambda q: q.name)
@pytest.mark.parametrize("m", [1, 9])
def test_qmm_int8_block_with_several_units(dev, qtype, m, monkeypatch):
    x, qt = _case(qtype, m, dev, seed=3)
    monkeypatch.setattr(Q, "int8_plan", lambda *_: (3, 1))
    got = Q.qmm_int8_cuda(x, qt)
    assert _rel(got, Q.qmm_int8_ref(x, qt)) <= 1e-5
    assert torch.equal(Q.qmm_int8_inkq_cuda(x, qt), got)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, qt = _case(GGMLType.Q4_0, 1, dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        Q.qmm_cuda(x, qt.to("cpu"))
    with pytest.raises(ValueError, match="M <= 16"):
        Q.qmm_int8_cuda(torch.zeros((17, K), device=dev), qt)
    with pytest.raises(ValueError, match="does not match K"):
        Q.qmm_cuda(torch.zeros((1, K + 256), device=dev), qt)


@pytest.mark.cuda
def test_qmm_refuses_strided_or_misaligned_planes(dev):
    x, qt = _case(GGMLType.Q4_0, 20, dev)
    qs = qt.planes["qs"]

    def with_qs(plane):
        return QTensor(qtype=qt.qtype, shape=qt.shape, layout=qt.layout,
                       planes={**qt.planes, "qs": plane})
    wide = torch.zeros((qs.shape[0], 2 * qs.shape[1]), dtype=qs.dtype,
                       device=dev)
    wide[:, ::2] = qs
    with pytest.raises(ValueError, match="contiguous"):
        Q.qmm_cuda(x, with_qs(wide[:, ::2]))
    buf = torch.zeros(qs.numel() + 1, dtype=qs.dtype, device=dev)
    shifted = buf[1:].view(qs.shape)
    shifted.copy_(qs)
    with pytest.raises(ValueError, match="16-byte aligned"):
        Q.qmm_cuda(x, with_qs(shifted))
    assert _rel(Q.qmm_cuda(x, with_qs(shifted.clone())),
                Q.qmm_ref(x, qt)) <= 1e-4


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
@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_kernels_same_bits_twice(dev, case):
    """Both kernels sum in a fixed order (no atomics): a second call gives
    the same bits."""
    from tpulamm_torch.ops import flash_attention as FA
    c, kw = _flash_args(FLASH_CASES[case], dev)
    for fn in (FA.flash_attention, FA.flash_decode):
        assert torch.equal(_call(fn, c, kw), _call(fn, c, kw))


@pytest.mark.cuda
@pytest.mark.parametrize("q8_side", ["k", "v"])
@pytest.mark.parametrize("T,S", [(1, 8193), (64, 2049)])
def test_flash_mixed_kv_types(dev, q8_side, T, S):
    """K and V stored apart (Engine kv_dtype_v): one side int8 codes with
    row scales, the other bf16 (the dequantized codes), through both
    kernels."""
    from chip_smoke import flash_err, flash_refs
    from tpulamm_torch.ops import flash_attention as FA
    c, kw = _flash_args(dict(hd=128, G=1, T=T, S=S, Hkv=4, kind="q8",
                             shift=True, empty_row=True), dev)
    other = "v" if q8_side == "k" else "k"
    c[other] = (c[other].to(torch.float32)
                * c[other + "s"][..., None]).to(torch.bfloat16)
    c[other + "s"] = None
    refs = flash_refs(c, kw)
    for fn in (FA.flash_attention, FA.flash_decode):
        flash_err(_call(fn, c, kw), refs, c["qlen"])


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


# -- the opt-in decode kernels (qmm_int8.cu inkq, ffn_fused.cu, mega_decode.cu)

@pytest.mark.cuda
@pytest.mark.parametrize("qtype", FORMATS, ids=lambda q: q.name)
@pytest.mark.parametrize("m", [1, 5, 8, 9, 16])
def test_inkq_is_bit_identical_to_qmm_int8(dev, qtype, m):
    x, qt = _case(qtype, m, dev)
    Q.reset_launches()
    assert torch.equal(Q.qmm_int8_inkq_cuda(x, qt), Q.qmm_int8_cuda(x, qt))
    torch.cuda.synchronize()
    assert Q.LAUNCHES == {"qmm": 0, "qmm_int8": 1, "qmm_int8_inkq": 1}


DIM, FFN = 512, 768


def _ffn_case(qtype, m, dev, seed=1):
    rng = np.random.default_rng(seed)
    gu = QTensor.from_gguf_raw(random_blocks(qtype, 2 * FFN, DIM, rng), qtype,
                               (2 * FFN, DIM), device=dev)
    dn = QTensor.from_gguf_raw(random_blocks(qtype, DIM, FFN, rng), qtype,
                               (DIM, FFN), device=dev)
    x = torch.from_numpy(rng.normal(size=(m, DIM)).astype(np.float32)).to(dev)
    return x, gu, dn


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", FORMATS, ids=lambda q: q.name)
@pytest.mark.parametrize("m", [1, 4, 5, 7, 8, 9, 16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_fused_matches_plain(dev, qtype, m, act):
    x, gu, dn = _ffn_case(qtype, m, dev)
    FF.reset_launches()
    got = FF.ffn_fused(x, gu, dn, act=act)
    assert _rel(got, FF.ffn_fused_ref(x, gu, dn, act=act)) <= 1e-4
    assert torch.equal(got, FF.ffn_fused(x, gu, dn, act=act))  # fixed order
    torch.cuda.synchronize()
    assert FF.LAUNCHES == {"ffn_fused": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["llama7b_q4_0_m16", "llama7b_q2_k_m1",
                                  "bf16_valued_x", "relu"])
def test_ffn_fused_cases(dev, case):
    """The 7B FFN (43 chunks of down K, windows at M = 16); x whose
    values are bf16 already, so every lo half is 0; the relu act."""
    rng = np.random.default_rng(2)
    qtype = GGMLType.Q2_K if "q2_k" in case else GGMLType.Q4_0
    dim, ffn = (4096, 11008) if case.startswith("llama7b") else (DIM, FFN)
    m = 1 if case.endswith("m1") else (16 if case.endswith("m16") else 3)
    gu = QTensor.from_gguf_raw(random_blocks(qtype, 2 * ffn, dim, rng), qtype,
                               (2 * ffn, dim), device=dev)
    dn = QTensor.from_gguf_raw(random_blocks(qtype, dim, ffn, rng), qtype,
                               (dim, ffn), device=dev)
    x = torch.from_numpy(rng.normal(size=(m, dim)).astype(np.float32)).to(dev)
    if case == "bf16_valued_x":
        x = x.to(torch.bfloat16).to(torch.float32)
    act = "relu" if case == "relu" else "silu"
    got = FF.ffn_fused(x, gu, dn, act=act)
    assert bool(torch.isfinite(got).all()) and got.shape == (m, dim)
    assert _rel(got, FF.ffn_fused_ref(x, gu, dn, act=act)) <= 1e-4
    assert torch.equal(got, FF.ffn_fused(x, gu, dn, act=act))


MEGA_GPU_CASES = {
    "q4_0_gqa": dict(dim=256, ffn=512, n_head=4, n_kv=2, span=64, live=40),
    "q8_0_neox_hd128": dict(dim=512, ffn=768, n_head=4, span=97, live=96,
                            qtype=GGMLType.Q8_0, rope_kind="neox"),
    "q2_k_hd256": dict(dim=512, ffn=512, n_head=2, span=300, live=150,
                       qtype=GGMLType.Q2_K),
    "q5_1_3_layers": dict(dim=256, ffn=768, n_head=4, n_layers=3, span=33,
                          live=1, qtype=GGMLType.Q5_1),
    "q4_1_no_live_cell": dict(dim=256, ffn=512, n_head=4, span=16, live=0,
                              qtype=GGMLType.Q4_1),
    "q5_0_long_span": dict(dim=256, ffn=512, n_head=4, n_kv=1, span=5000,
                           live=4500, qtype=GGMLType.Q5_0),
    # LLaMA-7B width: the two code conversions (nibbles, signed bytes)
    "q4_0_llama7b": dict(dim=4096, ffn=11008, n_head=32, n_layers=1,
                         span=1024, live=640),
    "q8_0_llama7b": dict(dim=4096, ffn=11008, n_head=32, n_layers=1,
                         span=1024, live=640, qtype=GGMLType.Q8_0),
    # head dim 4: K / V rows read an element at a time (not 16 bytes), and
    # more heads than blocks; ffn of 129 chunks: the down product's K in
    # two windows of the kernel's shared memory
    "q4_0_hd4_rows": dict(dim=768, ffn=512, n_head=192, span=40, live=30),
    "q8_0_two_windows": dict(dim=256, ffn=33024, n_head=2, span=16, live=8,
                             qtype=GGMLType.Q8_0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", MEGA_GPU_CASES, ids=list(MEGA_GPU_CASES))
def test_mega_decode_matches_plain(dev, case):
    c = mega_case(np.random.default_rng(3), dev, **MEGA_GPU_CASES[case])
    MD.reset_launches()
    got = mega_call(MD.mega_decode_layers, c)
    # the kernel wrote each layer's new K / V row, bf16, at the cell
    hd, cell = c["mega"].spec.head_dim, c["pos"]
    for rows, new in ((c["k"], got[1]), (c["v"], got[2])):
        for row, n in zip(rows, new):
            assert torch.equal(row[0, :, cell],
                               n.reshape(-1, hd).to(torch.bfloat16))
    again = mega_call(MD.mega_decode_layers, c)
    want = mega_call(MD.mega_decode_layers_ref, c)
    for a, b, c2 in zip(got, want, again):
        assert torch.isfinite(a).all()
        assert _rel(a, b) <= 1e-2
        assert torch.equal(a, c2)                      # fixed order
    torch.cuda.synchronize()
    assert MD.LAUNCHES == {"mega_decode": 2}


@pytest.mark.cuda
def test_mega_decode_merges_many_chunks(dev, monkeypatch):
    # 2,050 chunks of 2 keys a head: phase B's merge takes its chunks in
    # two tiles of MAX_CHUNK (a span past 2M cells gives such counts)
    monkeypatch.setattr(MD, "attn_chunks", lambda S, b, h: (-(-S // 2), 2))
    c = mega_case(np.random.default_rng(5), dev, dim=256, ffn=512, n_head=4,
                  span=4100, live=4000)
    got = mega_call(MD.mega_decode_layers, c)
    want = mega_call(MD.mega_decode_layers_ref, c)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel(a, b) <= 1e-2


@pytest.mark.cuda
def test_decode_wrappers_refuse(dev):
    x, qt = _case(GGMLType.Q4_0, 1, dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        Q.qmm_int8_inkq_cuda(x, qt.to("cpu"))
    with pytest.raises(ValueError, match="M <= 16"):
        Q.qmm_int8_inkq_cuda(torch.zeros((17, K), device=dev), qt)
    x, gu, dn = _ffn_case(GGMLType.Q4_0, 1, dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        FF.ffn_fused(x, gu, dn.to("cpu"))
    with pytest.raises(ValueError, match="M <= 16"):
        FF.ffn_fused(torch.zeros((17, DIM), device=dev), gu, dn)
    c = mega_case(np.random.default_rng(4), dev, dim=256, ffn=512, n_head=4,
                  span=16, live=8)
    with pytest.raises(NotImplementedError, match="B0 == 1"):
        MD.mega_decode_layers(c["mega"], torch.zeros((2, 256), device=dev),
                              8, 8, c["kpos"], c["k"], c["v"], *c["lanes"])
    with pytest.raises(ValueError, match="one CUDA device"):
        MD.mega_decode_layers(c["mega"], c["x"], 8, 8, c["kpos"],
                              [k.cpu() for k in c["k"]], c["v"], *c["lanes"])


# -- the streaming probe (csrc/stream_reduce.cu) -------------------------------
# Tolerance as in chip_smoke.py phase 3d: within 1e-5 sum|x| a column of the
# float64 sum of the rows the kernel reads (whole tiles; the tail skipped).

@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(3 * 2048 + 777, 1024), (1500, 256),
                                       (300, 8), (5000, 1028)])
@pytest.mark.parametrize("block_rows", [512, 1024, 2048])
def test_stream_reduce_matches_plain(dev, rows, cols, block_rows):
    from chip_smoke import stream_err
    from tpulamm_torch.tools import stream_ceiling as SC
    rng = np.random.default_rng(rows + cols)
    x = torch.from_numpy(rng.normal(size=(rows, cols)).astype(np.float32)
                         ).to(dev)
    b = torch.full((1, 1), -1.25, device=dev)
    run = SC.make_reduce(rows, cols, block_rows)
    SC.reset_launches()
    got = run(b, x)
    stream_err(got, x, -1.25, block_rows)
    assert torch.equal(got, run(b, x))                   # fixed order
    ref = SC.reduce_ref(x, b, block_rows)
    assert float((got - ref).abs().max()) <= 1e-5 * float(x.abs().sum(0).max())
    torch.cuda.synchronize()
    assert SC.LAUNCHES == {"stream_reduce": 2}


@pytest.mark.cuda
def test_stream_reduce_refuses(dev):
    from tpulamm_torch.tools import stream_ceiling as SC
    with pytest.raises(ValueError, match="multiple of 4"):
        SC.make_reduce(64, 6, 512)
    x = torch.zeros((64, 16), device=dev)
    run = SC.make_reduce(64, 8, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        run(torch.zeros((1, 1), device=dev), x[:, 4:12])
    with pytest.raises(ValueError, match="one CUDA device"):
        run(torch.zeros((1, 1)), x[:, :8].contiguous())


# -- the batched decode block on the card --------------------------------------

@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    from tpulamm_torch.tools.synth import write_llama_gguf
    path = str(tmp_path_factory.mktemp("m") / "tiny.gguf")
    # widths where every projection has an N the int8 gemv takes
    write_llama_gguf(path, 2, np.random.default_rng(7), dim=1024, ffn=1024,
                     n_head=8, vocab=1024)
    return path


@pytest.mark.cuda
def test_decode_batch_fast_on_card(dev, tiny_gguf):
    """Greedy block tokens == the decode_batch host loop on the card; the
    block launches only the int8 gemv (per_pass a step); a seeded sampled
    block repeats itself."""
    from tpulamm_torch.runtime.engine import Engine

    def engine():
        eng = Engine(tiny_gguf, n_ctx=64, n_slots=4, device=dev)
        eng.prefill(0, [1, 9, 33])
        eng.prefill(1, [4, 7])
        return eng
    eng = engine()
    cur, host = {0: 11, 1: 25}, {0: [], 1: []}
    for _ in range(6):
        lg = eng.decode_batch(cur)
        cur = {s: int(np.argmax(v)) for s, v in lg.items()}
        for s in cur:
            host[s].append(cur[s])
    eng = engine()
    Q.reset_launches()
    assert eng.decode_batch_fast({0: 11, 1: 25}, 6) == host
    torch.cuda.synchronize()
    assert Q.LAUNCHES == {"qmm": 0, "qmm_int8": 9 * 6, "qmm_int8_inkq": 0}
    a = engine().decode_batch_fast({0: 11, 1: 25}, 6, temp=0.9, seed=4)
    assert a == engine().decode_batch_fast({0: 11, 1: 25}, 6, temp=0.9,
                                           seed=4)


# -- the decode blocks as CUDA graphs (runtime/decode_graph.py) ----------------
# A graph's tokens equal the eager steps of the step it captured (the same
# kernels in the same order: the same bits); the counts add the capture's
# launches on every replay; the cache keeps its storage; the megakernel
# flags a cell outside its span instead of writing it.

def _slots_engine(path, dev, B, **kw):
    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(path, n_ctx=64, n_slots=4, device=dev, **kw)
    for s in range(B):
        eng.prefill(s, [1, 9 + s, 33, 4 + s])
    return eng, {s: 11 + s for s in range(B)}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("temp", [0.0, 0.9], ids=["greedy", "sampled"])
def test_step_graph_tokens_equal_eager_steps(dev, tiny_gguf, B, temp):
    from chip_smoke import eager_block
    eng, toks = _slots_engine(tiny_gguf, dev, B)
    start = {s: int(eng.n_past[s]) for s in toks}
    got = eng.decode_batch_fast(toks, 12, temp=temp, seed=3)
    again = []
    for seed in (3, 4):
        for s in toks:
            eng.rollback(s, start[s])
        again.append(eng.decode_batch_fast(toks, 12, temp=temp, seed=seed))
    for s in toks:
        eng.rollback(s, start[s])
    b, tok, pos, act = eng._block_inputs(toks, 12, "reference")
    ref = eager_block(eng, "step", None, tok, pos, act, 12,
                      temp=np.where(act, temp, 0.0), seed=3)
    assert got == {s: [int(t) for t in ref[:, s]] for s in toks}
    assert again[0] == got                          # reseeded: the same
    assert (again[1] == got) == (temp == 0.0)       # another seed: others
    assert len(eng.graphs.graphs) == 1
    if temp > 0.0:
        # the same inputs without a reseed: the replays draw on from where
        # the last block left the generator, so the tokens differ
        (g,) = eng.graphs.graphs.values()
        g.bufs.stage(tok, pos, pos, act, np.where(act, temp, 0.0))
        drawn_on = g.run(12)
        assert {s: [int(t) for t in drawn_on[:, s]] for s in toks} != got


@pytest.mark.cuda
def test_mega_graph_tokens_equal_eager_steps(dev, tiny_gguf):
    """The megakernel's step graph (one cooperative launch captured with
    the lm head and the sampler) against its eager steps."""
    from chip_smoke import eager_block
    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(tiny_gguf, n_ctx=64, megakernel=True, device=dev)
    assert eng.mega is not None
    prompt = [1, 9, 33, 4, 17]
    MD.reset_launches()
    ids, _ = eng.generate_fast(prompt, n_predict=17, stop_on_eos=False)
    torch.cuda.synchronize()
    assert MD.LAUNCHES == {"mega_decode": 16} and eng.timings.n_step == 16
    eng.rollback(0, len(prompt))
    ref = eager_block(eng, "mega", 0, [ids[0]], [len(prompt)], [1], 16)
    assert [int(t) for t in ref[:, 0]] == ids[1:17]


@pytest.mark.cuda
def test_fused_ffn_graph_logits_equal_eager_forward(dev, tiny_gguf):
    """decode_one replays the graph of the forward alone; with fused_ffn and
    int8_inkq it captures the cooperative ffn_fused launch. Its logits
    equal the eager forward's at the same cell (within 1e-5 of max|logit|:
    the einsum attention's library products may pick another algorithm
    under capture)."""
    from tpulamm_torch.runtime.engine import Engine
    eng = Engine(tiny_gguf, n_ctx=64, fused_ffn=True, int8_inkq=True,
                 device=dev)
    eng.prefill(0, [1, 9, 33])
    n = int(eng.n_past[0])
    FF.reset_launches()
    a = eng.decode_one(0, 7)
    b = eng.decode_one(0, 8)
    torch.cuda.synchronize()
    assert FF.LAUNCHES == {"ffn_fused": 2 * 2}      # 2 layers, 2 replays
    eng.rollback(0, n)
    for tok, want in ((7, a), (8, b)):
        pos = int(eng.n_past[0])
        cells = eng._cells_for(0, 1, np.array([pos]))
        got = eng._run(0, np.array([tok]), np.array([pos]), cells)[0]
        eng.n_past[0] += 1
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
def test_replay_adds_the_capture_launches(dev, tiny_gguf):
    eng, toks = _slots_engine(tiny_gguf, dev, 1)
    Q.reset_launches()
    eng.decode_batch_fast(toks, 5)
    (g,) = eng.graphs.graphs.values()
    assert g.delta[0] == {"qmm_int8": 9}            # 4 a layer + lm head
    assert Q.LAUNCHES["qmm_int8"] == 9 * 5          # the warm-up not counted
    g.bufs.stage([5], [int(eng.n_past[0])], [int(eng.n_past[0])], [1])
    g.replay()
    assert Q.LAUNCHES["qmm_int8"] == 9 * 6


@pytest.mark.cuda
@pytest.mark.parametrize("kw,n_predict", [
    (dict(kv_dtype="q8_0"), 60), (dict(grp_attn_n=2, grp_attn_w=8), 24)],
    ids=["context_shift", "self_extend"])
def test_cache_storage_stays_across_surgery(dev, tiny_gguf, kw, n_predict):
    """Context shift (seq_rm, seq_add, defrag) and self-extend (seq_add,
    seq_div: positions regrouped, no cell freed, so the window holds the
    whole run) write the cache in place, so the captured graphs go on
    reading it."""
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.sampling import SamplingParams
    eng = Engine(tiny_gguf, n_ctx=32, device=dev, **kw)
    c = eng.cache

    def ptrs():
        return [t.data_ptr() for t in c.k + c.v + (c.ks or []) + (c.vs or [])
                + [c.pos]]
    before = ptrs()
    ids, _ = eng.generate([1, 9, 33, 4], n_predict=n_predict,
                          sampling=SamplingParams(temp=0.0), stop_on_eos=False)
    assert len(ids) == n_predict and eng.cache is c and ptrs() == before
    assert (eng.ga_i[0] > 0) if "grp_attn_n" in kw else (eng.n_past[0] < 60)
    np.testing.assert_array_equal(c.pos[0, :32].cpu().numpy(), eng.cell_pos[0])


@pytest.mark.cuda
def test_mega_error_word(dev, tiny_gguf):
    """A cell outside the span: the kernel sets the error word and writes
    nothing; a block whose step sets it raises."""
    c = mega_case(np.random.default_rng(6), dev, dim=256, ffn=512, n_head=4,
                  span=16, live=8)
    before = [t.clone() for t in c["k"] + c["v"]]
    w = torch.tensor([8, 16], dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    MD.mega_decode_layers(c["mega"], c["x"], w[:1], w[1:], c["kpos"], c["k"],
                          c["v"], *c["lanes"], err)
    torch.cuda.synchronize()
    assert int(err) == 1
    for t, u in zip(c["k"] + c["v"], before):
        assert torch.equal(t, u)
    w[1] = 8                                         # in range: no error
    err.zero_()
    got = MD.mega_decode_layers(c["mega"], c["x"], w[:1], w[1:], c["kpos"],
                                c["k"], c["v"], *c["lanes"], err)
    want = mega_call(MD.mega_decode_layers, c)
    assert int(err) == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    from tpulamm_torch.runtime.engine import Engine
    # n_ctx 512: the span view (256) ends before the row, so the step's
    # position write at the cell stays inside it
    eng = Engine(tiny_gguf, n_ctx=512, megakernel=True, device=dev)
    eng.prefill(0, [1, 9, 33])
    span = eng._mega_span(16)
    assert span == 256
    g = eng._graph("mega", 1, span, 0, "greedy")
    g.bufs.stage([5], [span], [span], [1])
    with pytest.raises(RuntimeError, match="outside its span"):
        g.run(1)
