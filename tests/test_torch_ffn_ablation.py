"""tools/ffn_ablation.py on the CPU: every part it removes is still
written once in csrc/ffn_fused.cu (with the headers it includes) as the
tool expects, its inputs run through ffn_fused_ref (the plain path on the
CPU), its bound and ptxas filter read as intended, and without a GPU it
runs nothing."""

import numpy as np
import pytest
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import ffn_fused as FF
from tpulamm_torch.ops import kernels
from tpulamm_torch.tools import ffn_ablation as FA
from tpulamm_torch.tools.flash_ablation import ablated_sources


@pytest.mark.parametrize("name", list(FA.ABLATIONS))
def test_ablation_texts_are_in_the_source(name):
    subs = FA.ABLATIONS[name][1]
    text = "".join(p.read_text() for p in kernels.sources("ffn_fused"))
    for old, new in subs:
        assert text.count(old) == 1
        assert new != old
    got = ablated_sources("ffn_fused", subs)
    for old, new in subs:
        assert any(new in t for t in got.values())
        assert any(old in t for t in got.values()) == (old in new)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q2_K])
def test_ablation_inputs(qtype):
    gu, dn, xs = FA.inputs(np.random.default_rng(0), torch.device("cpu"),
                           qtype, dim=256, ffn=512, ms=(1, 3))
    assert gu.qtype == dn.qtype == qtype
    assert gu.mm_dims == (1024, 256) and dn.mm_dims == (256, 512)
    FF.reset_launches()
    for m, x in xs.items():
        assert x.shape == (m, 256) and x.dtype == torch.float32
        out = FF.ffn_fused(x, gu, dn)
        assert out.shape == (m, 256) and bool(torch.isfinite(out).all())
        assert torch.equal(out, FF.ffn_fused_ref(x, gu, dn))
        lib = FA.library(x, gu, dn)()
        assert lib.shape == (m, 256)
    assert FF.LAUNCHES["ffn_fused"] == 0               # the CPU runs no kernel


def test_bound_is_the_bytes_at_the_7b_ffn():
    """At M <= 16 the planes bound the 7B FFN: Q4_0's 84.5 MB over
    3.35 TB/s, above the two bf16 passes of operations."""
    gu, dn, _ = FA.inputs(np.random.default_rng(0), torch.device("cpu"),
                          ms=())
    for m in (1, 16):
        t_b, t_o = FA.bound_ms(m, gu, dn)
        assert t_b > t_o
        assert abs(t_b - (gu.n_bytes + dn.n_bytes) / 3.35e9) < 1e-3
    assert abs(gu.n_bytes + dn.n_bytes - 84.5e6) < 0.1e6


def test_ptxas_lines_of_the_kernel():
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116ffn_"
           "fused_kernelILi1EEEvNS_7FfnArgsE' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_116ffn_"
           "fused_kernelILi1EEEvNS_7FfnArgsE\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers\n")
    name = "_ZN12_GLOBAL__N_116ffn_fused_kernelILi1EEEvNS_7FfnArgsE"
    assert FA.ptxas_lines(log) == [
        f"{name}: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads",
        f"{name}: ptxas info    : Used 168 registers, used 1 barriers"]


def test_ablation_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert FA.main([]) == 1
    assert "needs a GPU" in capsys.readouterr().err
