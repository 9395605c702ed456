"""tools/int8_ablation.py on the CPU: every part it removes is still
written once in csrc/qmm_int8.cu (with the headers it includes) as the
tool expects, its inputs run through qmm_int8_ref (the plain path on the
CPU), its ptxas filter keeps the gemv's and the prologue's lines, and
without a GPU it runs nothing."""

import numpy as np
import pytest
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import kernels
from tpulamm_torch.ops import qmm as Q
from tpulamm_torch.tools import int8_ablation as IA
from tpulamm_torch.tools.flash_ablation import ablated_sources


@pytest.mark.parametrize("name", list(IA.ABLATIONS))
def test_ablation_texts_are_in_the_source(name):
    subs = IA.ABLATIONS[name][1]
    text = "".join(p.read_text() for p in kernels.sources("qmm_int8"))
    for old, new in subs:
        assert text.count(old) == 1
        assert new != old
    got = ablated_sources("qmm_int8", subs)
    for old, new in subs:
        assert any(new in t for t in got.values())
        assert not any(old in t for t in got.values())


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q8_0])
def test_ablation_inputs(qtype):
    shapes = {"a": (256, 512), "b": (128, 256)}
    cases = IA.inputs(np.random.default_rng(0), torch.device("cpu"), qtype,
                      shapes=shapes, ms=(1, 3))
    assert list(cases) == ["a", "b"]
    Q.reset_launches()
    for label, (qt, xs) in cases.items():
        n, k = shapes[label]
        assert qt.qtype == qtype and qt.mm_dims == (n, k)
        for m, x in xs.items():
            assert x.shape == (m, k) and x.dtype == torch.float32
            out = Q.qmm_int8_cuda(x, qt)
            assert out.shape == (m, n) and bool(torch.isfinite(out).all())
            assert torch.equal(out, Q.qmm_int8_ref(x, qt))
    assert Q.LAUNCHES["qmm_int8"] == 0                 # the CPU runs no kernel


def test_ptxas_lines_of_the_kernels():
    log = ("ptxas info    : Compiling entry function '_Z15qmm_int8_kernelILi2E"
           "Li1ELb0EEv4Args' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z15qmm_int8_kernel\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers\n"
           "ptxas info    : Compiling entry function '_Z20quantize_acts_kernel"
           "ILi32EEvPKfPaPfS3_i' for 'sm_90a'\n"
           "ptxas info    : Used 24 registers, used 0 barriers\n")
    got = IA.ptxas_lines(log)
    assert got == [
        "_Z15qmm_int8_kernelILi2ELi1ELb0EEv4Args: 0 bytes stack frame, 0 "
        "bytes spill stores, 0 bytes spill loads",
        "_Z15qmm_int8_kernelILi2ELi1ELb0EEv4Args: ptxas info    : Used 96 "
        "registers, used 1 barriers",
        "_Z20quantize_acts_kernelILi32EEvPKfPaPfS3_i: ptxas info    : Used 24 "
        "registers, used 0 barriers"]


def test_ablation_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert IA.main([]) == 1
    assert "needs a GPU" in capsys.readouterr().err
