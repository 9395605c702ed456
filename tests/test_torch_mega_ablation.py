"""tools/mega_ablation.py on the CPU: every part it removes (and every
point its timeline copy stamps) is still written once in the
megakernel's sources (csrc/mega_decode.cu and the headers it includes)
as the tool expects, its inputs run through
mega_decode_layers (the plain path on the CPU), and without a GPU it runs
nothing."""

import numpy as np
import pytest
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import kernels
from tpulamm_torch.ops import mega_decode as MD
from tpulamm_torch.tools import mega_ablation as MA
from tpulamm_torch.tools.flash_ablation import ablated_sources


@pytest.mark.parametrize("name", [*MA.ABLATIONS, "timeline"])
def test_ablation_texts_are_in_the_source(name):
    subs = MA.TIMELINE if name == "timeline" else MA.ABLATIONS[name][1]
    text = "".join(p.read_text() for p in kernels.sources("mega_decode"))
    for old, new in subs:
        assert text.count(old) == 1
        assert new != old
    # the copy holds each replacement, and the text only where it is kept
    got = ablated_sources("mega_decode", subs)
    for old, new in subs:
        assert any(new in t for t in got.values())
        assert any(old in t for t in got.values()) == (old in new)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q8_0])
def test_ablation_inputs(qtype):
    c = MA.inputs(np.random.default_rng(0), torch.device("cpu"), dim=256,
                  ffn=512, n_head=4, n_kv=2, span=16, live=9, qtype=qtype)
    assert c["pos"] == 9 and int((c["kpos"] >= 0).sum()) == 9
    assert c["mega"].spec.qtypes == (qtype,) * 4
    x_out, k_new, v_new = MA.step(MD.mega_decode_layers, c)
    assert x_out.shape == (1, 256) and k_new.shape == (2, 1, 2 * 64)
    for t in (x_out, k_new, v_new):
        assert bool(torch.isfinite(t).all())
    # the step wrote each layer's new K row, bf16, at the cell
    for row, new in zip(c["k"], k_new):
        assert torch.equal(row[0, :, 9], new.reshape(2, 64).to(torch.bfloat16))


def test_ptxas_lines_of_the_kernel():
    log = ("ptxas info    : Compiling entry function '_Z18mega_decode_kernel"
           "8MegaArgs' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z9attentionILi8EEv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers\n")
    assert MA.ptxas_lines(log) == [
        "ptxas info    : Function properties for _Z9attentionILi8EEv",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads"]


def test_ablation_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert MA.main([]) == 1
    assert "needs a GPU" in capsys.readouterr().err
