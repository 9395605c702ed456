"""tools/flash_ablation.py on the CPU: every step it removes is still
written in csrc/flash_attention.cu as the tool expects, its inputs are
what the path hands the kernels, and without a GPU it runs nothing."""

import pytest
import torch

from tpulamm_torch.ops import flash_attention as FA
from tpulamm_torch.ops import kernels
from tpulamm_torch.tools import flash_ablation as FB


@pytest.mark.parametrize("name", list(FB.ABLATIONS))
def test_ablation_texts_are_in_the_source(name):
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    for old, new in FB.ABLATIONS[name][1]:
        assert src.count(old) == 1
        assert new != old


@pytest.mark.parametrize("kind", ["q8", "bf16"])
def test_ablation_inputs(kind):
    c = FB.inputs(4, kind, torch.device("cpu"), S=33, Hkv=2, hd=64)
    assert c["k"].dtype == (torch.int8 if kind == "q8" else torch.bfloat16)
    assert (c["ks"] is not None) == (kind == "q8")
    assert c["kpos"][0, -1] == -1 and int(c["qbase"][0]) == 33 - 1 - 4
    out = FA.flash_attention(c["q"], c["k"], c["v"], c["kpos"], c["qbase"],
                             c["qlen"], c["ks"], c["vs"], scale=0.125, g=1)
    assert out.shape == (1, 2, 4, 64) and bool(torch.isfinite(out).all())


def test_ablation_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert FB.main([]) == 1
    assert "needs a GPU" in capsys.readouterr().err
