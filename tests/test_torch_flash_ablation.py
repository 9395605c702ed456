"""tools/flash_ablation.py and tools/flash_times.py on the CPU: every
step the ablation removes is still written in csrc/flash_attention.cu as
the tool expects, each define of its variant builds is read there, their
inputs are what the path hands the kernels (at each head dim and shape
they time), and without a GPU they run nothing."""

import pytest
import torch

from tpulamm_torch.ops import flash_attention as FA
from tpulamm_torch.ops import kernels
from tpulamm_torch.tools import flash_ablation as FB
from tpulamm_torch.tools import flash_times as FT


@pytest.mark.parametrize("name", list(FB.ABLATIONS))
def test_ablation_texts_are_in_the_source(name):
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    for old, new in FB.ABLATIONS[name][1]:
        assert src.count(old) == 1
        assert new != old


@pytest.mark.parametrize("name", list(FB.VARIANTS))
def test_variant_defines_are_in_the_source(name):
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    for flag in FB.VARIANTS[name][1]:
        assert flag.startswith("-D")
        assert f"#ifdef {flag[2:]}" in src


@pytest.mark.parametrize("hd", sorted(FB.SHAPES))
def test_ablation_shapes_per_head_dim(hd):
    """Each head dim's rows at a small span through the plain version:
    (B, Hkv, T * G, hd) out, every row finite."""
    for kernel, T, kind, Hkv, G, _ in FB.SHAPES[hd]:
        c = FB.inputs(T, kind, torch.device("cpu"), S=65, Hkv=Hkv, hd=hd,
                      G=G)
        out = getattr(FA, kernel)(c["q"], c["k"], c["v"], c["kpos"],
                                  c["qbase"], c["qlen"], c["ks"], c["vs"],
                                  scale=hd ** -0.5, g=G)
        assert out.shape == (1, Hkv, T * G, hd)
        assert bool(torch.isfinite(out).all())


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


@pytest.mark.parametrize("shape", FT.SHAPES)
def test_flash_times_shapes(shape):
    """Each shape of flash_times at a small span through the plain version,
    in both kinds: (B, Hkv, T * G, hd) out, finite, and the same digest
    twice."""
    kernel, hd, Hkv, G, T, _ = shape
    for kind in FT.KINDS:
        c = FT.inputs(min(T, 8), kind, torch.device("cpu"), S=65, Hkv=Hkv,
                      hd=hd, G=G)
        out = FT.run(kernel, c, hd, G)
        assert out.shape == (1, Hkv, min(T, 8) * G, hd)
        assert bool(torch.isfinite(out).all())
        assert FT.digest(out) == FT.digest(FT.run(kernel, c, hd, G))


def test_flash_times_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert FT.main([]) == 1
    assert "needs a GPU" in capsys.readouterr().err
