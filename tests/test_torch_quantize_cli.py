"""The port's model-file tools against the JAX package's, on the tiny llama
of tests/_torch_port_models.py written in F32 (and in Q4_0 as a quantized
source): cli.quantize writes the same file byte for byte for every target,
with --pure and with --imatrix; quantize_stats, gguf_dump and tokenize
print the same text. Every comparison is exact.

The JAX tools run on the JAX package's numpy quantizers (its native codec
switched off): that codec sums Q2_K's search in another order than its
numpy reference and decodes fp16 subnormals at half their value, so a file
it writes can differ from the numpy one (3 of the 256 rows of this model's
blk.1.ffn_down in Q2_K). The port's codec equals the numpy quantizers."""

import filecmp

import numpy as np
import pytest

from _torch_port_models import write_tiny_llama
from tpulamm.cli import gguf_dump as j_dump
from tpulamm.cli import quantize as j_quant
from tpulamm.cli import quantize_stats as j_stats
from tpulamm.cli import tokenize as j_tok
from tpulamm.gguf.constants import GGMLType
from tpulamm.quant import native as j_native
from tpulamm_torch.cli import gguf_dump as p_dump
from tpulamm_torch.cli import quantize as p_quant
from tpulamm_torch.cli import quantize_stats as p_stats
from tpulamm_torch.cli import tokenize as p_tok
from tpulamm_torch.gguf.reader import GGUFReader


@pytest.fixture
def jax_numpy_quantizers(monkeypatch):
    monkeypatch.setattr(j_native, "get_lib", lambda: None)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("qcli")
    f32 = write_tiny_llama(str(d / "tiny_f32.gguf"), qtype=GGMLType.F32)
    q4 = write_tiny_llama(str(d / "tiny_q4_0.gguf"), qtype=GGMLType.Q4_0)
    rng = np.random.default_rng(4)
    imat = str(d / "imatrix.npz")
    data = {}
    for name, k in (("blk.0.attn_q.weight", 256), ("blk.1.ffn_down.weight",
                                                     512),
                    ("blk.0.ffn_gate.weight", 256), ("output.weight", 128)):
        data[f"sum::{name}"] = rng.uniform(0.1, 9.0, size=k).astype(np.float32)
        data[f"count::{name}"] = np.asarray(7)
    np.savez(imat, **data)
    return {"dir": d, "f32": f32, "q4_0": q4, "imatrix": imat}


def _both(capsys, j_main, p_main, argv_j, argv_p=None):
    rj = j_main(argv_j)
    out_j = capsys.readouterr()
    rp = p_main(argv_j if argv_p is None else argv_p)
    out_p = capsys.readouterr()
    assert rj == rp
    return out_j, out_p


@pytest.mark.usefixtures("jax_numpy_quantizers")
@pytest.mark.parametrize("target", sorted(p_quant.NAMES))
def test_quantize_file_bytes(models, target, capsys):
    d = models["dir"]
    a, b = str(d / f"j_{target}.gguf"), str(d / f"p_{target}.gguf")
    out_j, out_p = _both(capsys, j_quant.main, p_quant.main,
                         [models["f32"], a, target],
                         [models["f32"], b, target])
    assert filecmp.cmp(a, b, shallow=False)
    # the per-tensor lines (the last line carries the host's seconds)
    assert out_j.out.splitlines()[:-1] == out_p.out.splitlines()[:-1]
    types = {n: t.ggml_type.name for n, t in GGUFReader(b).tensors.items()}
    assert types["output_norm.weight"] == "F32"
    if target in ("q2_k", "q4_0", "q4_1", "q5_0", "q5_1"):
        assert types["output.weight"] == "Q8_0"


@pytest.mark.usefixtures("jax_numpy_quantizers")
@pytest.mark.parametrize("argv", [["q4_0", "--pure"], ["q2_k", "--pure"],
                                  ["q4_0", "--imatrix"],
                                  ["q5_0", "--imatrix"],
                                  ["q8_0", "--imatrix"]],
                         ids=lambda a: "-".join(a).replace("--", ""))
def test_quantize_options(models, argv, capsys):
    d = models["dir"]
    extra = [models["imatrix"]] if "--imatrix" in argv else []
    tag = "-".join(argv).replace("--", "")
    a, b = str(d / f"j_{tag}.gguf"), str(d / f"p_{tag}.gguf")
    _both(capsys, j_quant.main, p_quant.main,
          [models["f32"], a, *argv, *extra], [models["f32"], b, *argv, *extra])
    assert filecmp.cmp(a, b, shallow=False)


@pytest.mark.usefixtures("jax_numpy_quantizers")
@pytest.mark.parametrize("target", ["q8_0", "q4_0", "f16"])
def test_quantize_from_quantized(models, target):
    d = models["dir"]
    a, b = str(d / f"jq_{target}.gguf"), str(d / f"pq_{target}.gguf")
    j_quant.quantize_file(models["q4_0"], a, j_quant.NAMES[target],
                          verbose=False)
    p_quant.quantize_file(models["q4_0"], b, p_quant.NAMES[target],
                          verbose=False)
    assert filecmp.cmp(a, b, shallow=False)


def test_choose_type():
    for name, shape in (("output.weight", (512, 256)),
                        ("blk.0.attn_norm.weight", (256,)),
                        ("blk.0.attn_q.weight", (256, 96)),
                        ("blk.0.attn_q.bias", (256, 256)),
                        ("token_embd.weight", (512, 256))):
        for target in p_quant.NAMES:
            for pure in (False, True):
                got = p_quant.choose_type(name, shape,
                                          p_quant.NAMES[target], pure)
                want = j_quant.choose_type(name, shape,
                                           j_quant.NAMES[target], pure)
                assert got.name == want.name


@pytest.mark.usefixtures("jax_numpy_quantizers")
@pytest.mark.parametrize("argv", [[], ["-t", "q4_0", "-t", "q2_k",
                                        "--per-layer"],
                                  ["-l", "blk.0.attn_q", "--per-layer"],
                                  ["-l", "no_such_tensor"]],
                         ids=["all", "types", "layer", "none"])
def test_quantize_stats_text(models, argv, capsys):
    out_j, out_p = _both(capsys, j_stats.main, p_stats.main,
                         ["-m", models["f32"], *argv])
    assert out_j.out == out_p.out and out_j.err == out_p.err


@pytest.mark.parametrize("argv", [[], ["--no-tensors"], ["--json"]],
                         ids=["text", "no-tensors", "json"])
@pytest.mark.parametrize("model", ["f32", "q4_0"])
def test_gguf_dump_text(models, model, argv, capsys):
    out_j, out_p = _both(capsys, j_dump.main, p_dump.main,
                         [models[model], *argv])
    assert out_j.out == out_p.out


@pytest.mark.parametrize("argv", [
    ["-p", "Hello world, the quick brown fox."],
    ["-p", " leading space\nand a newline", "--ids"],
    ["-p", "no bos here", "--no-bos", "--ids"],
    ["--decode", "1,72,101,108,108,111,2"],
    ["-f", "FILE"]], ids=["pieces", "ids", "no-bos", "decode", "file"])
def test_tokenize_text(models, argv, capsys):
    f = models["dir"] / "prompt.txt"
    f.write_text("Über 3 words\tand tabs ✓\n")
    argv = [str(f) if a == "FILE" else a for a in argv]
    out_j, out_p = _both(capsys, j_tok.main, p_tok.main,
                         ["-m", models["q4_0"], *argv])
    assert out_j.out == out_p.out
