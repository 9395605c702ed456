"""The port's training tools against the JAX package's on the CPU:
tools.imatrix (collect_imatrix, densify_params, main and its file read by
either package's quantizer), tools.passkey_train (gen_docs,
train_passkey, evaluate), tools.spec_bench (bench_pair on a trained pair)
and quality_table --train, at tiny sizes.

Tolerances: densified weights, passkey documents and every GGUF written
after one training step (lr 0 at the schedule's first count) exactly; an
imatrix's keys and token counts exactly and its column sums within 1e-5
of each tensor's largest (the two forwards' activations agree to ~1e-6);
the quantizer's files from one imatrix byte for byte; passkey retrieval
results and spec_bench's accept rates and tokens a step exactly (greedy
on the same files).
"""

import numpy as np
import pytest
import torch

from _torch_port_models import write_tiny_llama
from tpulamm.cli import quantize as JQCLI
from tpulamm.gguf.constants import GGMLType
from tpulamm.quant import native as j_native
from tpulamm.tools import imatrix as JI
from tpulamm.tools import passkey_train as JPK
from tpulamm.tools import quality_table as JQ
from tpulamm.tools import spec_bench as JSB
from tpulamm_torch.cli import quantize as PQCLI
from tpulamm_torch.tools import imatrix as PI
from tpulamm_torch.tools import passkey_train as PPK
from tpulamm_torch.tools import quality_table as PQ
from tpulamm_torch.tools import spec_bench as PSB

TEXT = ("The quick brown fox jumps over the lazy dog. An importance matrix "
        "weighs each column of a weight by the mean square of the "
        "activations that multiply it. ") * 12


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    text = d / "calib.txt"
    text.write_text(TEXT)
    return {"dir": d, "text": str(text),
            "q4_0": write_tiny_llama(str(d / "q4_0.gguf"), GGMLType.Q4_0),
            "f32": write_tiny_llama(str(d / "f32.gguf"), GGMLType.F32)}


def _imatrix_close(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if k.startswith("count::"):
            assert int(x) == int(y)
        else:
            assert x.shape == y.shape
            assert np.abs(x - y).max() <= 1e-5 * np.abs(x).max(), k


def test_densify_and_collect_imatrix(files):
    from tpulamm.models.loader import load_model as jload
    from tpulamm_torch.models.loader import load_model as pload
    jcfg, jparams, md = jload(files["q4_0"], compute_dtype="float32")
    pcfg, pparams, _ = pload(files["q4_0"], compute_dtype="float32")
    jd, pd = JI.densify_params(jparams), PI.densify_params(pparams)
    for key in ("tok_emb", "output", "out_norm"):
        assert np.array_equal(np.asarray(jd[key]), pd[key].numpy())
    for jl, pl in zip(jd["layers"], pd["layers"]):
        for key in jl:
            assert np.array_equal(np.asarray(jl[key]), pl[key].numpy())
    rng = np.random.default_rng(0)
    chunks = [rng.integers(0, 512, 48) for _ in range(2)]
    jc = JI.collect_imatrix(jd, jcfg, chunks)
    pc = PI.collect_imatrix(pd, pcfg, chunks)
    assert len(pc.sums) == 2 * 7 + 1
    _imatrix_close({**{f"sum::{k}": v for k, v in jc.sums.items()},
                    **{f"count::{k}": v for k, v in jc.counts.items()}},
                   {**{f"sum::{k}": v for k, v in pc.sums.items()},
                    **{f"count::{k}": v for k, v in pc.counts.items()}})
    for k, v in pc.column_means().items():
        np.testing.assert_allclose(v, jc.column_means()[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max())


def test_imatrix_cli_and_quantize_both_ways(files, monkeypatch):
    """Both CLIs' files agree; cli.quantize --imatrix of either package
    on the port's file writes one file."""
    monkeypatch.setattr(j_native, "get_lib", lambda: None)
    d = files["dir"]
    argv = ["-m", files["q4_0"], "-f", files["text"], "-c", "64",
            "--chunks", "3"]
    assert JI.main(argv + ["-o", str(d / "j.npz")]) == 0
    assert PI.main(argv + ["-o", str(d / "p.npz"), "--device", "cpu"]) == 0
    jz, pz = np.load(d / "j.npz"), np.load(d / "p.npz")
    _imatrix_close(dict(jz), dict(pz))
    assert int(pz["count::output.weight"]) == 3 * 64
    out = {}
    for name, mod in (("j", JQCLI), ("p", PQCLI)):
        out[name] = str(d / f"{name}_q4.gguf")
        assert mod.main(["--imatrix", str(d / "p.npz"), files["f32"],
                         out[name], "q4_0"]) == 0
    assert open(out["j"], "rb").read() == open(out["p"], "rb").read()
    plain = str(d / "plain_q4.gguf")
    assert PQCLI.main([files["f32"], plain, "q4_0"]) == 0
    assert open(plain, "rb").read() != open(out["p"], "rb").read()


def test_passkey_docs_and_training(tmp_path):
    tok_j, tok_p = JPK._tokenizer(), PPK._tokenizer()
    jd, jw = JPK.gen_docs(3, 400, tok_j, seed=2, log=lambda s: None)
    pd, pw = PPK.gen_docs(3, 400, tok_p, seed=2, log=lambda s: None)
    assert np.array_equal(jd, pd) and np.array_equal(jw, pw)
    assert (pw == 50.0).sum() > 0
    kw = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn=128,
              seq_len=256, n_steps=1, batch_size=2, n_docs=4,
              log=lambda s: None)
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    JPK.train_passkey(a, **kw)
    PPK.train_passkey(b, device="cpu", **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_passkey_evaluate(tmp_path):
    """Self-extend retrieval through each package's engine on one trained
    file: the same trials, text and result."""
    path = str(tmp_path / "pk.gguf")
    PPK.train_passkey(path, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                      ffn=128, seq_len=256, n_steps=2, batch_size=2,
                      n_docs=4, device="cpu", log=lambda s: None)
    kw = dict(n_ctx=1024, ga_n=2, ga_w=256, trials=1, n_junk=4)
    jl, pl = [], []
    want = JPK.evaluate(path, log=jl.append, **kw)
    got = PPK.evaluate(path, log=pl.append, device="cpu", **kw)
    assert got == want and pl == jl


def test_quality_table_train_flag(tmp_path, monkeypatch):
    """--train trains the model (train_model with the CLI's --steps) and
    then writes the table; the model is the JAX tool's file."""
    seen = {}
    real = PQ.train_model

    def fake_train(out, **kw):
        seen.update(kw)
        return real(out, dim=64, n_layers=1, n_heads=4, n_kv_heads=2,
                    ffn=128, seq_len=32, batch_size=2,
                    corpus=kw["corpus"][:4096], n_steps=kw["n_steps"],
                    device=kw["device"], log=lambda s: None)
    monkeypatch.setattr(PQ, "train_model", fake_train)
    monkeypatch.setattr(PQ, "quality_table",
                        lambda path, **kw: [{"format": "F32", "path": path}])
    out = str(tmp_path / "m.gguf")
    assert PQ.main(["--train", "-m", out, "--steps", "1", "--device",
                    "cpu"]) == 0
    assert seen["n_steps"] == 1 and seen["device"] == "cpu"
    JQ.train_model(str(tmp_path / "j.gguf"), dim=64, n_layers=1, n_heads=4,
                   n_kv_heads=2, ffn=128, seq_len=32, batch_size=2,
                   corpus=PQ.build_corpus()[:4096], n_steps=1,
                   log=lambda s: None)
    assert open(out, "rb").read() == \
        open(tmp_path / "j.gguf", "rb").read()


def test_spec_bench_pair(tmp_path):
    """bench_pair on a trained target / draft pair (the models of
    quality_table.train_model, cut to tiny sizes, two steps): each row's
    accept rate and tokens a step equal the JAX tool's."""
    corpus = PQ.build_corpus()
    tgt, drf = str(tmp_path / "t.gguf"), str(tmp_path / "d.gguf")
    for path, layers in ((tgt, 2), (drf, 1)):
        PQ.train_model(path, dim=64, n_layers=layers, n_heads=4,
                       n_kv_heads=2, ffn=128, seq_len=64, n_steps=2,
                       batch_size=2, corpus=corpus, device="cpu",
                       log=lambda s: None)
    kw = dict(n_predict=8, drafts=(0, 2), n_ctx=512, lookup=False)
    want = JSB.bench_pair(tgt, drf, corpus, log=lambda s: None, **kw)
    got = PSB.bench_pair(tgt, drf, corpus, log=lambda s: None,
                         device="cpu", **kw)
    assert [r["mode"] for r in got] == [r["mode"] for r in want]
    for g, w in zip(got, want):
        assert g["accept"] == w["accept"] and g["n_draft"] == w["n_draft"]
        assert g.get("tok_per_step") == w.get("tok_per_step")
        assert g["tok_s"] > 0


def test_spec_bench_models_default_device_is_cuda(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PSB.ensure_models(1, out_dir=str(tmp_path))
