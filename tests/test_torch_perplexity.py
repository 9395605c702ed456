"""The port's quality path against the JAX package's on the CPU: every
perplexity mode (chunked, strided with both output types, the choice
tasks), save_logits / kl_divergence, the perplexity CLI and
tools.quality_table, on the tiny llama of tests/_torch_port_models.py
(F32 and Q4_0), both engines with f32 compute and an f32 cache.

Tolerances: ppl, nll and choice scores within 1e-4 relative (f32 logits
that agree to ~1e-6 of their size, summed in float64); the saved float16
log-probs within 1e-2 (one float16 step at |logprob| < 16 is <= 7.8e-3,
and an f32 difference can move a value across one rounding boundary);
KL against one saved base within 1e-6 + 1e-3 relative; the quality
table's KL within 1e-5 + 1e-2 relative (each package saves its own F32
base as float16, their roundings can differ by one float16 step, and KL =
E_p[base - current] takes that step in full: 2.4e-6 of 7.6e-4 in Q8_0 on
this model); token counts, accuracies and top-1 agreement exact."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_models import write_tiny_llama
from tpulamm.cli import perplexity as JP
from tpulamm.gguf.constants import GGMLType
from tpulamm.quant import native as j_native
from tpulamm.runtime import engine as j_engine
from tpulamm.tools import quality_table as JQ
from tpulamm_torch.cli import perplexity as PP
from tpulamm_torch.runtime import engine as p_engine
from tpulamm_torch.tools import quality_table as PQ

CORPUS = ("The quick brown fox jumps over the lazy dog. " * 3
          + "Perplexity is the exponential of the mean negative log "
          "likelihood of each next token given the ones before it. "
          "A quantized model that keeps its perplexity close to the "
          "full-precision one has lost little. ") * 2
REL = 1e-4


def _close(a, b, rel=REL):
    return abs(a - b) <= rel * abs(b)


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def engines(request, tmp_path_factory):
    qtype = getattr(GGMLType, request.param.upper())
    path = write_tiny_llama(
        str(tmp_path_factory.mktemp("ppl") / f"{request.param}.gguf"), qtype,
        seed=3)
    je = j_engine.Engine(path, n_ctx=64, compute_dtype="float32",
                         kv_dtype=jnp.float32)
    te = p_engine.Engine(path, n_ctx=64, compute_dtype="float32",
                         kv_dtype=torch.float32, device="cpu")
    return path, je, te


def test_compute_perplexity(engines):
    _, je, te = engines
    want = JP.compute_perplexity(je, CORPUS, n_ctx=64, progress=False)
    got = PP.compute_perplexity(te, CORPUS, n_ctx=64, progress=False)
    assert got["tokens"] == want["tokens"] > 0
    assert _close(got["ppl"], want["ppl"]) and _close(got["nll"], want["nll"])
    toks = list(range(3, 3 + 130))           # pre-tokenized corpus
    want = JP.compute_perplexity(je, "", n_ctx=64, progress=False, tokens=toks)
    got = PP.compute_perplexity(te, "", n_ctx=64, progress=False, tokens=toks)
    assert got["tokens"] == want["tokens"] and _close(got["ppl"], want["ppl"])


@pytest.mark.parametrize("output_type", [0, 1])
def test_compute_perplexity_v2(engines, output_type, capsys):
    _, je, te = engines
    want = JP.compute_perplexity_v2(je, CORPUS, n_ctx=64, stride=16,
                                    output_type=output_type, progress=False)
    out_j = capsys.readouterr().out.split()
    got = PP.compute_perplexity_v2(te, CORPUS, n_ctx=64, stride=16,
                                   output_type=output_type, progress=False)
    out_p = capsys.readouterr().out.split()
    assert got["tokens"] == want["tokens"] and _close(got["ppl"], want["ppl"])
    assert len(out_p) == len(out_j) == (0 if output_type == 0 else
                                        2 * (got["tokens"] // 16))
    for a, b in zip(out_p, out_j):
        assert _close(float(a), float(b), 2e-4)   # printed to 4 decimals


def _tasks(tmp_path):
    hs = tmp_path / "hellaswag.jsonl"
    hs.write_text("\n".join(json.dumps(t) for t in [
        {"ctx": "The cat sat on", "endings": ["the mat.", "a dog.",
                                              "the moon."], "label": 0},
        {"ctx": "She poured the water", "endings": [" into a glass",
                                                    "up the hill"],
         "label": 0}]) + "\n")
    wg = tmp_path / "winogrande.jsonl"
    wg.write_text(json.dumps({"sentence": "_ did not fit: too big.",
                              "option1": "the cat", "option2": "the mat",
                              "answer": "1"}) + "\n")
    mc = tmp_path / "mc.jsonl"
    mc.write_text(json.dumps({"question": "Which is a colour?",
                              "choices": ["red", "seven", "run"],
                              "label": 0}) + "\n")
    return str(hs), str(wg), str(mc)


def test_choice_tasks(engines, tmp_path):
    _, je, te = engines
    want = JP.score_choices(je, "The cat sat on", [" the mat", " a dog"])
    got = PP.score_choices(te, "The cat sat on", [" the mat", " a dog"])
    assert all(_close(g, w) for g, w in zip(got, want))
    hs, wg, mc = _tasks(tmp_path)
    for name, path in (("run_hellaswag", hs), ("run_winogrande", wg),
                       ("run_multiple_choice", mc)):
        assert getattr(PP, name)(te, path) == getattr(JP, name)(je, path)
    assert PP.run_hellaswag(te, hs, limit=1)["total"] == 1


def test_save_logits_and_kl(engines, tmp_path):
    _, je, te = engines
    a, b = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    JP.save_logits(je, CORPUS, a, n_ctx=64, max_chunks=2)
    PP.save_logits(te, CORPUS, b, n_ctx=64, max_chunks=2)
    zj, zp = np.load(a), np.load(b)
    assert int(zp["n_ctx"]) == int(zj["n_ctx"]) == 64
    np.testing.assert_array_equal(zp["tokens"], zj["tokens"])
    assert zp["logprobs"].dtype == np.float16
    assert zp["logprobs"].shape == zj["logprobs"].shape
    assert np.abs(zp["logprobs"].astype(np.float32)
                  - zj["logprobs"].astype(np.float32)).max() <= 1e-2
    want = JP.kl_divergence(je, a)
    got = PP.kl_divergence(te, a)
    assert got["tokens"] == want["tokens"]
    assert got["top1_agree"] == want["top1_agree"]
    for k in ("kl_mean", "kl_max", "kl_p99"):
        assert abs(got[k] - want[k]) <= 1e-6 + 1e-3 * abs(want[k])


def test_perplexity_cli(engines, tmp_path, capsys):
    path = engines[0]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(CORPUS)
    common = ["-m", path, "-c", "64", "--compute-dtype", "float32",
              "-ctk", "float32"]
    for mode in (["-f", str(corpus)],
                 ["-f", str(corpus), "--ppl-stride", "32"]):
        assert JP.main([*common, *mode]) == 0
        out_j = capsys.readouterr()
        assert PP.main([*common, *mode, "--device", "cpu"]) == 0
        out_p = capsys.readouterr()
        last_j, last_p = out_j.out.splitlines()[-1], out_p.out.splitlines()[-1]
        assert last_p.startswith("Final estimate: PPL = ")
        assert _close(float(last_p.split()[-1]), float(last_j.split()[-1]),
                      2e-4)
        # Timings.report on stderr: the same lines, other times
        assert ([ln.split("=")[0] for ln in out_p.err.splitlines()
                 if " time = " in ln]
                == [ln.split("=")[0] for ln in out_j.err.splitlines()
                    if " time = " in ln])


def test_timings_report():
    t = p_engine.Timings(t_load=0.5, t_prefill=0.25, n_prefill=100,
                         t_eval=0.125, n_eval=10, t_sample=0.01, n_sample=10)
    want = j_engine.Timings(t_load=0.5, t_prefill=0.25, n_prefill=100,
                            t_eval=0.125, n_eval=10, t_sample=0.01,
                            n_sample=10).report()
    assert t.report() == want
    assert p_engine.Timings().report() == j_engine.Timings().report()


def test_quality_table(tmp_path_factory, monkeypatch):
    """Both tools on one F32 file (n_ctx 64, 2 chunks, the corpus passed
    in), their Engines in f32 compute; the JAX tool quantizes with its
    numpy quantizers (tests/test_torch_quantize_cli.py says why)."""
    monkeypatch.setattr(j_native, "get_lib", lambda: None)

    def f32(cls, **fixed):
        return lambda path, **kw: cls(path, compute_dtype="float32",
                                      **{**kw, **fixed})
    monkeypatch.setattr(j_engine, "Engine", f32(j_engine.Engine))
    monkeypatch.setattr(p_engine, "Engine", f32(p_engine.Engine,
                                                device="cpu"))
    corpus = (CORPUS * 20).encode()
    rows = {}
    for tag, mod in (("jax", JQ), ("port", PQ)):
        d = tmp_path_factory.mktemp(f"qt_{tag}")
        path = write_tiny_llama(str(d / "f32.gguf"), GGMLType.F32, seed=3)
        rows[tag] = mod.quality_table(path, corpus=corpus, n_ctx=64,
                                      n_chunks=2, log=lambda *a: None)
    assert [r["format"] for r in rows["port"]] == (
        ["F32"] + list(PQ.FORMATS))
    for got, want in zip(rows["port"], rows["jax"]):
        assert got["format"] == want["format"]
        assert _close(got["ppl"], want["ppl"])
        assert abs(got["dppl"] - want["dppl"]) <= REL * want["ppl"]
        assert abs(got["kl"] - want["kl"]) <= 1e-5 + 1e-2 * abs(want["kl"])
        assert got["top1_agree"] == want["top1_agree"]


def test_build_corpus_and_vocab(tmp_path):
    a, b, c = tmp_path / "a.md", tmp_path / "b.bin", tmp_path / "c.md"
    a.write_bytes(b"plain text\n" * 10)
    b.write_bytes(bytes(range(256)) * 4)          # binary: skipped
    c.write_bytes(b"more prose\n" * 5)
    got = PQ.build_corpus(paths=[a, b, c, tmp_path / "missing.md"])
    assert got == a.read_bytes() + b"\n" + c.read_bytes()
    assert PQ.build_corpus(max_bytes=15, paths=[a, c]) == a.read_bytes()[:15]
    repo = PQ.build_corpus()
    assert len(repo) > 40_000            # the repository's prose
    assert PQ.byte_vocab() == JQ.byte_vocab()
    # train_model at a tiny size, one step (lr 0 at the schedule's first
    # count): the JAX tool's file byte for byte
    kw = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn=128,
              seq_len=32, n_steps=1, batch_size=2, corpus=repo[:20_000],
              log=lambda s: None)
    JQ.train_model(str(tmp_path / "j.gguf"), **kw)
    PQ.train_model(str(tmp_path / "p.gguf"), device="cpu", **kw)
    assert (tmp_path / "j.gguf").read_bytes() == \
        (tmp_path / "p.gguf").read_bytes()
