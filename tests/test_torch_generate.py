"""Port parity for the generation surface: tpulamm_torch's Engine.generate
(stream, stop_tokens, grammar, classifier-free guidance, seeded sampling),
--override-kv (parse_kv_override, load_model(kv_overrides=)) and the abort
callback (prefill, generate, generate_fast, model load), against the JAX
Engine on a tiny Q4_0 GGUF, f32 compute and KV.

Tolerances: equal tokens and text; logits within 1e-4 of max |logit|; the
overridden rope base's logits cosine >= 0.9999 between the packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.models.loader import parse_kv_override as jparse
from tpulamm.runtime.engine import AbortError as JAbortError
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm.runtime.sampling import SamplingParams as JSP
from tpulamm_torch.models.loader import parse_kv_override
from tpulamm_torch.runtime.engine import AbortError, Engine
from tpulamm_torch.runtime.sampling import SamplingParams

PROMPT = "the cat sat on the mat"
F32 = dict(compute_dtype="float32")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(
        str(tmp_path_factory.mktemp("gen") / "q4.gguf"), GGMLType.Q4_0,
        seed=5)


@pytest.fixture(scope="module")
def engines(path):
    je = JEngine(path, n_ctx=128, n_slots=2, kv_dtype=jnp.float32, **F32)
    te = Engine(path, n_ctx=128, n_slots=2, kv_dtype=torch.float32,
                device="cpu", **F32)
    return je, te


@pytest.mark.parametrize("sampling", [
    dict(temp=0.0), dict(temp=0.8, seed=42),
    dict(temp=1.0, seed=7, top_k=0, top_p=1.0, min_p=0.0,
         penalty_repeat=1.3)],
    ids=["greedy", "sampled", "sampled_penalties"])
def test_generate_stream_matches_jax(engines, sampling):
    je, te = engines
    pieces = []
    je.reset_slot(0)
    te.reset_slot(0)
    want = je.generate(PROMPT, n_predict=16, sampling=JSP(**sampling),
                       stop_on_eos=False)
    got = te.generate(PROMPT, n_predict=16,
                      sampling=SamplingParams(**sampling), stop_on_eos=False,
                      stream=pieces.append)
    assert got == want and len(got[0]) == 16
    assert "".join(pieces) == got[1]
    assert te.n_past[0] == je.n_past[0]
    np.testing.assert_array_equal(te.cell_pos[0], je.cell_pos[0])


def test_stop_tokens(engines):
    je, te = engines
    te.reset_slot(0)
    free, _ = te.generate(PROMPT, n_predict=12,
                          sampling=SamplingParams(temp=0.0),
                          stop_on_eos=False)
    stop = {free[5]}
    out = []
    for eng, SP in ((je, JSP), (te, SamplingParams)):
        eng.reset_slot(0)
        out.append(eng.generate(PROMPT, n_predict=12, sampling=SP(temp=0.0),
                                stop_tokens=stop, stop_on_eos=False))
    assert out[1] == out[0]
    assert out[1][0] == free[:free.index(free[5])]


@pytest.mark.parametrize("grammar", [
    'root ::= [a-z]+ " " [0-9]+', 'root ::= ("yes" | "no") "."'])
@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_grammar(engines, grammar, temp):
    from tpulamm_torch.grammar.engine import Grammar
    je, te = engines
    out = []
    for eng, SP in ((je, JSP), (te, SamplingParams)):
        eng.reset_slot(0)
        out.append(eng.generate(PROMPT, n_predict=12,
                                sampling=SP(temp=temp, seed=3),
                                grammar=grammar))
    assert out[1] == out[0]
    g = Grammar.from_gbnf(grammar)
    g.accept_token(out[1][1].encode())
    assert g.stacks, out[1][1]          # the text is a prefix of the language


@pytest.mark.parametrize("neg", ["a b c", [1, 300, 301, 302]],
                         ids=["text", "ids"])
def test_cfg(engines, neg):
    je, te = engines
    out = []
    for eng, SP in ((je, JSP), (te, SamplingParams)):
        eng.reset_slot(0)
        out.append(eng.generate(PROMPT, n_predict=12, sampling=SP(temp=0.0),
                                cfg_negative_prompt=neg, cfg_scale=1.5,
                                stop_on_eos=False))
        assert eng.n_past[1] == eng.n_past[0] - len(
            eng.tokenizer.encode(PROMPT, special=True)) + (
            len(eng.tokenizer.encode(neg, special=True))
            if isinstance(neg, str) else len(neg))
    assert out[1] == out[0]
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)


def test_cfg_needs_a_second_slot(path):
    te = Engine(path, n_ctx=64, device="cpu", **F32)
    with pytest.raises(AssertionError, match="CFG needs a free slot"):
        te.generate(PROMPT, n_predict=2, cfg_negative_prompt="a",
                    cfg_scale=1.5)


@pytest.mark.parametrize("item", [
    "llama.rope.freq_base=float:1000000", "a.b=int:42", "x=bool:true",
    "x=bool:0", "x=bool:Yes", "name=str:hello:world", "k=float:-2.5e-3",
    "nokey", "k=float", "k=complex:1", "=int:1", "k=int:", "k=int:1.5"])
def test_parse_kv_override(item):
    try:
        want = jparse(item)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_kv_override(item)
        assert str(got.value) == str(e)
        return
    got = parse_kv_override(item)
    assert got == want and type(got[1]) is type(want[1])


def test_override_freq_base_moves_logits_as_jax(path):
    toks = None
    logits = {}
    for ov in (None, {"llama.rope.freq_base": 1e6}):
        je = JEngine(path, n_ctx=64, kv_dtype=jnp.float32, kv_overrides=ov,
                     **F32)
        te = Engine(path, n_ctx=64, kv_dtype=torch.float32, kv_overrides=ov,
                    device="cpu", **F32)
        assert te.cfg.rope.freq_base == je.cfg.rope.freq_base
        toks = toks or te.tokenizer.encode(PROMPT * 3, special=True)
        want = je.prefill(0, toks, logits_all=True)
        got = te.prefill(0, toks, logits_all=True)
        a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        logits[ov is None] = got
    assert te.cfg.rope.freq_base == 1e6
    # the override moves the later positions' logits
    assert np.abs(logits[True][-1] - logits[False][-1]).max() > 1e-3


def _counter(n_ok):
    calls = {"n": 0}

    def abort():
        calls["n"] += 1
        return calls["n"] > n_ok
    return abort


@pytest.mark.parametrize("n_ok", [1, 2])
def test_abort_prefill(path, n_ok):
    """The callback is asked before each ubatch: AbortError at ubatch
    n_ok + 1, after the same n_past on both engines."""
    je = JEngine(path, n_ctx=64, n_ubatch=8, kv_dtype=jnp.float32, **F32)
    te = Engine(path, n_ctx=64, n_ubatch=8, kv_dtype=torch.float32,
                device="cpu", **F32)
    je.set_abort_callback(_counter(n_ok))
    te.set_abort_callback(_counter(n_ok))
    with pytest.raises(JAbortError):
        je.prefill(0, list(range(3, 27)))
    with pytest.raises(AbortError, match="aborted by callback"):
        te.prefill(0, list(range(3, 27)))
    assert te.n_past[0] == je.n_past[0] == 8 * n_ok
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)


def test_abort_generate_partial_and_slot_valid(engines):
    je, te = engines
    out = []
    for eng, SP in ((je, JSP), (te, SamplingParams)):
        eng.reset_slot(0)
        eng.set_abort_callback(_counter(3))
        try:
            out.append(eng.generate(PROMPT, n_predict=32,
                                    sampling=SP(temp=0.0),
                                    stop_on_eos=False))
        finally:
            eng.set_abort_callback(None)
    assert out[1] == out[0]
    assert 0 < len(out[1][0]) < 32              # the partial output
    assert te.n_past[0] == je.n_past[0]
    want = je.decode_one(0, out[0][0][-1])
    got = te.decode_one(0, out[1][0][-1])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("n_ok", [1, 2], ids=["before_blocks",
                                              "after_one_block"])
def test_abort_generate_fast(engines, n_ok):
    je, te = engines
    out = []
    for eng in (je, te):
        eng.set_abort_callback(_counter(n_ok))
        try:
            out.append(eng.generate_fast(PROMPT, n_predict=81,
                                         stop_on_eos=False))
        finally:
            eng.set_abort_callback(None)
    assert out[1] == out[0]
    # 81 tokens decode as blocks of 64 and 16 steps
    assert len(out[1][0]) == (1 if n_ok == 1 else 1 + 64)
    assert te.n_past[0] == je.n_past[0]
    np.testing.assert_array_equal(te.cell_pos[0], je.cell_pos[0])


def test_model_load_cancel(path):
    with pytest.raises(JAbortError):
        JEngine(path, load_abort=lambda: True)
    with pytest.raises(AbortError, match="model load cancelled"):
        Engine(path, load_abort=lambda: True, device="cpu")
    # a load whose callback never fires completes
    te = Engine(path, n_ctx=32, load_abort=lambda: False, device="cpu")
    assert len(te.params["layers"]) == 2
