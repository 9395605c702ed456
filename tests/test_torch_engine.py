"""Port parity: tpulamm_torch's Engine on the CPU against the JAX Engine,
f32 compute and KV, on tiny Q4_0 and Q8_0 GGUFs.

Prefill logits within 1e-4 * max|logit|; greedy tokens identical over 16
steps for generate_fast and for generate.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm.runtime.sampling import SamplingParams as JSamplingParams
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.runtime.sampling import SamplingParams

PROMPT = "the cat sat on the mat"


@pytest.fixture(scope="module", params=["q4_0", "q8_0"])
def engines(request, tmp_path_factory):
    qtype = getattr(GGMLType, request.param.upper())
    path = write_tiny_llama(
        str(tmp_path_factory.mktemp("m") / f"{request.param}.gguf"), qtype,
        seed=5)
    je = JEngine(path, n_ctx=64, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    te = Engine(path, n_ctx=64, compute_dtype="float32",
                kv_dtype=torch.float32, device="cpu")
    return path, je, te


def test_prefill_logits(engines):
    _, je, te = engines
    toks = je.tokenizer.encode(PROMPT, special=True)
    assert te.tokenizer.encode(PROMPT, special=True) == toks
    je.reset_slot(0)
    te.reset_slot(0)
    want = je.prefill(0, toks, logits_all=True)
    got = te.prefill(0, toks, logits_all=True)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_generate_fast_greedy_tokens(engines):
    _, je, te = engines
    want, wtext = je.generate_fast(PROMPT, n_predict=16, stop_on_eos=False)
    got, text = te.generate_fast(PROMPT, n_predict=16, stop_on_eos=False)
    assert got == want and len(got) == 16
    assert text == wtext
    # the JAX engine's state after the call: its blocks write the KV of
    # every token they carry, then roll back to the returned tokens
    assert te.n_past[0] == je.n_past[0]
    np.testing.assert_array_equal(te.cell_pos[0], je.cell_pos[0])


def test_generate_greedy_tokens(engines):
    _, je, te = engines
    je.reset_slot(0)
    te.reset_slot(0)
    want, _ = je.generate(PROMPT, n_predict=16,
                          sampling=JSamplingParams(temp=0.0),
                          stop_on_eos=False)
    got, _ = te.generate(PROMPT, n_predict=16,
                         sampling=SamplingParams(temp=0.0), stop_on_eos=False)
    assert got == want


def test_rollback_and_decode_batch(engines):
    """rollback drops the cells past n_past; a decode_batch step for the
    one slot gives the same logits as decode_one."""
    _, _, te = engines
    toks = te.tokenizer.encode(PROMPT, special=True)
    te.reset_slot(0)
    te.prefill(0, toks)
    a = te.decode_one(0, 42)
    te.rollback(0, len(toks))
    assert (te.cell_pos[0] >= 0).sum() == len(toks)
    b = te.decode_batch({0: 42})[0]
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    from tpulamm_torch.runtime import kvcache
    kvcache.clear(te.cache)
    assert (te.cache.pos == -1).all()
    te.reset_slot(0)


def test_sampled_generate_fast_is_seeded(engines):
    _, _, te = engines
    a, _ = te.generate_fast(PROMPT, n_predict=8, temp=0.8, seed=7,
                            stop_on_eos=False)
    b, _ = te.generate_fast(PROMPT, n_predict=8, temp=0.8, seed=7,
                            stop_on_eos=False)
    assert a == b and len(a) == 8


def test_cli_simple_cpu(engines, capsys):
    path, _, _ = engines
    from tpulamm_torch.cli import simple
    assert simple.main(["-m", path, "-p", "the cat", "-n", "4", "-c", "64",
                        "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("the cat")


def test_default_device_needs_cuda(engines):
    path, _, _ = engines
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(path, n_ctx=64)


# -- slice 2: q8_0 KV, several ubatches, context shift, self-extend, flash --

@pytest.fixture(scope="module")
def q4_path(tmp_path_factory):
    return write_tiny_llama(str(tmp_path_factory.mktemp("m2") / "q4.gguf"),
                            GGMLType.Q4_0, seed=5)


def _pair(path, **kw):
    jkw = {k: (jnp.float32 if v is torch.float32 else v)
           for k, v in kw.items()}
    je = JEngine(path, compute_dtype="float32", **jkw)
    te = Engine(path, compute_dtype="float32", device="cpu", **kw)
    return je, te


def test_q8_kv_prefill_and_greedy(q4_path):
    """q8_0 K and V: prefill logits within 1e-4 * max, 16 greedy tokens."""
    je, te = _pair(q4_path, n_ctx=64, kv_dtype="q8_0")
    assert te.cache.k[0].dtype == torch.int8 and te.cache.vs is not None
    toks = je.tokenizer.encode(PROMPT, special=True)
    want = je.prefill(0, toks, logits_all=True)
    got = te.prefill(0, toks, logits_all=True)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    want, _ = je.generate_fast(PROMPT, n_predict=16, stop_on_eos=False)
    got, _ = te.generate_fast(PROMPT, n_predict=16, stop_on_eos=False)
    assert got == want and len(got) == 16


def test_prompt_of_three_ubatches(q4_path):
    """40 tokens at n_ubatch 16: ubatches of 16, 16 and an 8-token tail
    (the JAX engine pads the tail to its bucket; the port runs 8 rows)."""
    je, te = _pair(q4_path, n_ctx=64, n_ubatch=16, kv_dtype=torch.float32)
    toks = list(range(3, 43))
    want = je.prefill(0, toks, logits_all=True)
    got = te.prefill(0, toks, logits_all=True)
    assert got.shape == want.shape == (40, 512)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("kw,prompt,n_predict", [
    (dict(n_ctx=32, kv_dtype="q8_0"), PROMPT, 40),
    (dict(n_ctx=32, kv_dtype=torch.float32, grp_attn_n=2, grp_attn_w=8),
     "the cat", 16)], ids=["context_shift_q8", "self_extend"])
def test_long_generation_surgery_matches_jax(q4_path, kw, prompt, n_predict):
    """Generating past the window: context shift (seq_rm + seq_add with K
    re-rotation + defrag) or self-extend (seq_add / seq_div) give the JAX
    engine's greedy tokens, host cell positions and device positions."""
    je, te = _pair(q4_path, **kw)
    want, _ = je.generate(prompt, n_predict=n_predict,
                          sampling=JSamplingParams(temp=0.0),
                          stop_on_eos=False)
    got, _ = te.generate(prompt, n_predict=n_predict,
                         sampling=SamplingParams(temp=0.0), stop_on_eos=False)
    assert got == want and len(got) == n_predict
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)
    assert te.n_past[0] == je.n_past[0] and te.ga_i[0] == je.ga_i[0]
    np.testing.assert_array_equal(te.cache.pos.numpy(),
                                  np.asarray(je.cache.pos))
    n_prompt = len(te.tokenizer.encode(prompt, special=True))
    if "grp_attn_n" in kw:
        assert te.ga_i[0] > 0                       # the window was grouped
    else:
        assert n_prompt + n_predict > 32 > te.n_past[0]     # it shifted


def test_flash_attn_q8_matches_jax_flash(q4_path):
    """flash_attn=True with a q8_0 cache: the port's plain flash version
    against the JAX Pallas kernels (interpret mode, bf16 operands) within
    3e-2, the JAX package's own forward tolerance."""
    je, te = _pair(q4_path, n_ctx=64, n_ubatch=16, kv_dtype="q8_0",
                   flash_attn=True)
    toks = list(range(3, 43))
    want = je.prefill(0, toks, logits_all=True)
    got = te.prefill(0, toks, logits_all=True)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(te.decode_one(0, 9), je.decode_one(0, 9),
                               rtol=3e-2, atol=3e-2)
