"""The Gemma path at head dim 256 on the CPU: a 2-layer Gemma file (dim
512, 4 query heads of 256 over 2 KV heads, so n_head x head_dim = 1024 is
not dim; a tied Q4_0 head) written by tools.synth.write_family_gguf,
through both Engines at f32 compute with flash_attn=True and a prompt of
three ubatches, so every ubatch and decode step takes the flash wrappers
(the port's plain version here; the card's hd-256 kernels are held to it
by tests/test_torch_cuda.py and chip_smoke.py).

- Against the JAX engine's f32 attention (flash_attn=False: its einsum
  path): the prefill logits of every row within 1e-5 of max|ref|, and
  the greedy tokens of generate_fast equal.
- Against the JAX engine with flash_attn=True, its Pallas kernels in
  interpret mode, which round q, K, V and p to bf16
  (tpulamm/ops/flash_attention.py:64-114): the prefill logits within
  3e-2, the JAX package's own tolerance for its flash kernels
  (tests/test_flash_attention.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulamm.runtime.engine import Engine as JEngine
from tpulamm_torch.ops import flash_attention as FA
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.tools.synth import write_family_gguf

N_CTX, N_UBATCH, N_PREDICT = 256, 64, 8
TOL = 1e-5          # of max|ref|, f32 compute


@pytest.fixture(scope="module")
def gemma(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gemma") / "gemma_hd256.gguf")
    write_family_gguf(path, "gemma", np.random.default_rng(5), n_layers=2,
                      dim=512, ffn=1536, n_head=4, head_dim=256, n_kv=2)
    prompt = np.random.default_rng(6).integers(3, 1000, size=150).tolist()
    return path, prompt


def _port(path):
    eng = Engine(path, n_ctx=N_CTX, n_ubatch=N_UBATCH,
                 compute_dtype="float32", kv_dtype=torch.float32,
                 flash_attn=True, device="cpu")
    assert (eng.cfg.head_dim, eng.cfg.n_heads, eng.cfg.n_kv_heads,
            eng.cfg.dim) == (256, 4, 2, 512)
    return eng


def _jax(path, flash):
    return JEngine(path, n_ctx=N_CTX, n_ubatch=N_UBATCH,
                   compute_dtype="float32", kv_dtype=jnp.float32,
                   flash_attn=flash)


def test_gemma_hd256_logits_match_jax(gemma, monkeypatch):
    """Every prefill ubatch runs the flash path at hd 256 (T * G = 128
    rows a full ubatch), and the logits agree with both JAX paths."""
    path, prompt = gemma
    seen = []
    real = FA.flash_attention_ref

    def recorder(q, *a, **kw):
        seen.append(tuple(q.shape))
        return real(q, *a, **kw)
    monkeypatch.setattr(FA, "flash_attention_ref", recorder)
    got = _port(path).prefill(0, prompt, logits_all=True)
    # 3 ubatches (64, 64, 22 tokens) x 2 layers, (B, Hkv, T * G, hd)
    assert seen == [(1, 2, 128, 256)] * 4 + [(1, 2, 44, 256)] * 2
    want = np.asarray(_jax(path, False).prefill(0, prompt, logits_all=True))
    assert got.shape == want.shape == (len(prompt), 1024)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    want_fa = np.asarray(_jax(path, True).prefill(0, prompt,
                                                  logits_all=True))
    np.testing.assert_allclose(got, want_fa, rtol=3e-2, atol=3e-2)


def test_gemma_hd256_greedy_tokens_match_jax(gemma):
    """generate_fast's greedy tokens, n_past and cell positions: the port
    (flash wrappers at hd 256) against the JAX engine's f32 path."""
    path, prompt = gemma
    te, je = _port(path), _jax(path, False)
    got, _ = te.generate_fast(prompt, n_predict=N_PREDICT,
                              stop_on_eos=False)
    want, _ = je.generate_fast(prompt, n_predict=N_PREDICT,
                               stop_on_eos=False)
    assert got == want and len(got) == N_PREDICT
    assert np.array_equal(te.n_past, np.asarray(je.n_past))
    assert np.array_equal(te.cell_pos, np.asarray(je.cell_pos))
