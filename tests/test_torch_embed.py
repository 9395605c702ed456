"""Port parity for the Engine methods the server needs: `embed` in its four
poolings, `move_slot` followed by `decode_batch`, `token_pieces` and
`newline_id`, against the JAX Engine on tiny Q4_0 / Q8_0 GGUFs (f32
compute and KV).

Embeddings: max |diff| <= 1e-4 of max |v| (short texts go through the
int8 gemv on both sides, as in the JAX dispatch); logits within 1e-4 of
max |logit|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm_torch.runtime.engine import Engine

TEXTS = ["the cat", "the cat sat on the mat and looked at the dog " * 3]


@pytest.fixture(scope="module", params=["q4_0", "q8_0"])
def engines(request, tmp_path_factory):
    qtype = getattr(GGMLType, request.param.upper())
    path = write_tiny_llama(
        str(tmp_path_factory.mktemp("e") / f"{request.param}.gguf"), qtype,
        seed=5)
    je = JEngine(path, n_ctx=128, n_slots=2, n_ubatch=32,
                 compute_dtype="float32", kv_dtype=jnp.float32)
    te = Engine(path, n_ctx=128, n_slots=2, n_ubatch=32,
                compute_dtype="float32", kv_dtype=torch.float32, device="cpu")
    return je, te


@pytest.mark.parametrize("pooling", ["mean", "cls", "last", "none", None])
@pytest.mark.parametrize("text", TEXTS, ids=["short", "four_ubatches"])
def test_embed_matches_jax(engines, pooling, text):
    je, te = engines
    want = je.embed(text, pooling=pooling, slot=1)
    got = te.embed(text, pooling=pooling, slot=1)
    assert got.shape == want.shape
    assert got.shape[-1] == 256
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # the slot holds the text afterwards, as in the JAX engine
    assert te.n_past[1] == je.n_past[1]
    np.testing.assert_array_equal(te.cell_pos[1], je.cell_pos[1])


def test_embed_token_ids_and_lm_head_untouched(engines):
    """A token list embeds like its text; the engine's lm head is still
    there for the next prefill."""
    je, te = engines
    toks = te.tokenizer.encode(TEXTS[0], special=True)
    np.testing.assert_array_equal(te.embed(toks), te.embed(TEXTS[0]))
    assert te.params.get("output") is not None
    te.reset_slot(0)
    je.reset_slot(0)
    got, want = te.prefill(0, toks), je.prefill(0, toks)
    assert got.shape == (te.cfg.vocab_size,)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_move_slot_then_decode_batch(engines):
    """A slot moved from 1 to 0 decodes as the JAX engine's moved slot."""
    je, te = engines
    toks = te.tokenizer.encode("the cat sat", special=True)
    for e in (je, te):
        e.reset_slot(0)
        e.reset_slot(1)
        e.prefill(1, toks)
        e.move_slot(1, 0)
    assert te.n_past.tolist() == je.n_past.tolist()
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)
    tok = 42
    for _ in range(3):
        want = je.decode_batch({0: tok})[0]
        got = te.decode_batch({0: tok})[0]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        assert int(np.argmax(got)) == int(np.argmax(want))
        tok = int(np.argmax(want))
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)
    assert te.n_past.tolist() == je.n_past.tolist()
    te.move_slot(0, 0)                 # a no-op
    assert te.n_past[0] == je.n_past[0]


def test_token_pieces_and_newline_id(engines):
    je, te = engines
    assert te.token_pieces() == je.token_pieces()
    assert len(te.token_pieces()) == te.cfg.vocab_size
    assert te.newline_id() == je.newline_id()


def test_forward_without_head_returns_hidden_states(engines):
    """forward() returns the final-norm hidden states (f32) when the
    params have no lm head, as the JAX forward does."""
    from tpulamm_torch.models.transformer import forward
    _, te = engines
    params = {k: v for k, v in te.params.items() if k != "output"}
    te.reset_slot(0)
    t = torch.tensor([[1, 5, 9]])
    pos = torch.arange(3)[None]
    with torch.no_grad():
        h, _ = forward(params, te.cfg, t, pos, te.cache, 0, pos)
    assert h.shape == (1, 3, 256) and h.dtype == torch.float32
    te.reset_slot(0)
