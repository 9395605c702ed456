"""Port parity for mamba (models/mamba.py and the engine's recurrent
branches) against the JAX package.

A tiny random transformers MambaForCausalLM (hidden 256, d_inner 512,
d_state 16, d_conv 4, dt_rank 16, vocab 512, 2 layers: in_proj and
out_proj tile, so they are QTensors in Q4_0) converted by the JAX
convert_hf at F32 and at Q4_0; both packages load the same file at f32
compute. Tolerances: the forward's logits within 1e-5 of max|ref| and its
conv / ssm state within 1e-5 absolute of the JAX forward's; incremental
decode within 2e-4 of the prefill (the JAX test's bound); the engines'
greedy tokens equal; a session file's arrays equal after a load either
way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("transformers")
import transformers  # noqa: E402

from _torch_port_models import write_tiny_llama  # noqa: E402
from tpulamm.gguf.constants import GGMLType  # noqa: E402
from tpulamm.models.loader import load_model as jload  # noqa: E402
from tpulamm.models.mamba import MambaState as JState  # noqa: E402
from tpulamm.models.mamba import forward as jforward  # noqa: E402
from tpulamm.runtime import session as jsession  # noqa: E402
from tpulamm.runtime.engine import Engine as JEngine  # noqa: E402
from tpulamm.tools.convert_hf import convert_hf  # noqa: E402
from tpulamm_torch.models.loader import load_model  # noqa: E402
from tpulamm_torch.models.mamba import MambaState, forward  # noqa: E402
from tpulamm_torch.ops.qtensor import QTensor  # noqa: E402
from tpulamm_torch.runtime import session  # noqa: E402
from tpulamm_torch.runtime.beam import beam_search  # noqa: E402
from tpulamm_torch.runtime.engine import Engine  # noqa: E402

VOCAB = 512
TOKENS = np.random.default_rng(3).integers(3, VOCAB, (2, 12))
QTYPES = {"f32": GGMLType.F32, "q4_0": GGMLType.Q4_0}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    torch.manual_seed(0)
    m = transformers.MambaForCausalLM(transformers.MambaConfig(
        vocab_size=VOCAB, hidden_size=256, num_hidden_layers=2,
        state_size=16, conv_kernel=4, expand=2, time_step_rank=16,
        use_cache=False)).eval()
    d = tmp_path_factory.mktemp("mamba")
    out = {}
    for name, qt in QTYPES.items():
        out[name] = str(d / f"{name}.gguf")
        convert_hf(m, out[name], qtype=qt)
    return out


def _jax(path, tokens, positions):
    cfg, params, _ = jload(path, compute_dtype="float32")
    B = tokens.shape[0]
    logits, st = jforward(params, cfg, jnp.asarray(tokens, jnp.int32),
                          jnp.asarray(positions, jnp.int32),
                          JState.create(cfg, B),
                          jnp.arange(B, dtype=jnp.int32))
    return np.asarray(logits), np.asarray(st.conv), np.asarray(st.ssm)


def _port(path, tokens, positions, slots=None, n_slots=None):
    cfg, params, _ = load_model(path, compute_dtype="float32")
    st = MambaState.create(cfg, n_slots or tokens.shape[0])
    with torch.no_grad():
        logits, _ = forward(params, cfg, torch.from_numpy(tokens),
                            torch.from_numpy(np.asarray(positions)), st,
                            slots)
    return logits.numpy(), st, params


@pytest.mark.parametrize("qtype", list(QTYPES))
def test_forward_matches_jax(paths, qtype):
    """Two rows, the second padded after 7 tokens (position -1): logits of
    the valid tokens and the carried states equal the JAX forward's."""
    pos = np.tile(np.arange(12), (2, 1))
    pos[1, 7:] = -1
    ref, conv, ssm = _jax(paths[qtype], TOKENS, pos)
    got, st, params = _port(paths[qtype], TOKENS, pos)
    assert isinstance(params["layers"][0]["ssm_in"], QTensor) == (
        qtype == "q4_0")
    valid = pos >= 0
    err = np.abs(got[valid] - ref[valid]).max() / np.abs(ref[valid]).max()
    assert err <= 1e-5, err
    np.testing.assert_allclose(st.conv.numpy(), conv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.ssm.numpy(), ssm, rtol=0, atol=1e-5)


def test_incremental_decode_matches_prefill(paths):
    """One token at a time through the carried state (an int slot of a
    three-slot state) equals the whole-sequence forward."""
    tok = TOKENS[:1]
    full, _, params = _port(paths["q4_0"], tok, np.arange(12)[None])
    cfg, _, _ = load_model(paths["q4_0"], compute_dtype="float32")
    st = MambaState.create(cfg, 3)
    outs = []
    with torch.no_grad():
        for t in range(tok.shape[1]):
            lg, _ = forward(params, cfg, torch.from_numpy(tok[:, t:t + 1]),
                            torch.full((1, 1), t), st, 2)
            outs.append(lg[:, 0].numpy())
    np.testing.assert_allclose(np.stack(outs, 1), full, rtol=2e-4,
                               atol=2e-4)
    assert float(st.conv[:, :2].abs().max()) == 0.0     # other slots


def test_padding_and_slot_ids_leave_other_rows(paths):
    """A row at position -1 leaves its state bit for bit; a tensor of slot
    ids gathers and scatters the rows it names only."""
    cfg, params, _ = load_model(paths["q4_0"], compute_dtype="float32")
    st = MambaState.create(cfg, 4)
    st.conv.normal_()
    st.ssm.normal_()
    before = (st.conv.clone(), st.ssm.clone())
    tok = torch.from_numpy(TOKENS[:, :3])
    pos = torch.tensor([[0, 1, 2], [-1, -1, -1]])
    with torch.no_grad():
        forward(params, cfg, tok, pos, st, torch.tensor([3, 1]))
    for now, was in zip((st.conv, st.ssm), before):
        assert torch.equal(now[:, [0, 1, 2]], was[:, [0, 1, 2]])
        assert not torch.equal(now[:, 3], was[:, 3])


def _engines(path, n_slots=1, n_ctx=128):
    je = JEngine(path, n_ctx=n_ctx, n_slots=n_slots, compute_dtype="float32")
    te = Engine(path, n_ctx=n_ctx, n_slots=n_slots, compute_dtype="float32",
                device="cpu")
    return je, te


def test_engine_generate_fast_matches_jax(paths):
    """generate_fast's greedy tokens through the step graphs' blocks equal
    the JAX engine's scan blocks; n_predict 17 is one 16-step block in
    both. At n_predict 12 the port runs an 11-step block (a recurrent
    state is not rolled back; the JAX engine's rollback after its 16-step
    block raises) and gives the first 12 of the same tokens."""
    je, te = _engines(paths["q4_0"])
    prompt = TOKENS[0].tolist()
    j17, _ = je.generate_fast(prompt, n_predict=17, stop_on_eos=False)
    t17, _ = te.generate_fast(prompt, n_predict=17, stop_on_eos=False)
    assert t17 == j17
    assert int(te.n_past[0]) == int(je.n_past[0]) == len(prompt) + 16
    t12, _ = te.generate_fast(prompt, n_predict=12, stop_on_eos=False)
    assert t12 == j17[:12]
    assert int(te.n_past[0]) == len(prompt) + 11
    with pytest.raises(NotImplementedError):
        je.generate_fast(prompt, n_predict=12, stop_on_eos=False)


def test_eos_inside_a_block_leaves_the_returned_state(paths):
    """An EOS before a block's last step: the slot's state and n_past hold
    the prompt and the returned tokens, as a fresh prefill of them does
    (within 2e-4, incremental against prefill)."""
    _, te = _engines(paths["q4_0"])
    prompt = TOKENS[0].tolist()
    t17, _ = te.generate_fast(prompt, n_predict=17, stop_on_eos=False)
    k = next(i for i in range(2, 15) if t17[i] not in t17[:i])
    te._eos = lambda: t17[k]
    out, _ = te.generate_fast(prompt, n_predict=17)
    assert out == t17[:k]
    assert int(te.n_past[0]) == len(prompt) + k
    ref = Engine(paths["q4_0"], n_ctx=128, compute_dtype="float32",
                 device="cpu")
    ref.reset_slot(0)
    ref.prefill(0, prompt + out)
    for got, want in ((te.cache.conv, ref.cache.conv),
                      (te.cache.ssm, ref.cache.ssm)):
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0].numpy(),
                                   rtol=0, atol=2e-4)


def test_engine_batch_and_embed_match_jax(paths):
    """decode_batch_fast over two slots (the full batch, no compaction)
    and the headless embed equal the JAX engine's."""
    je, te = _engines(paths["q4_0"], n_slots=2)
    for eng in (je, te):
        for s in (0, 1):
            eng.reset_slot(s)
            eng.prefill(s, TOKENS[s].tolist())
    jb = je.decode_batch_fast({0: 5, 1: 9}, 16)
    tb = te.decode_batch_fast({0: 5, 1: 9}, 16)
    assert tb == jb
    assert te._b_rows([0]) is None and te._kv_span(4) is None
    jv = je.embed(TOKENS[1].tolist(), pooling="mean")
    tv = te.embed(TOKENS[1].tolist(), pooling="mean")
    np.testing.assert_allclose(tv, jv, rtol=0,
                               atol=1e-5 * np.abs(jv).max())


def test_session_round_trip_both_ways(paths, tmp_path):
    """A recurrent session file (MAGIC + "-recurrent") from either package
    loads in the other into the engine's buffers in place; the continued
    greedy steps agree."""
    je, te = _engines(paths["q4_0"], n_slots=2)
    prompt = TOKENS[0].tolist()
    for eng in (je, te):
        eng.reset_slot(0)
        eng.prefill(0, prompt)
    fp, fj = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    session.save_session(fp, te, prompt)
    jsession.save_session(fj, je, prompt)
    za, zb = np.load(fp), np.load(fj)
    assert (str(za["magic"]) == str(zb["magic"])
            == "tpulamm-session-v2-recurrent")
    np.testing.assert_allclose(za["ssm"], zb["ssm"], rtol=0, atol=1e-5)
    je2, te2 = _engines(paths["q4_0"], n_slots=2)
    conv = te2.cache.conv
    assert jsession.load_session(fp, je2) == prompt
    assert session.load_session(fj, te2) == prompt
    assert te2.cache.conv is conv
    np.testing.assert_array_equal(te2.cache.ssm.numpy(), zb["ssm"])
    np.testing.assert_array_equal(np.asarray(je2.cache.conv), za["conv"])
    assert int(te2.n_past[0]) == len(prompt)
    tok = [int(np.argmax(te2.decode_one(0, 7)))]
    jt = [int(np.argmax(je2.decode_one(0, 7)))]
    assert tok == jt
    llama = Engine(write_tiny_llama(str(tmp_path / "l.gguf")), n_ctx=64,
                   device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        session.load_session(fp, llama)


def test_recurrent_refusals_match_jax(paths):
    """rollback, position surgery, beam forks, eval_embeds, eval_segmented,
    the sampled block and speculation raise as in the JAX engine; context
    shift and defrag do nothing; seq_cp copies the state rows."""
    je, te = _engines(paths["q4_0"], n_slots=2)
    for eng in (je, te):
        eng.reset_slot(0)
        eng.prefill(0, TOKENS[0].tolist())
        with pytest.raises(NotImplementedError):
            eng.rollback(0, 3)
        with pytest.raises(NotImplementedError):
            eng.seq_rm(0, 3)
        with pytest.raises(AssertionError):
            eng.eval_embeds(0, np.zeros((2, 256), np.float32))
        with pytest.raises(AssertionError):
            eng.eval_segmented(0, np.array([1]), np.array([12]),
                               np.array([0]))
        eng._maybe_shift(0)
        eng.defrag()
    with pytest.raises(AssertionError, match="copyable"):
        beam_search(te, TOKENS[0].tolist(), n_beams=2, n_predict=4)
    from tpulamm.runtime import sampling as jsampling
    from tpulamm_torch.runtime import sampling
    with pytest.raises(ValueError, match="non-recurrent"):
        te.decode_batch_sampled({0: 1}, 16, {0: sampling.Sampler(
            sampling.SamplingParams(), VOCAB)})
    with pytest.raises(ValueError, match="non-recurrent"):
        je.decode_batch_sampled({0: 1}, 16, {0: jsampling.Sampler(
            jsampling.SamplingParams(), VOCAB)})
    with pytest.raises(ValueError, match="non-recurrent"):
        te.spec_lookup_block(0, 1, TOKENS[0].tolist(), 4, 2, 8, 2)
    assert te.mega is None
    te.seq_cp(0, 1)
    assert torch.equal(te.cache.ssm[:, 1], te.cache.ssm[:, 0])
    assert int(te.n_past[1]) == int(te.n_past[0])
