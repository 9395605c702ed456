"""The port's decode blocks (runtime/decode_graph.py) on the CPU against the
JAX engine's compiled decode block, on the tiny Q4_0 model of
_torch_port_models (seed 5), f32 compute.

generate_fast gives the JAX engine's greedy tokens and leaves its state:
n_past and the host cell positions equal, and the device cell positions
of the slot equal, after blocks that over-run and a rollback, for
n_predict 3, 5, 16, 17, 49 and 272 (two blocks, 256 + 16, no over-run;
Timings.n_step counts the whole buckets the device ran), on a default
engine and on a megakernel engine (whose bf16 stream may part from the
JAX one only at a near tie: at 272 tokens both pick within 1.4e-4 of
max|logit| at step 195). The bucket rule is the JAX one; a
sampled generate_fast repeats for a seed; the plain megakernel takes its
position and cell as device words and flags a cell outside its span.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm_torch.ops import mega_decode as MD
from tpulamm_torch.runtime import decode_graph as dg
from tpulamm_torch.runtime.engine import Engine

PROMPT = "the cat sat on the mat"
N_PREDICT = [3, 5, 16, 17, 49, 272]
N_CTX = 320
# the steps the device runs: whole buckets (272: 256 + 16, no over-run)
STEPS = {3: 16, 5: 16, 16: 16, 17: 16, 49: 64, 272: 272}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs: the steps are many tiny
    ops, and under parallel test workers each worker's 8 OpenMP threads
    wait on the others' cores (a 272-token run took 631 s instead of 3.5
    on 8 cores with 6 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def q4_path(tmp_path_factory):
    return write_tiny_llama(str(tmp_path_factory.mktemp("dg") / "q4.gguf"),
                            GGMLType.Q4_0, seed=5)


@pytest.fixture(scope="module")
def default_pair(q4_path):
    je = JEngine(q4_path, n_ctx=N_CTX, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    te = Engine(q4_path, n_ctx=N_CTX, compute_dtype="float32",
                kv_dtype=torch.float32, device="cpu")
    return je, te


@pytest.fixture(scope="module")
def mega_pair(q4_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULAMM_MEGAKERNEL", "1")
        je = JEngine(q4_path, n_ctx=N_CTX, compute_dtype="float32")
        te = Engine(q4_path, n_ctx=N_CTX, compute_dtype="float32",
                    megakernel=True, device="cpu")
    assert je.mega is not None and te.mega is not None
    return je, te


def _near_tie(path, toks, i, a, b) -> float:
    """|logit a - logit b| / max|logit| at step i of the greedy stream
    `toks`, teacher-forced through the port's f32 default path (the prompt
    and toks[:i] in one prefill)."""
    ref = Engine(path, n_ctx=N_CTX, compute_dtype="float32",
                 kv_dtype=torch.float32, device="cpu")
    lg = ref.prefill(0, ref.tokenizer.encode(PROMPT, special=True)
                     + list(toks[:i]))
    return float(abs(lg[a] - lg[b]) / np.abs(lg).max())


def _same_state(je, te, n_predict, path=None):
    """The JAX engine's greedy tokens and state after generate_fast. With
    `path` (the megakernel's bf16 residual stream and cache), the streams
    may part only at a bf16-grade near tie of the two tokens (within 1e-2
    of max|logit|, the megakernel's tolerance); the state is compared
    whole either way."""
    want, wtext = je.generate_fast(PROMPT, n_predict=n_predict,
                                   stop_on_eos=False)
    te.timings.n_step = 0
    got, text = te.generate_fast(PROMPT, n_predict=n_predict,
                                 stop_on_eos=False)
    assert len(got) == len(want) == n_predict
    assert te.timings.n_step == STEPS[n_predict]
    if got != want and path is not None:
        i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        assert _near_tie(path, want, i, want[i], got[i]) <= 1e-2
    else:
        assert got == want and text == wtext
    assert te.n_past[0] == je.n_past[0]
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)
    n = int(te.n_past[0])
    np.testing.assert_array_equal(te.cache.pos[0, :N_CTX].numpy(),
                                  np.asarray(je.cache.pos)[0, :N_CTX])
    np.testing.assert_array_equal(te.cell_pos[0, :n], np.arange(n))


@pytest.mark.parametrize("n_predict", N_PREDICT)
def test_generate_fast_state_matches_jax(default_pair, n_predict):
    _same_state(*default_pair, n_predict)


@pytest.mark.parametrize("n_predict", N_PREDICT)
def test_mega_generate_fast_state_matches_jax(q4_path, mega_pair, n_predict):
    _same_state(*mega_pair, n_predict, path=q4_path)


def test_bucket_rule_is_the_jax_one():
    def jax_rule(remaining, room):          # engine.py:1555-1566
        b = JEngine.DECODE_BUCKETS
        n = next((x for x in b if x >= remaining), b[-1])
        if n - remaining > 32:
            n = max(x for x in b if x <= remaining)
        return min(n, room)
    assert dg.DECODE_BUCKETS == JEngine.DECODE_BUCKETS
    for remaining in range(1, 1200, 7):
        for room in (0, 5, 40, 300, 4000):
            assert dg.pick_block(remaining, room) == jax_rule(remaining, room)


def test_eos_stops_between_blocks_and_rolls_back(default_pair):
    """With EOS in the first block the output stops before it and the
    cache holds exactly the returned tokens, as in the JAX engine."""
    je, te = default_pair
    ids, _ = te.generate_fast(PROMPT, n_predict=12, stop_on_eos=False)
    eos = ids[5]
    te.tokenizer.vocab.eos_id = je.tokenizer.vocab.eos_id = eos
    try:
        want, _ = je.generate_fast(PROMPT, n_predict=12)
        got, _ = te.generate_fast(PROMPT, n_predict=12)
    finally:
        te.tokenizer.vocab.eos_id = je.tokenizer.vocab.eos_id = 2
    assert got == want == ids[:ids.index(eos)]
    assert te.n_past[0] == je.n_past[0]
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)


def test_sampled_generate_fast_repeats_for_a_seed(default_pair):
    _, te = default_pair
    assert not hasattr(Engine, "_sample_next")
    a, _ = te.generate_fast(PROMPT, n_predict=17, temp=0.9, seed=11,
                            stop_on_eos=False)
    b, _ = te.generate_fast(PROMPT, n_predict=17, temp=0.9, seed=11,
                            stop_on_eos=False)
    c, _ = te.generate_fast(PROMPT, n_predict=17, temp=0.9, seed=12,
                            stop_on_eos=False)
    g, _ = te.generate_fast(PROMPT, n_predict=17, stop_on_eos=False)
    assert a == b and len(a) == 17 and a != c
    assert a[0] == c[0] == g[0]               # the first token is greedy


def test_decode_after_generate_fast_continues_as_jax(default_pair):
    """After generate_fast both engines hold the same cache: one more
    decode_one step gives the JAX engine's logits."""
    je, te = default_pair
    want, _ = je.generate_fast(PROMPT, n_predict=16, stop_on_eos=False)
    got, _ = te.generate_fast(PROMPT, n_predict=16, stop_on_eos=False)
    assert got == want
    a, b = te.decode_one(0, got[-1]), je.decode_one(0, want[-1])
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_block_longer_than_the_ring(q4_path, monkeypatch):
    """A block of more steps than the output ring holds copies back once a
    ring and goes on: the same tokens as one copy back."""
    def run():
        te = Engine(q4_path, n_ctx=64, compute_dtype="float32",
                    kv_dtype=torch.float32, device="cpu")
        te.prefill(0, [1, 270, 271])
        return te.decode_batch_fast({0: 5}, 11)
    want = run()
    monkeypatch.setattr(dg, "RING", 4)
    assert run() == want and len(want[0]) == 11


def _mega_inputs(rng, S=24, live=13):
    from tpulamm_torch.tools.mega_ablation import inputs
    return inputs(rng, torch.device("cpu"), dim=256, ffn=512, n_head=4,
                  n_kv=2, span=S, live=live)


def test_mega_ref_takes_device_words():
    """mega_decode_layers (the plain version on the CPU) with int32 words
    for qpos and cell gives exactly what its host-int form gives, and
    writes the same K / V rows."""
    a, b = _mega_inputs(np.random.default_rng(1)), \
        _mega_inputs(np.random.default_rng(1))
    want = MD.mega_decode_layers(a["mega"], a["x"], 13, 13, a["kpos"], a["k"],
                                 a["v"], *a["lanes"])
    w = torch.tensor([13, 13], dtype=torch.int32)
    err = torch.zeros(1, dtype=torch.int32)
    got = MD.mega_decode_layers(b["mega"], b["x"], w[:1], w[1:], b["kpos"],
                                b["k"], b["v"], *b["lanes"], err)
    for g, t in zip(got, want):
        assert torch.equal(g, t)
    for x, y in zip(a["k"] + a["v"], b["k"] + b["v"]):
        assert torch.equal(x, y)
    assert int(err) == 0


def test_mega_cell_outside_span_sets_error_word():
    c = _mega_inputs(np.random.default_rng(2))
    before = [t.clone() for t in c["k"] + c["v"]]
    err = torch.zeros(1, dtype=torch.int32)
    w = torch.tensor([13, 24], dtype=torch.int32)          # cell == S
    x_out, _, _ = MD.mega_decode_layers(c["mega"], c["x"], w[:1], w[1:],
                                        c["kpos"], c["k"], c["v"],
                                        *c["lanes"], err)
    assert int(err) == 1 and not x_out.any()
    for t, u in zip(c["k"] + c["v"], before):
        assert torch.equal(t, u)                            # nothing written
    with pytest.raises(ValueError, match="outside the span"):
        MD.mega_decode_layers(c["mega"], c["x"], 13, 24, c["kpos"], c["k"],
                              c["v"], *c["lanes"])
    with pytest.raises(RuntimeError, match="outside its span"):
        dg.check_error(np.int32(1))


def test_step_buffers_stage_and_advance():
    """One host copy fills tokens, positions, cells, flags and the f32
    temperatures; advance writes active rows' tokens into the ring at the
    step index and moves only active rows."""
    b = dg.StepBuffers(3, torch.device("cpu"), vocab=8)
    b.stage([5, 6, 7], [10, 20, 30], [11, 21, 31], [1, 0, 1],
            [0.5, 0.0, 2.0])
    assert b.temp.tolist() == [0.5, 0.0, 2.0] and int(b.step) == 0
    b.advance(torch.tensor([1, 2, 3]))
    b.advance(torch.tensor([4, 5, 6]))
    assert b.out[1:3].tolist() == [[1, 6, 3], [4, 6, 6]]
    assert b.tok.tolist() == [4, 6, 6] and int(b.step) == 2
    assert b.pos.tolist() == [12, 20, 32] and b.cell.tolist() == [13, 21, 33]
    b.advance(None)                                     # a logits step
    assert b.tok.tolist() == [4, 6, 6] and b.pos.tolist() == [13, 20, 33]
    b.stage_idle(trash=99)
    assert b.act.tolist() == [0, 0, 0] and b.cell.tolist() == [99] * 3
    assert b.pos.tolist() == [-1] * 3 and int(b.err) == 0
