"""Port parity: the batched serving decode of tpulamm_torch's Engine on the
CPU (decode_batch over _b_rows, decode_batch_fast, decode_batch_sampled)
against the JAX Engine, f32 compute and KV, on the tiny Q4_0 and Q8_0
GGUFs of tests/_torch_port_models.py.

Greedy tokens are compared exactly (the pattern of tests/test_engine.py:
175-197 and :281-320); sampled blocks are checked for determinism and for
drawing inside each step's top-k.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm.runtime.sampling import Sampler as JSampler
from tpulamm.runtime.sampling import SamplingParams as JSamplingParams
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.runtime.sampling import Sampler, SamplingParams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pools spinning across processes slow the many small ops
    of a decode loop by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["q4_0", "q8_0"])
def model(request, tmp_path_factory):
    return write_tiny_llama(
        str(tmp_path_factory.mktemp("m") / f"{request.param}.gguf"),
        getattr(GGMLType, request.param.upper()), seed=5)


def _pair(path, n_slots=3, n_ctx=64):
    je = JEngine(path, n_ctx=n_ctx, n_slots=n_slots, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    te = Engine(path, n_ctx=n_ctx, n_slots=n_slots, compute_dtype="float32",
                kv_dtype=torch.float32, device="cpu")
    return je, te


def _prefill(*engines):
    for eng in engines:
        eng.prefill(0, [1, 9, 33])
        eng.prefill(1, [4, 7])


def test_decode_batch_fast_matches_jax_and_host_loop(model):
    je, te = _pair(model)
    _prefill(je, te)
    want = je.decode_batch_fast({0: 11, 1: 25}, 6)
    got = te.decode_batch_fast({0: 11, 1: 25}, 6)
    assert got == want
    assert te.n_past.tolist() == je.n_past.tolist()
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)
    np.testing.assert_array_equal(te.cache.pos.numpy(),
                                  np.asarray(je.cache.pos))
    # the port's own host loop of decode_batch gives the same tokens
    _, ref = _pair(model)
    _prefill(ref)
    cur, host = {0: 11, 1: 25}, {0: [], 1: []}
    for _ in range(6):
        lg = ref.decode_batch(cur)
        cur = {s: int(np.argmax(v)) for s, v in lg.items()}
        for s in cur:
            host[s].append(cur[s])
    assert got == host
    # mirrors advanced consistently: a follow-up host step works
    assert set(te.decode_batch({0: got[0][-1], 1: got[1][-1]})) == {0, 1}


def test_decode_batch_sampled_greedy_penalties_match_jax(model):
    je, te = _pair(model)
    _prefill(je, te)
    kw = dict(temp=0.0, penalty_repeat=1.3, penalty_freq=0.1,
              penalty_last_n=8)
    hist = {0: [1, 9, 33, 11], 1: [4, 7, 25]}

    def samplers(cls, pcls):
        out = {}
        for s, h in hist.items():
            out[s] = cls(pcls(**kw), 512)
            for t in h:
                out[s].accept(t, apply_grammar=False)
        return out
    want = je.decode_batch_sampled({0: 11, 1: 25}, 8,
                                   samplers(JSampler, JSamplingParams))
    got = te.decode_batch_sampled({0: 11, 1: 25}, 8,
                                  samplers(Sampler, SamplingParams))
    assert got == want and len(got[0]) == 8
    # the port's decode_batch + host Sampler loop gives the same tokens
    _, ref = _pair(model)
    _prefill(ref)
    smp, cur, host = samplers(Sampler, SamplingParams), {0: 11, 1: 25}, \
        {0: [], 1: []}
    for _ in range(8):
        lg = ref.decode_batch(cur)
        for s in cur:
            cur[s] = smp[s].sample(lg[s])
            smp[s].accept(cur[s])
            host[s].append(cur[s])
    assert got == host


def test_decode_batch_fast_guards(model):
    te = Engine(model, n_ctx=16, n_slots=2, device="cpu")
    te.prefill(0, [1, 9])
    with pytest.raises(ValueError, match="overflow n_ctx"):
        te.decode_batch_fast({0: 3}, 30)
    with pytest.raises(ValueError, match="overflow n_ctx"):
        te.decode_batch_sampled({0: 3}, 30, {0: None})
    te.seq_rm(0, 0, 1)                    # cells no longer contiguous
    with pytest.raises(ValueError, match="not contiguous"):
        te.decode_batch_fast({0: 3}, 2)
    with pytest.raises(ValueError, match="not contiguous"):
        te.decode_batch_sampled({0: 3}, 2, {0: None})


def test_b_rows_equals_jax(model):
    je, te = _pair(model, n_slots=2)
    for n_slots in (1, 2, 3, 4, 8, 16):
        je.n_slots = te.n_slots = n_slots
        for ids in ([0], [1], [0, 1], [2], [0, 3], [4], [5, 1], [7], [8],
                    [0, 15], [9, 2]):
            if max(ids) < n_slots:
                assert te._b_rows(ids) == je._b_rows(ids), (n_slots, ids)


def test_b_rows_compaction_leaves_outer_slots(model, monkeypatch):
    """A block over the 2-row bucket leaves slot 5 (occupied, outside it)
    untouched: the same results as the full 8-row batch and as JAX."""
    def drive(eng):
        eng.prefill(0, [1, 9, 33])
        eng.prefill(1, [4, 7])
        eng.prefill(5, [2, 8, 14])
        out = eng.decode_batch_fast({0: 11, 1: 25}, 6)
        lg = eng.decode_batch({0: out[0][-1], 1: out[1][-1]})
        lg5 = eng.decode_batch({5: 3})
        return out, {s: int(np.argmax(v)) for s, v in lg.items()}, \
            int(np.argmax(lg5[5]))
    je, te = _pair(model, n_slots=8)
    assert te._b_rows({0: 1, 1: 1}) == 2 and te._b_rows({0: 1, 5: 1}) is None
    got = drive(te)
    assert got == drive(je)
    monkeypatch.setattr(Engine, "_b_rows", lambda self, ids: None)
    _, full = _pair(model, n_slots=8)
    assert got == drive(full)


def test_b_cover_guard_catches_broken_bucket(model, monkeypatch):
    te = Engine(model, n_ctx=64, n_slots=8, device="cpu")
    te.prefill(0, [1, 9])
    te.prefill(5, [2, 8])
    monkeypatch.setattr(Engine, "_b_rows", lambda self, ids: 2)
    for call in (lambda: te.decode_batch({0: 3, 5: 4}),
                 lambda: te.decode_batch_fast({0: 3, 5: 4}, 6),
                 lambda: te.decode_batch_sampled({0: 3, 5: 4}, 6, {})):
        with pytest.raises(AssertionError, match="outside compaction bucket"):
            call()


def test_sampled_block_is_seeded_and_draws_from_top_k(model):
    """temp > 0: the same seed gives the same tokens, and each token lies in
    the top-k of its step's logits (replayed by teacher-forced
    decode_batch steps); a temp-0 row in the same block stays greedy."""
    def block(seed):
        te = Engine(model, n_ctx=64, n_slots=3, compute_dtype="float32",
                    kv_dtype=torch.float32, device="cpu")
        _prefill(te)
        return te.decode_batch_fast({0: 11, 1: 25}, 8, temp={0: 1.5, 1: 0.0},
                                    top_k=5, seed=seed)
    a = block(3)
    assert a == block(3) and a != block(4)
    _, ref = _pair(model)
    _prefill(ref)
    cur = {0: 11, 1: 25}
    for i in range(8):
        lg = ref.decode_batch(cur)
        assert a[0][i] in np.argsort(-lg[0])[:5], i
        assert a[1][i] == int(np.argmax(lg[1])), i
        cur = {0: a[0][i], 1: a[1][i]}
