"""Port parity for the segment plane (runtime/kvcache.py seg, the forward's
segment mask, Engine.eval_segmented) and lookahead decoding
(runtime/lookahead.py) on the CPU against the JAX package; tiny Q4_0 model
of _torch_port_models (seed 5), f32 compute and cache.

The seg plane equals the JAX cache's after write_kv with segments, seq_cp
and defrag; eval_segmented's logits are within 1e-5 of max|ref| of the JAX
engine's (tests/test_torch_archs.py's tolerance) on the branch layout of
tests/test_speculative.py::test_segmented_eval_mask, whose visibility
checks hold too; a segmented forward never asks for a flash kernel;
lookahead's greedy tokens and SpecStats equal the JAX package's and plain
greedy decoding's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime import kvcache as jkv
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm.runtime.lookahead import generate_lookahead as jlookahead
from tpulamm.runtime.sampling import SamplingParams as JParams
from tpulamm_torch.models import transformer as TT
from tpulamm_torch.runtime import kvcache as tkv
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.runtime.lookahead import generate_lookahead
from tpulamm_torch.runtime.sampling import SamplingParams

PROMPT = [1, 17, 42, 5, 99]


def pack(lo, hi):
    return lo | (hi << 16)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(str(tmp_path_factory.mktemp("seg") / "t.gguf"),
                            GGMLType.Q4_0, seed=5)


def _pair(path, n_ctx=64):
    je = JEngine(path, n_ctx=n_ctx, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    te = Engine(path, n_ctx=n_ctx, compute_dtype="float32",
                kv_dtype=torch.float32, device="cpu")
    return je, te


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8_0"])
def test_seg_plane_ops_match_jax(q8):
    """write_kv with and without segments, seq_cp and defrag move the
    segment plane as the JAX ops do (and the K/V with it)."""
    rng = np.random.default_rng(7)
    L, B, S, H, D, T = 2, 3, 12, 2, 4, 3
    qt = "q8_0" if q8 else None
    jc = jkv.KVCache.create(L, B, S, H, D, dtype=jnp.float32, qtype_k=qt)
    tc = tkv.KVCache.create(L, B, S, H, D, dtype=torch.float32, qtype_k=qt)
    for step in range(3):
        k = rng.normal(size=(B, T, H, D)).astype(np.float32)
        v = rng.normal(size=(B, T, H, D)).astype(np.float32)
        cells = np.stack([rng.permutation(S)[:T] for _ in range(B)])
        pos = rng.integers(0, 50, size=(B, T)).astype(np.int32)
        pos[0, 0] = -1
        segs = (None if step == 1 else
                rng.integers(0, 1 << 20, size=(B, T)).astype(np.int32))
        for li in range(L):
            jc = jkv.write_kv(jc, li, jnp.asarray(k), jnp.asarray(v), None,
                              jnp.asarray(cells), jnp.asarray(pos),
                              None if segs is None else jnp.asarray(segs))
            tkv.write_kv(tc, li, torch.from_numpy(k), torch.from_numpy(v),
                         None, torch.from_numpy(cells),
                         torch.from_numpy(pos),
                         None if segs is None else torch.from_numpy(segs))

    def same():
        for a, b in ((tc.pos, jc.pos), (tc.seg, jc.seg)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tc.k[1].numpy(), np.asarray(jc.k[1]))
    same()
    jc = jkv.seq_cp(jc, 0, 2)
    tkv.seq_cp(tc, 0, 2)
    same()
    jc = jkv.seq_rm(jc, 1, 10, 30)
    tkv.seq_rm(tc, 1, 10, 30)
    jc = jkv.defrag(jc)
    tkv.defrag(tc)
    same()


def _branch_batch(n):
    """Two parallel branch tokens at the same position in segments 1 and
    2, then a probe in each segment one position later."""
    toks = np.array([11, 23, 40, 40], np.int32)
    poss = np.array([n, n, n + 1, n + 1], np.int32)
    segs = np.array([pack(1, 1), pack(2, 2), pack(1, 1), pack(2, 2)],
                    np.int32)
    return toks, poss, segs


def test_eval_segmented_matches_jax(path):
    je, te = _pair(path)
    for eng in (je, te):
        eng.prefill(0, PROMPT)
    n = len(PROMPT)
    toks, poss, segs = _branch_batch(n)
    want = je.eval_segmented(0, toks, poss, segs)
    got = te.eval_segmented(0, toks, poss, segs)
    assert got.shape == want.shape == (4, te.cfg.vocab_size)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)
    np.testing.assert_array_equal(te.cache.seg[:, :64].numpy(),
                                  np.asarray(je.cache.seg)[:, :64])
    # the probe sees its own branch only: different histories, different
    # logits; identical histories, identical logits
    assert not np.allclose(got[2], got[3], atol=1e-5)
    te.rollback(0, n)
    same = te.eval_segmented(0, np.array([11, 11, 40, 40], np.int32), poss,
                             segs)
    np.testing.assert_allclose(same[2], same[3], rtol=1e-5, atol=1e-5)
    te.rollback(0, n)
    assert int(te.n_past[0]) == n


def test_segmented_forward_takes_einsum(path, monkeypatch):
    """A forward with segments never consults the flash dispatch (the JAX
    forward switches flash off when segs is given)."""
    _, te = _pair(path)
    te.cfg.flash_attn = True
    calls = []
    real = TT.flash_choice

    def recorder(cfg, T, span, on_cuda):
        calls.append(T)
        return real(cfg, T, span, on_cuda)
    monkeypatch.setattr(TT, "flash_choice", recorder)
    te.prefill(0, PROMPT)
    assert calls == [8] * te.cfg.n_layers
    calls.clear()
    te.eval_segmented(0, *_branch_batch(len(PROMPT)))
    assert calls == []


@pytest.mark.parametrize("wng", [(4, 3, 4), (5, 4, 2)])
def test_lookahead_matches_jax(path, wng):
    W, N, G = wng
    je, te = _pair(path, n_ctx=128)
    want, wtext, ws = jlookahead(je, PROMPT, n_predict=20,
                                 sampling=JParams(temp=0.0), W=W, N=N, G=G,
                                 stop_on_eos=False)
    got, text, gs = generate_lookahead(te, PROMPT, n_predict=20,
                                       sampling=SamplingParams(temp=0.0),
                                       W=W, N=N, G=G, stop_on_eos=False)
    assert got == want and text == wtext
    assert (gs.n_drafted, gs.n_accepted, gs.n_target_steps) == \
        (ws.n_drafted, ws.n_accepted, ws.n_target_steps)
    assert gs.n_target_steps > 0
    _, ref = _pair(path, n_ctx=128)
    plain, _ = ref.generate(PROMPT, n_predict=20,
                            sampling=SamplingParams(temp=0.0),
                            stop_on_eos=False)
    assert got == plain
    assert list(te.n_past) == list(je.n_past)
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)
