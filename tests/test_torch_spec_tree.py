"""Port parity for draft-tree speculation (runtime/spec_tree.py) on the
CPU against the JAX package, on the tiny Q4_0 models of
_torch_port_models (target seed 5, draft seed 9), f32 compute and cache.

Greedy tree speculation emits the JAX package's tokens and plain greedy
decoding's, with the JAX SpecStats and state (n_past, host and device
positions and segments) for a self draft and for a bad draft with many
forks; after a call the cache continues decoding as a fresh prefill of
the same tokens does (logits within 2e-4, the JAX test's tolerance);
`_consolidate` writes the JAX cache's K, V, positions and segments;
engines the tree cannot serve raise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime import kvcache as jkv
from tpulamm.runtime import spec_tree as JT
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm_torch.runtime import kvcache as tkv
from tpulamm_torch.runtime import spec_tree as TT
from tpulamm_torch.runtime.engine import Engine

PROMPT = [1, 17, 42, 5, 99]
N_CTX = 256


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tree")
    return {"target": write_tiny_llama(str(d / "t.gguf"), GGMLType.Q4_0,
                                       seed=5),
            "bad": write_tiny_llama(str(d / "d.gguf"), GGMLType.Q4_0,
                                    seed=9)}


def _pair(path, n_slots=1):
    je = JEngine(path, n_ctx=N_CTX, n_slots=n_slots, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    te = Engine(path, n_ctx=N_CTX, n_slots=n_slots, compute_dtype="float32",
                kv_dtype=torch.float32, device="cpu")
    return je, te


@pytest.fixture(scope="module")
def plain(paths):
    _, te = _pair(paths["target"])
    return te.generate_fast(PROMPT, n_predict=32, stop_on_eos=False)[0]


CASES = {"self": ("target", dict(n_draft=6, n_seq_dft=3, p_split=0.1)),
         "bad-forks": ("bad", dict(n_draft=6, n_seq_dft=4, p_split=0.02))}


@pytest.mark.parametrize("case", list(CASES))
def test_tree_matches_jax(paths, plain, case):
    draft, kw = CASES[case]
    (jt, tt), (jd, td) = _pair(paths["target"]), _pair(paths[draft])
    want, wtext, ws = JT.generate_speculative_tree(
        jt, jd, PROMPT, n_predict=32, stop_on_eos=False, **kw)
    got, text, gs = TT.generate_speculative_tree(
        tt, td, PROMPT, n_predict=32, stop_on_eos=False, **kw)
    assert got == want == plain and text == wtext
    assert (gs.n_drafted, gs.n_accepted, gs.n_target_steps) == \
        (ws.n_drafted, ws.n_accepted, ws.n_target_steps)
    assert gs.n_target_steps < 32 if case == "self" else gs.n_drafted > 0
    for je, te in ((jt, tt), (jd, td)):
        assert list(te.n_past) == list(je.n_past)
        np.testing.assert_array_equal(te.cell_pos, je.cell_pos)
        for plane in ("pos", "seg"):
            np.testing.assert_array_equal(
                getattr(te.cache, plane)[:, :N_CTX].numpy(),
                np.asarray(getattr(je.cache, plane))[:, :N_CTX])


def test_tree_kv_state_consistent_after(paths):
    """The engine continues decoding after the tree call with a KV equal
    to plain decoding's (tests/test_spec_tree.py)."""
    _, target = _pair(paths["target"])
    _, draft = _pair(paths["target"])
    out, _, _ = TT.generate_speculative_tree(
        target, draft, PROMPT, n_predict=12, n_draft=5, n_seq_dft=3,
        stop_on_eos=False)
    m = int(target.n_past[0]) - len(PROMPT)
    assert 0 < m <= len(out)
    if m < len(out):
        target.eval_tokens(0, out[m:])
    lg = target.decode_one(0, 7)
    _, ref = _pair(paths["target"])
    ref.prefill(0, PROMPT + out)
    np.testing.assert_allclose(lg, ref.decode_one(0, 7), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("run", [True, False])
def test_consolidate_matches_jax(run):
    """The accepted path's cells gathered into the window, the rest of the
    window dead; nothing moves where the cycle did not run."""
    rng = np.random.default_rng(3)
    L, S, H, D, W = 2, 40, 2, 8, 7
    k = [rng.normal(size=(1, H, S, D)).astype(np.float32) for _ in range(L)]
    v = [rng.normal(size=(1, H, S, D)).astype(np.float32) for _ in range(L)]
    pos = np.full((1, S), -1, np.int32)
    pos[0, :20] = np.arange(20)
    seg = np.zeros((1, S), np.int32)
    seg[0, 12:19] = rng.integers(1, 1 << 20, size=7)
    startb, n_acc = 12, 3
    path = np.array([0, 2, 3, 5, 0, 0, 0], np.int32) + startb
    jc = jkv.KVCache(k=[jnp.asarray(x) for x in k],
                     v=[jnp.asarray(x) for x in v], pos=jnp.asarray(pos),
                     seg=jnp.asarray(seg))
    tc = tkv.KVCache(k=[torch.from_numpy(x.copy()) for x in k],
                     v=[torch.from_numpy(x.copy()) for x in v],
                     pos=torch.from_numpy(pos.copy()),
                     seg=torch.from_numpy(seg.copy()))
    TT._consolidate(tc, torch.tensor(startb), torch.from_numpy(path),
                    torch.tensor(n_acc), torch.tensor(startb), W,
                    torch.tensor(run))
    if not run:
        np.testing.assert_array_equal(tc.pos.numpy(), pos)
        np.testing.assert_array_equal(tc.seg.numpy(), seg)
        np.testing.assert_array_equal(tc.k[1].numpy(), k[1])
        return
    jc = JT._consolidate(jc, startb, jnp.asarray(path), n_acc, startb, W)
    for a, b in ((tc.pos, jc.pos), (tc.seg, jc.seg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for li in range(L):
        np.testing.assert_array_equal(tc.k[li].numpy(), np.asarray(jc.k[li]))
        np.testing.assert_array_equal(tc.v[li].numpy(), np.asarray(jc.v[li]))


def test_tree_rejects_bad_engines(paths):
    _, two = _pair(paths["target"], n_slots=2)
    _, draft = _pair(paths["target"])
    with pytest.raises(ValueError, match="single-slot"):
        TT.generate_speculative_tree(two, draft, PROMPT, n_seq_dft=2)
    _, one = _pair(paths["target"])
    with pytest.raises(ValueError, match="n_seq_dft"):
        TT.generate_speculative_tree(one, draft, PROMPT, n_seq_dft=1)
