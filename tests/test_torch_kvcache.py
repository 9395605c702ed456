"""Port parity for runtime/kvcache: the q8_0 cache and position surgery
against tpulamm.runtime.kvcache on the same numpy inputs.

q8_quantize and write_kv are held bit for bit (codes, scales, positions);
seq_add / seq_div within 1e-5 of max|K| on the dequantized K (the rotation
runs in f32 in both), with untouched q8 rows bit-identical; seq_cp,
seq_keep and defrag exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulamm.ops.rope import RopeParams as JRope
from tpulamm.runtime import kvcache as J
from tpulamm_torch.ops.rope import RopeParams
from tpulamm_torch.runtime import kvcache as K

L, B, H, S, D = 2, 3, 2, 24, 64


def test_q8_quantize_identical_ties_included():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5, D)).astype(np.float32)
    # amax 127 -> scale exactly 1: every .5 is a tie (half to even)
    x[0, 0] = 0.0
    x[0, 0, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    x[0, 1] = 0.0                                   # zero row -> scale 1
    x[0, 2] = x[0, 2] * 1e-30                       # tiny amax
    q, s = K.q8_quantize(torch.from_numpy(x))
    jq, js = J.q8_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert list(q[0, 0, :8]) == [127, 2, -4, 0, 0, 2, 126, -126]


def test_create_refuses_other_quant_types():
    with pytest.raises(ValueError, match="unsupported KV cache quant"):
        K.KVCache.create(L, B, S, H, D, qtype_k="q4_0")
    c = K.KVCache.create(L, B, S, H, D, dtype=torch.float32, qtype_k="q8_0")
    assert c.k[0].dtype == torch.int8 and c.v[0].dtype == torch.float32
    assert c.vs is None and c.ks[0].shape == (B, H, S)
    assert bool((c.ks[0] == 1).all())


def _pair(qk, qv, seed=0, fill=14):
    """The same cache in both packages: `fill` cells of every slot written
    through write_kv (slot b at positions 0.. in cells b, b+1, ...)."""
    rng = np.random.default_rng(seed)
    jc = J.KVCache.create(L, B, S, H, D, dtype=jnp.float32, qtype_k=qk,
                          qtype_v=qv)
    tc = K.KVCache.create(L, B, S, H, D, dtype=torch.float32, qtype_k=qk,
                          qtype_v=qv)
    cells = np.stack([np.arange(fill) + b for b in range(B)]).astype(np.int32)
    pos = np.stack([np.arange(fill)] * B).astype(np.int32)
    for layer in range(L):
        kn = rng.normal(size=(B, fill, H, D)).astype(np.float32)
        vn = rng.normal(size=(B, fill, H, D)).astype(np.float32)
        jc = J.write_kv(jc, layer, jnp.asarray(kn), jnp.asarray(vn), None,
                        jnp.asarray(cells), jnp.asarray(pos))
        K.write_kv(tc, layer, torch.from_numpy(kn), torch.from_numpy(vn),
                   None, torch.from_numpy(cells), torch.from_numpy(pos))
    return jc, tc


def _assert_same(jc, tc, exact=True, k_tol=None):
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    for name in ("k", "v", "ks", "vs"):
        jb, tb = getattr(jc, name), getattr(tc, name)
        assert (jb is None) == (tb is None), name
        for a, b in zip(jb or (), tb or ()):
            if exact or name not in ("k", "ks"):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _deq_k(c, layer, jax_side):
    k = np.asarray(c.k[layer], np.float32) if jax_side else \
        c.k[layer].numpy().astype(np.float32)
    if c.ks is None:
        return k
    s = np.asarray(c.ks[layer]) if jax_side else c.ks[layer].numpy()
    return k * s[..., None]


@pytest.mark.parametrize("qk,qv", [("q8_0", "q8_0"), ("q8_0", None),
                                   (None, "q8_0"), (None, None)])
def test_write_kv_identical(qk, qv):
    jc, tc = _pair(qk, qv)
    _assert_same(jc, tc)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("op", ["add", "add_negative", "div"])
def test_seq_add_div_match_jax(q8, op):
    qk = "q8_0" if q8 else None
    jc, tc = _pair(qk, qk, seed=1)
    jr, tr = JRope(n_rot=D, freq_base=10000.0), RopeParams(n_rot=D)
    before = [_deq_k(tc, i, False) for i in range(L)]
    pos0 = tc.pos.numpy().copy()
    if op == "add":
        jc = J.seq_add(jc, 1, 4, 100, 7, jr)
        K.seq_add(tc, 1, 4, 100, 7, tr)
        moved = (pos0 >= 4)
    elif op == "add_negative":           # cells shifted below 0 are removed
        jc = J.seq_add(jc, 1, 2, 100, -5, jr)
        K.seq_add(tc, 1, 2, 100, -5, tr)
        moved = (pos0 >= 2)
    else:
        jc = J.seq_div(jc, 1, 3, 11, 2, jr)
        K.seq_div(tc, 1, 3, 11, 2, tr)
        moved = (pos0 >= 3) & (pos0 < 11)
    moved[[0, 2]] = False                 # other slots untouched
    _assert_same(jc, tc, exact=False)
    for i in range(L):
        want, got = _deq_k(jc, i, True), _deq_k(tc, i, False)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        # untouched rows keep their exact codes / values and scales
        keep = ~moved[:, None, :].repeat(H, 1)
        np.testing.assert_array_equal(tc.k[i].numpy()[keep],
                                      np.asarray(jc.k[i])[keep])
        np.testing.assert_array_equal(got[keep], before[i][keep])
        assert not np.allclose(got[~keep], before[i][~keep])


def test_seq_cp_keep_defrag_exact():
    jc, tc = _pair("q8_0", None, seed=2)
    jc, _ = J.seq_cp(jc, 0, 2), K.seq_cp(tc, 0, 2)
    _assert_same(jc, tc)
    # holes in slot 1, then compaction of every slot
    jc = J.seq_rm(jc, 1, 3, 6)
    K.seq_rm(tc, 1, 3, 6)
    jc = J.seq_rm(jc, 0, 0, 2)
    K.seq_rm(tc, 0, 0, 2)
    jc, _ = J.defrag(jc), K.defrag(tc)
    _assert_same(jc, tc)
    assert list(tc.pos[1, :12].numpy()) == [0, 1, 2, 6, 7, 8, 9, 10, 11, 12,
                                            13, -1]
    jc, _ = J.seq_keep(jc, 1), K.seq_keep(tc, 1)
    _assert_same(jc, tc)
    assert bool((tc.pos[0] == -1).all()) and bool((tc.pos[1, 0] == 0))
