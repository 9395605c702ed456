"""Port parity for the session file (runtime/session.py): a file the port
writes loads in the JAX engine and one the JAX engine writes loads in the
port, for a bf16 and a q8_0 cache, and both continue greedily with the
same tokens; a K/V layout or shape mismatch raises ValueError (with the
JAX message); a cache with segments round-trips in both directions.

Tiny Q4_0 GGUF, f32 compute. Tolerances: equal arrays after a load; equal
greedy tokens over 12 steps.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime import session as jsession
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm_torch.runtime import session
from tpulamm_torch.runtime.engine import Engine

PROMPT = "the cat sat on the mat and the cat sat"
CACHES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "q8_0": ("q8_0", "q8_0")}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(
        str(tmp_path_factory.mktemp("ses") / "q4.gguf"), GGMLType.Q4_0,
        seed=5)


def _engines(path, cache, n_ctx=64):
    jd, td = CACHES[cache]
    je = JEngine(path, n_ctx=n_ctx, n_slots=2, compute_dtype="float32",
                 kv_dtype=jd)
    te = Engine(path, n_ctx=n_ctx, n_slots=2, compute_dtype="float32",
                kv_dtype=td, device="cpu")
    return je, te


def _greedy(eng, tok: int, n: int = 12) -> list[int]:
    out = []
    for _ in range(n):
        tok = int(np.argmax(eng.decode_one(0, tok)))
        out.append(tok)
    return out


def _arrays(fname):
    z = np.load(fname)
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_load(path, tmp_path, cache, writer):
    je, te = _engines(path, cache)
    src, dst = (te, je) if writer == "port" else (je, te)
    save = session.save_session if writer == "port" else jsession.save_session
    load = jsession.load_session if writer == "port" else session.load_session
    toks = src.tokenizer.encode(PROMPT, special=True)
    src.prefill(0, toks[:-1])
    src.prefill(1, toks[:5])
    fname = str(tmp_path / "state.bin")           # no ".npz" appended
    save(fname, src, toks[:-1])
    assert load(fname, dst) == toks[:-1]
    np.testing.assert_array_equal(dst.n_past, src.n_past)
    np.testing.assert_array_equal(dst.cell_pos, src.cell_pos)
    np.testing.assert_array_equal(dst.ga_i, src.ga_i)
    # the file written back by the loading engine holds the same arrays
    again = str(tmp_path / "again.bin")
    (jsession.save_session if writer == "port" else session.save_session)(
        again, dst, toks[:-1])
    a, b = _arrays(fname), _arrays(again)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    want = str(np.dtype(jnp.bfloat16)) if cache == "bf16" else "int8"
    assert str(a["k_dtype"]) == str(a["v_dtype"]) == want
    assert ("ks" in a) == (cache == "q8_0")
    # both continue greedily from the same state with the same tokens
    assert _greedy(dst, toks[-1]) == _greedy(src, toks[-1])


@pytest.mark.parametrize("saved,engine_cache", [("bf16", "q8_0"),
                                                ("q8_0", "bf16")])
def test_layout_mismatch_raises_as_jax(path, tmp_path, saved, engine_cache):
    je, te = _engines(path, saved)
    te.prefill(0, [1, 300, 301])
    fname = str(tmp_path / "s.bin")
    session.save_session(fname, te, [1, 300, 301])
    je2, te2 = _engines(path, engine_cache)
    with pytest.raises(ValueError) as want:
        jsession.load_session(fname, je2)
    with pytest.raises(ValueError, match="does not match the engine cache") \
            as got:
        session.load_session(fname, te2)
    assert str(got.value) == str(want.value)
    assert te2.n_past[0] == 0                 # the engine is untouched


def test_shape_mismatch_raises(path, tmp_path):
    _, te = _engines(path, "bf16")
    fname = str(tmp_path / "s.bin")
    session.save_session(fname, te, [])
    _, other = _engines(path, "bf16", n_ctx=32)
    with pytest.raises(ValueError, match="shape mismatch"):
        session.load_session(fname, other)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segments_round_trip(path, tmp_path, writer):
    """A cache holding segments (a segmented batch of two branches) saved
    by one package loads in the other with its segment plane, and both
    score the same branch probe alike."""
    je, te = _engines(path, "bf16")
    src, dst = (te, je) if writer == "port" else (je, te)
    save = session.save_session if writer == "port" else jsession.save_session
    load = jsession.load_session if writer == "port" else session.load_session
    seg = [1 | (1 << 16), 2 | (2 << 16)]
    src.prefill(0, [1, 300, 301])
    src.eval_segmented(0, np.array([11, 23], np.int32),
                       np.array([3, 3], np.int32), np.array(seg, np.int32))
    fname = str(tmp_path / "s.bin")
    save(fname, src, [1, 300, 301])
    assert load(fname, dst) == [1, 300, 301]
    np.testing.assert_array_equal(np.asarray(dst.cache.seg),
                                  np.asarray(src.cache.seg))
    np.testing.assert_array_equal(np.asarray(dst.cache.pos),
                                  np.asarray(src.cache.pos))
    assert np.count_nonzero(np.asarray(dst.cache.seg)) == 2
    np.testing.assert_array_equal(dst.cell_pos, src.cell_pos)
    probe = (np.array([40], np.int32), np.array([4], np.int32),
             np.array(seg[1:], np.int32))
    a, b = dst.eval_segmented(0, *probe), src.eval_segmented(0, *probe)
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_not_a_session_file(path, tmp_path):
    _, te = _engines(path, "bf16")
    fname = str(tmp_path / "x.bin")
    with open(fname, "wb") as fh:
        np.savez_compressed(fh, magic=np.array("something-else"),
                            meta=np.array(json.dumps({})))
    with pytest.raises(ValueError, match="not a tpulamm session file"):
        session.load_session(fname, te)
