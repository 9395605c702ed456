"""The port's int8 KL audit (tpulamm_torch.tools.int8_kl_audit) and its
switch, Engine(int8_dot=) -> ops.qmm.use_int8, against the JAX tool and
TPULAMM_INT8_DOT, on the CPU.

- qmm's path choice under each of "1", "0" and "force" equals the one
  qmm_pallas makes under TPULAMM_INT8_DOT (its kernels replaced by
  recorders, so only the choice runs) over M, N and the compute dtype;
- kl_row equals the JAX kl_row on the same arrays (within 1e-12
  relative: the same numpy arithmetic);
- teacher_forced_logits on a Q4_0 file quantized from a tiny F32 model
  (dim 256, 2 layers, vocab 512), int8 dots on and off, against the JAX
  tool's with the variable at "1" and "0" (set with monkeypatch first,
  since the JAX function writes os.environ itself): every logit within
  5e-3 of max|logit| (both engines at their default compute, bf16
  activations and cache, which the two packages round at different
  points: 1.4e-3 seen), each step's KL(JAX || port) <= 1e-4 and the same
  top-1 token at every step. On the CPU both packages take the plain
  dequantize-then-dot path in either pass, so on and off agree here;
- main's table and JSON rows on that file (one format) equal kl_row of
  the JAX passes' logits within 1e-6.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulamm.ops import pallas_qmm
from tpulamm.ops.qtensor import QTensor as JQTensor
from tpulamm.quant import formats
from tpulamm.tools import int8_kl_audit as JA
from tpulamm_torch.cli.quantize import quantize_file
from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import qmm as tqmm
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.tools import int8_kl_audit as PA
from tpulamm_torch.tools.synth import write_llama_gguf

TEXT = b"The quick brown fox jumps over the lazy dog. "
TOKS = [1] + [b + 3 for b in TEXT[:24]]
N_PREFIX = 12


@pytest.mark.parametrize("mode", ["1", "0", "force"])
def test_path_choice_matches_qmm_pallas(monkeypatch, mode):
    monkeypatch.setenv("TPULAMM_INT8_DOT", mode)
    monkeypatch.delenv("TPULAMM_INT8_INKQ", raising=False)
    calls = []

    def recorder(name):
        def call(x, planes, *, n, **_):
            calls.append(name)
            return jnp.zeros((max(x.shape[0], 16), n), jnp.float32)
        return call
    monkeypatch.setattr(pallas_qmm, "_qmm_int8_call", recorder("int8"))
    monkeypatch.setattr(pallas_qmm, "_qmm_call", recorder("f32"))
    rng = np.random.default_rng(0)
    for n in (640, 1152, 4096):          # widest tiles 640, 1152, 4096
        raw = formats.quantize(rng.normal(size=(n, 256)).astype(np.float32),
                               GGMLType.Q4_0)
        qt = JQTensor.from_gguf_raw(raw, GGMLType.Q4_0, (n, 256))
        for m in (1, 16, 17):
            for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                             (jnp.float32, torch.float32)):
                pallas_qmm.qmm_pallas(jnp.zeros((m, 256), jnp.float32), qt,
                                      compute_dtype=jdt)
                want = calls.pop() == "int8"
                assert tqmm.use_int8(m, n, tdt, mode) is want, (m, n, jdt)


def test_kl_row_matches_jax():
    rng = np.random.default_rng(4)
    base = rng.normal(size=(9, 300)) * 3
    test = base + rng.normal(size=(9, 300)) * 0.1
    test[2] = base[2]
    want, got = JA.kl_row(base, test), PA.kl_row(base, test)
    assert set(want) == set(got)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), k
    assert PA.kl_row(base, base)["kl_max"] == 0.0


def test_engine_int8_dot_values(files):
    for v in ("1", "0", "force"):
        eng = Engine(files["q4"], n_ctx=32, int8_dot=v, device="cpu")
        assert eng.cfg.int8_dot == v
    for v in ("2", True):
        with pytest.raises(ValueError, match="int8_dot"):
            Engine(files["q4"], n_ctx=32, int8_dot=v, device="cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("audit")
    f32 = str(d / "f32.gguf")
    write_llama_gguf(f32, 2, np.random.default_rng(7), dim=256, ffn=512,
                     n_head=4, vocab=512, qtype=GGMLType.F32, std=0.08)
    q4 = str(d / "int8kl_q4_0.gguf")
    quantize_file(f32, q4, GGMLType.Q4_0)
    return {"dir": str(d), "f32": f32, "q4": q4}


@pytest.fixture(scope="module")
def jax_logits(files):
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for mode, int8 in (("1", True), ("0", False)):
            mp.setenv("TPULAMM_INT8_DOT", mode)
            out[int8] = JA.teacher_forced_logits(files["q4"], TOKS, N_PREFIX,
                                                 int8=int8)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("int8", [True, False])
def test_teacher_forced_logits_match_jax(files, jax_logits, int8):
    got = PA.teacher_forced_logits(files["q4"], TOKS, N_PREFIX, int8=int8,
                                   device="cpu")
    want = jax_logits[int8]
    assert got.shape == want.shape == (len(TOKS) - N_PREFIX, 512)
    assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()
    row = PA.kl_row(want, got)
    assert row["kl_max"] <= 1e-4 and row["top1"] == 1.0


def test_main_matches_jax_rows(files, jax_logits, monkeypatch, capsys,
                               tmp_path):
    monkeypatch.setattr(PA, "_tokens", lambda n_prefix, n_steps: TOKS)
    seen = []
    js = tmp_path / "rows.json"
    assert PA.main(["--f32-model", files["f32"], "--formats", "Q4_0",
                    "--steps", str(len(TOKS) - N_PREFIX - 1), "--prefix",
                    str(N_PREFIX), "--out-dir", files["dir"], "--json",
                    str(js), "--device", "cpu"],
                   on_decode=lambda fmt, int8: seen.append((fmt, int8))
                   or contextlib.nullcontext()) == 0
    assert seen == [("Q4_0", False), ("Q4_0", True)]
    rows = json.loads(js.read_text())
    want = JA.kl_row(jax_logits[False], jax_logits[True])
    for k, v in want.items():
        assert abs(rows["Q4_0"][k] - v) <= 1e-6, k
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("| format | KL(f32||int8) mean | p99 | max | top-1 "
                      "agree |")
    assert out[2].startswith("| Q4_0 | ")
