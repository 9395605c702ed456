"""The port's (dp, tp) mesh against the JAX package's, on the CPU.

- the shard plan (parallel.mesh.param_plan) equals the JAX
  param_pspecs weight by weight, for a tiny model of every ARCH_SPECS
  architecture at tp 2 and 4, each package's params fused for that tp;
- the meshed Engine against the JAX meshed Engine (its eight virtual CPU
  devices, tests/conftest.py) at f32 compute and KV: prefill logits_all
  within rtol / atol 2e-4 at (dp, tp) = (1, 2), (2, 1), (2, 2) and (1, 8)
  (on an 8-KV-head model), decode_batch_fast tokens at dp 2 x tp 2,
  generate_fast and the host generate across a context shift, position
  surgery, embed at dp 2, the validation errors, session files crossing
  both ways (meshed or not), and cfg_step's row modes;
- a MoE model (row_moe), bloom (ALiBi slopes at the rank's head offset, a
  biased fused QKV) and mamba at dp 2 (tp 2 raises as in JAX);
- Q2_K at tp 2 equals tp 1, where the JAX engine raises KeyError reading
  a "scales" plane a Q2_K QTensor does not have.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.models import loader as jloader
from tpulamm.ops.qtensor import QTensor as JQTensor
from tpulamm.parallel import mesh as jmesh
from tpulamm.runtime import session as jsession
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm.runtime.sampling import SamplingParams as JSamplingParams
from tpulamm_torch.models import loader as tloader
from tpulamm_torch.models.config import ARCH_SPECS
from tpulamm_torch.parallel.mesh import param_plan
from tpulamm_torch.runtime import session as tsession
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.runtime.sampling import SamplingParams
from tpulamm_torch.tools.synth import (FAMILIES, write_family_gguf,
                                       write_mamba_gguf, write_mixtral_gguf)

PROMPT = [1, 310, 271, 306, 290, 302]
TOL = dict(rtol=2e-4, atol=2e-4)
F32 = dict(compute_dtype="float32")


def _jeng(path, **kw):
    return JEngine(path, n_ctx=kw.pop("n_ctx", 64), kv_dtype=jnp.float32,
                   **F32, **kw)


def _teng(path, **kw):
    return Engine(path, n_ctx=kw.pop("n_ctx", 64), kv_dtype=torch.float32,
                  device="cpu", **F32, **kw)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)      # parallel test workers share the cores
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    out = {"llama": write_tiny_llama(str(d / "q4.gguf"), seed=5),
           "q2k": write_tiny_llama(str(d / "q2k.gguf"), GGMLType.Q2_K,
                                   seed=6),
           "moe": str(d / "moe.gguf"), "bloom": str(d / "bloom.gguf"),
           "mamba": str(d / "mamba.gguf"), "kv8": str(d / "kv8.gguf")}
    write_mixtral_gguf(out["moe"], 2, np.random.default_rng(21), dim=256,
                       ffn=512, n_head=4, n_kv=2, vocab=512, n_expert=4,
                       n_expert_used=2, n_ctx_train=512)
    write_family_gguf(out["bloom"], "bloom", np.random.default_rng(22),
                      dim=256, ffn=512, vocab=512, n_ctx_train=256)
    write_mamba_gguf(out["mamba"], 2, 23, dim=256, d_inner=512, d_state=16,
                     d_conv=4, dt_rank=16, vocab=512)
    # 8 heads over 8 KV heads, the shape of tests/test_multihost.py
    from tpulamm_torch.tools.synth import write_llama_gguf
    write_llama_gguf(out["kv8"], 2, np.random.default_rng(24), dim=256,
                     ffn=512, n_head=8, vocab=512, qtype=GGMLType.F32,
                     std=0.08)
    return out


# -- the shard plan ------------------------------------------------------------

def _arch_gguf(arch: str, path: str) -> str:
    """A tiny `arch` model: tools.synth's Q4_0 families (ffn 1024, so the
    down projection K-shards at tp 2 and 4), test_torch_archs' F32
    synthetic and HF models, the tiny llama and a mamba."""
    import test_torch_archs as TA
    if arch in FAMILIES:
        write_family_gguf(path, arch, np.random.default_rng(7), dim=256,
                          ffn=1024, vocab=512, n_ctx_train=256)
    elif arch in TA.SYNTHETIC:
        TA._synthetic_gguf(path, arch, TA.SYNTHETIC[arch])
    elif arch == "llama":
        write_tiny_llama(path, seed=1)
    elif arch == "mamba":
        write_mamba_gguf(path, 1, 2, dim=256, d_inner=512, d_state=16,
                         d_conv=4, dt_rank=16, vocab=512)
    else:
        TA._hf_gguf({"starcoder": "starcoder_gptbigcode",
                     "gptj": "gptj"}[arch], path)
    return path


def _jax_axis(spec):
    """A JAX weight spec as the plan's "N" / "K" / None."""
    if isinstance(spec, JQTensor):
        spec = next(iter(spec.planes.values()))
        return {(None, "tp"): "N", ("tp", None): "K"}.get(tuple(spec))
    spec = tuple(spec)
    if spec and spec[0] == "tp":
        return "N"
    return "K" if len(spec) > 1 and spec[1] == "tp" else None


def _compare(plan, specs, where=""):
    if isinstance(plan, dict):
        keys = {k for k in set(plan) | set(specs)
                if plan.get(k) is not None or specs.get(k) is not None}
        for k in keys:
            _compare(plan.get(k), specs.get(k), f"{where}.{k}")
    elif isinstance(plan, list) or isinstance(specs, list):
        assert len(plan) == len(specs), where
        for i, (a, b) in enumerate(zip(plan, specs)):
            _compare(a, b, f"{where}[{i}]")
    else:
        want = None if specs is None else _jax_axis(specs)
        assert plan == want, (where, plan, want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", sorted(ARCH_SPECS))
def test_shard_plan_equals_param_pspecs(tmp_path, arch, tp):
    path = _arch_gguf(arch, str(tmp_path / f"{arch}.gguf"))
    jcfg, jparams, _ = jloader.load_model(path, compute_dtype="float32")
    JEngine._fuse_projections(SimpleNamespace(params=jparams, tp=tp,
                                              cfg=jcfg))
    specs = jmesh.param_pspecs(jparams, jcfg, jmesh.make_mesh(1, tp))
    tcfg, tparams, _ = tloader.load_model(path, compute_dtype="float32",
                                          device="cpu")
    Engine._fuse_projections(SimpleNamespace(params=tparams, tp=tp,
                                             cfg=tcfg,
                                             device=torch.device("cpu")))
    plan = param_plan(tparams, tp)
    assert set(k for k, v in plan.items() if v is not None) <= set(specs)
    _compare(plan, specs)
    if arch in FAMILIES and tp == 2 and arch != "bert":
        # the widened FFN K-shards its down projection
        assert "K" in str(plan["layers"][0].values())


# -- the meshed engine against the JAX meshed engine ---------------------------

@pytest.fixture(scope="module")
def single(paths):
    return _jeng(paths["llama"]).prefill(0, PROMPT, logits_all=True)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1), (2, 2)])
def test_prefill_parity(paths, single, dp, tp):
    je = _jeng(paths["llama"], dp=dp, tp=tp, n_slots=2 * dp)
    te = _teng(paths["llama"], dp=dp, tp=tp, n_slots=2 * dp)
    want = je.prefill(1, PROMPT, logits_all=True)    # a non-zero slot
    got = te.prefill(1, PROMPT, logits_all=True)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, single, **TOL)
    for k in ("row_attn", "row_ffn", "row_moe", "head_sharded", "n_heads",
              "n_kv_heads", "head_dim"):
        assert getattr(te.cfg_step, k) == getattr(je.cfg_step, k), k
    assert te.mesh.describe() == (f"mesh (dp {dp}, tp {tp}): {dp * tp} "
                                  "ranks on cpu, 1 process")


def test_prefill_parity_tp8(paths):
    """tp 8 on a model with 8 KV heads (the JAX mesh test skips tp 8 on
    its 2-KV-head model)."""
    je = _jeng(paths["kv8"], tp=8)
    te = _teng(paths["kv8"], tp=8)
    want = je.prefill(0, PROMPT, logits_all=True)
    np.testing.assert_allclose(te.prefill(0, PROMPT, logits_all=True),
                               want, **TOL)
    ref = _teng(paths["kv8"]).prefill(0, PROMPT, logits_all=True)
    np.testing.assert_allclose(ref, want, **TOL)


def test_decode_batch_fast_dp2_tp2(paths):
    je = _jeng(paths["llama"], dp=2, tp=2, n_slots=2)
    te = _teng(paths["llama"], dp=2, tp=2, n_slots=2)
    for e in (je, te):
        e.prefill(0, PROMPT)
        e.prefill(1, PROMPT[:4])
    want = je.decode_batch_fast({0: 310, 1: 271}, 16)
    got = te.decode_batch_fast({0: 310, 1: 271}, 16)
    assert got == want
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)


def test_generate_and_context_shift(paths):
    """generate_fast through the all-slots blocks, and the host generate
    past n_ctx (a context shift on the sharded cache)."""
    je = _jeng(paths["llama"], tp=2, n_slots=2)
    te = _teng(paths["llama"], tp=2, n_slots=2)
    want = je.generate_fast(PROMPT, n_predict=24, stop_on_eos=False)[0]
    assert te.generate_fast(PROMPT, n_predict=24, stop_on_eos=False)[0] \
        == want
    assert te.n_past[0] == je.n_past[0]
    je = _jeng(paths["llama"], tp=2, n_slots=2, n_ctx=32)
    te = _teng(paths["llama"], tp=2, n_slots=2, n_ctx=32)
    want = je.generate(PROMPT, n_predict=40, stop_on_eos=False,
                       sampling=JSamplingParams(temp=0.0))[0]
    got = te.generate(PROMPT, n_predict=40, stop_on_eos=False,
                      sampling=SamplingParams(temp=0.0))[0]
    assert got == want and len(got) == 40
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)


def test_seq_surgery(paths):
    je = _jeng(paths["llama"], tp=2, n_slots=2)
    te = _teng(paths["llama"], tp=2, n_slots=2)
    for e in (je, te):
        e.prefill(0, PROMPT * 4)
        e.seq_rm(0, 2, 6)
        e.seq_add(0, 6, 100, -4)
        e.n_past[0] -= 4
    np.testing.assert_allclose(te.decode_one(0, 302), je.decode_one(0, 302),
                               **TOL)


def test_embed_dp2(paths):
    je = _jeng(paths["llama"], dp=2, n_slots=2)
    te = _teng(paths["llama"], dp=2, n_slots=2)
    np.testing.assert_allclose(te.embed(PROMPT, slot=1),
                               je.embed(PROMPT, slot=1), **TOL)


def test_validation_errors(paths):
    for eng in (_jeng, _teng):
        with pytest.raises(ValueError, match="n_kv_heads"):
            eng(paths["llama"], tp=4)           # 2 kv heads % 4 != 0
        with pytest.raises(ValueError, match="n_heads"):
            eng(paths["llama"], tp=3)
        with pytest.raises(ValueError, match="n_slots"):
            eng(paths["llama"], dp=2, n_slots=3)
        with pytest.raises(ValueError, match="dp only"):
            eng(paths["mamba"], tp=2)


@pytest.mark.parametrize("writer", ["jax", "jax_tp2", "port", "port_tp2"])
def test_session_files_cross(paths, tmp_path, writer):
    """A session written by either package, meshed or not, loads in the
    other package, meshed and not, and the next step's logits agree."""
    mk = {"jax": _jeng, "port": _teng}
    save = {"jax": jsession.save_session, "port": tsession.save_session}
    load = {"jax": jsession.load_session, "port": tsession.load_session}
    pkg, tp = writer.split("_tp")[0], 2 if "_tp" in writer else 1
    w = mk[pkg](paths["llama"], tp=tp, n_slots=2)
    w.prefill(1, PROMPT)
    f = str(tmp_path / "s.bin")
    save[pkg](f, w, tokens=PROMPT)
    want = w.decode_one(1, 7)
    other = "port" if pkg == "jax" else "jax"
    for rtp in (1, 2):
        r = mk[other](paths["llama"], tp=rtp, n_slots=2)
        assert load[other](f, r) == PROMPT
        np.testing.assert_allclose(r.decode_one(1, 7), want, **TOL)


@pytest.mark.parametrize("name,dp,tp", [("moe", 1, 2), ("bloom", 1, 2),
                                        ("bloom", 2, 2)])
def test_moe_and_bloom(paths, name, dp, tp):
    """The MoE model's one sum over the experts (row_moe "psum"); bloom's
    ALiBi slopes at each rank's head offset and its biased fused QKV."""
    je = _jeng(paths[name], dp=dp, tp=tp, n_slots=2)
    te = _teng(paths[name], dp=dp, tp=tp, n_slots=2)
    assert (te.cfg_step.row_attn, te.cfg_step.row_ffn,
            te.cfg_step.row_moe) == (je.cfg_step.row_attn,
                                     je.cfg_step.row_ffn, je.cfg_step.row_moe)
    if name == "moe":
        assert te.cfg_step.row_moe == "psum"
    else:
        assert te.params.ranks[0]["layers"][0].get("bqkv_fused") is not None
    np.testing.assert_allclose(te.prefill(1, PROMPT, logits_all=True),
                               je.prefill(1, PROMPT, logits_all=True), **TOL)
    assert te.generate_fast(PROMPT, n_predict=12, stop_on_eos=False)[0] \
        == je.generate_fast(PROMPT, n_predict=12, stop_on_eos=False)[0]


def test_mamba_dp2(paths):
    je = _jeng(paths["mamba"], dp=2, n_slots=2)
    te = _teng(paths["mamba"], dp=2, n_slots=2)
    np.testing.assert_allclose(te.prefill(1, PROMPT, logits_all=True),
                               je.prefill(1, PROMPT, logits_all=True), **TOL)
    assert te.decode_batch_fast({1: 310}, 16) == \
        je.decode_batch_fast({1: 310}, 16)


def test_q2k_tp2(paths):
    """Q2_K at tp 2: the port equals its tp 1; the JAX engine reads a
    "scales" plane (engine.py:264) that Q2_K's scd / dm planes lack."""
    with pytest.raises(KeyError, match="scales"):
        _jeng(paths["q2k"], tp=2)
    te = _teng(paths["q2k"], tp=2, n_slots=2)
    assert te.cfg_step.row_ffn == "psum"
    ref = _teng(paths["q2k"], n_slots=2)
    np.testing.assert_allclose(te.prefill(1, PROMPT, logits_all=True),
                               ref.prefill(1, PROMPT, logits_all=True),
                               **TOL)
    assert te.generate_fast(PROMPT, n_predict=12, stop_on_eos=False)[0] \
        == ref.generate_fast(PROMPT, n_predict=12, stop_on_eos=False)[0]
