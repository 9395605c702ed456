"""Port parity: tpulamm_torch.ops.mega_decode's plain version against the
JAX package's decode megakernel run in interpret mode, on the same planes
and cache made with numpy from a seed (the CUDA kernel against the plain
version: tests/test_torch_cuda.py and chip_smoke.py phase 3c).

Tolerance: x_out, k_new and v_new within 1e-2 * max|ref|. Both sides
dequantize to identical f32 weights and round to bf16 at the same points;
what differs is the order of the f32 sums, which can flip a bf16 rounding
of the residual stream. The measured maxima are printed (pytest -s).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.models.config import ModelConfig as JConfig
from tpulamm.ops import pallas_decode
from tpulamm.ops.qtensor import QTensor as JQTensor
from tpulamm.ops.rope import RopeParams as JRope
from tpulamm.quant import formats
from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.ops import mega_decode as M
from tpulamm_torch.ops.qtensor import QTensor
from tpulamm_torch.ops.rope import RopeParams

S = 32                   # cache cells


def make_pair(seed, *, qt=GGMLType.Q4_0, dim=256, n_layers=2, H=4, Hkv=2,
              ffn=512, rope_kind="norm", n_rot=None):
    """The same random llama stack as JAX and as port params, configs."""
    rng = np.random.default_rng(seed)
    hd = dim // H
    kw = dict(arch="llama", vocab_size=128, dim=dim, n_layers=n_layers,
              n_heads=H, n_kv_heads=Hkv, ffn_dim=ffn)
    jcfg = JConfig(**kw, rope=JRope(n_rot=n_rot or hd, kind=rope_kind))
    tcfg = ModelConfig(**kw, rope=RopeParams(n_rot=n_rot or hd,
                                             kind=rope_kind))

    def q(n, k):
        raw = formats.quantize(
            (rng.standard_normal((n, k)) * 0.05).astype(np.float32), qt)
        return (JQTensor.from_gguf_raw(raw, qt, (n, k)),
                QTensor.from_gguf_raw(raw, qt, (n, k)))

    jl, tl = [], []
    for _ in range(n_layers):
        ws = {"wqkv_fused": q((H + 2 * Hkv) * hd, dim), "wo": q(dim, H * hd),
              "wgateup_fused": q(2 * ffn, dim), "w_down": q(dim, ffn)}
        norms = {n: (1.0 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
                 for n in ("attn_norm", "ffn_norm")}
        jl.append({**{k: v[0] for k, v in ws.items()},
                   **{k: jnp.asarray(v) for k, v in norms.items()}})
        tl.append({**{k: v[1] for k, v in ws.items()},
                   **{k: torch.from_numpy(v) for k, v in norms.items()}})
    return jcfg, {"layers": jl}, tcfg, {"layers": tl}, rng


def make_step(rng, cfg, n_live=20):
    """x, the cache (cells 0..n_live-1 live at positions 0.., a seq_rm hole
    at 5..7, the rest empty) and the step's position / cell."""
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    x = rng.standard_normal((1, cfg.dim)).astype(np.float32)
    k = rng.standard_normal((L, 1, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((L, 1, Hkv, S, hd)).astype(np.float32)
    kpos = np.full((1, S), -1, np.int32)
    kpos[0, :n_live] = np.arange(n_live)
    kpos[0, 5:8] = -1
    return x, k, v, kpos, n_live


def run_jax(jcfg, jparams, x, k, v, kpos, qpos):
    mega = pallas_decode.build_mega(jparams, jcfg, S)
    assert mega is not None
    qp = jnp.asarray([qpos], jnp.int32)
    lanes = pallas_decode.rope_lane_vectors(
        mega.rope, jcfg.head_dim, jcfg.n_heads, jcfg.n_kv_heads, qp)
    out = pallas_decode.mega_decode_layers(
        mega.spec, jnp.asarray(x), qp, jnp.asarray(kpos),
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), *lanes,
        mega.planes, mega.norms, interpret=True)
    return [np.asarray(o, np.float32) for o in out], [np.asarray(t)
                                                      for t in lanes]


def run_port(tcfg, tparams, x, k, v, kpos, qpos, cell, span=S):
    mega = M.build_mega(tparams, tcfg)
    assert mega is not None
    kc = [torch.from_numpy(k[i]).to(torch.bfloat16) for i in range(len(k))]
    vc = [torch.from_numpy(v[i]).to(torch.bfloat16) for i in range(len(v))]
    lanes = M.rope_lane_vectors(mega.rope, tcfg.head_dim, tcfg.n_heads,
                                tcfg.n_kv_heads,
                                torch.tensor([qpos], dtype=torch.int32))
    out = M.mega_decode_layers(
        mega, torch.from_numpy(x), qpos, cell,
        torch.from_numpy(kpos)[:, :span], [t[:, :, :span] for t in kc],
        [t[:, :, :span] for t in vc], *lanes)
    return out, lanes, kc, vc


CASES = {
    "norm_q4_0": dict(rope_kind="norm"),
    "neox_q4_0": dict(rope_kind="neox"),
    "q8_0": dict(qt=GGMLType.Q8_0),
    "q4_1": dict(qt=GGMLType.Q4_1),
    "mha_partial_rot": dict(H=4, Hkv=4, rope_kind="neox", n_rot=32),
    "gqa_g4": dict(dim=512, H=8, Hkv=2, ffn=768),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_mega_ref_matches_pallas(case):
    jcfg, jp, tcfg, tp, rng = make_pair(31, **CASES[case])
    x, k, v, kpos, cell = make_step(rng, tcfg)
    (jx, jk, jv), jlanes = run_jax(jcfg, jp, x, k, v, kpos, cell)
    (tx, tk, tv), tlanes, kc, vc = run_port(tcfg, tp, x, k, v, kpos, cell,
                                            cell)
    for a, b in zip(tlanes, jlanes):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
    errs = []
    for got, want in ((tx, jx), (tk, jk), (tv, jv)):
        assert got.shape == want.shape
        err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        errs.append(err)
        assert err <= 1e-2
    print(f"{case}: x_out / k_new / v_new max err over max|ref|: "
          + " / ".join(f"{e:.2e}" for e in errs))
    # the new rows went into the cache, bf16, at the cell
    hd = tcfg.head_dim
    for layer in range(tcfg.n_layers):
        want_k = tk[layer, 0].reshape(tcfg.n_kv_heads, hd).to(torch.bfloat16)
        assert torch.equal(kc[layer][0, :, cell], want_k)
        want_v = tv[layer, 0].reshape(tcfg.n_kv_heads, hd).to(torch.bfloat16)
        assert torch.equal(vc[layer][0, :, cell], want_v)


def test_span_read_equals_full_read():
    """The engine's span view and the full cache give identical output:
    cells past the span are empty and add exact zeros."""
    _, _, tcfg, tp, rng = make_pair(37)
    x, k, v, kpos, cell = make_step(rng, tcfg, n_live=12)
    full, _, kf, _ = run_port(tcfg, tp, x, k, v, kpos, cell, cell)
    span, _, ks, _ = run_port(tcfg, tp, x, k, v, kpos, cell, cell, span=16)
    for a, b in zip(full, span):
        assert torch.equal(a, b)
    for a, b in zip(kf, ks):
        assert torch.equal(a, b)


def test_build_mega_within_the_tpu_budget():
    """At a shape that fits the TPU's VMEM budget both packages build the
    megakernel's operands (the port applies no budget: ROADMAP §3)."""
    jcfg, jp, tcfg, tp, _ = make_pair(41)
    assert pallas_decode.build_mega(jp, jcfg, S) is not None
    mega = M.build_mega(tp, tcfg)
    assert mega is not None
    assert mega.norms["attn_norm"].shape == (2, 256)
    assert mega.layers[0]["wo"] is tp["layers"][0]["wo"]      # not copied


def test_build_mega_ineligible():
    jcfg, jp, tcfg, tp, _ = make_pair(43)
    tcfg.qk_norm = True
    assert M.build_mega(tp, tcfg) is None
    tcfg.qk_norm = False
    tp["layers"][1]["bo"] = torch.zeros(256)
    assert M.build_mega(tp, tcfg) is None
    del tp["layers"][1]["bo"]
    assert M.build_mega(tp, tcfg) is not None
    _, _, _, other, _ = make_pair(44, qt=GGMLType.Q8_0)
    tp["layers"][1]["wo"] = other["layers"][1]["wo"]          # mixed formats
    assert M.build_mega(tp, tcfg) is None
    del tp["layers"][0]["wqkv_fused"]
    assert M.build_mega(tp, tcfg) is None


@pytest.mark.parametrize("S,blocks,H", [
    (1, 132, 32), (7, 132, 32), (1024, 132, 32), (1025, 132, 4),
    (5000, 132, 1), (4097, 8, 64), (2**21 + 1, 132, 32), (2**23 + 3, 132, 8)])
def test_attn_chunks(S, blocks, H):
    """Phase B's items cover the span with no empty chunk, at most
    MAX_CHUNK keys each; past 2M cells there are more chunks than half a
    MAX_CHUNK (the kernel's merge takes any number)."""
    nch, chunk = M.attn_chunks(S, blocks, H)
    assert 1 <= chunk <= M.MAX_CHUNK
    assert (nch - 1) * chunk < S <= nch * chunk
    assert nch >= min(blocks // H, -(-S // 8))
    assert (nch > M.MAX_CHUNK // 2) == (S > 2**21)


def test_step_refuses_a_batch():
    _, _, tcfg, tp, rng = make_pair(47)
    mega = M.build_mega(tp, tcfg)
    x, k, v, kpos, cell = make_step(rng, tcfg)
    kc = [torch.zeros((1, 2, S, 64), dtype=torch.bfloat16)] * 2
    lanes = M.rope_lane_vectors(mega.rope, 64, 4, 2, torch.tensor([cell]))
    with pytest.raises(NotImplementedError, match="B0 == 1"):
        M.mega_decode_layers(mega, torch.zeros((2, 256)), cell, cell,
                             torch.from_numpy(kpos), kc, kc, *lanes)


def test_engine_mega_greedy_matches_jax(tmp_path, monkeypatch):
    """Engine(megakernel=True).generate_fast on the CPU gives the JAX
    engine's greedy tokens with TPULAMM_MEGAKERNEL=1, and the cache
    positions of every generated cell."""
    path = write_tiny_llama(str(tmp_path / "q4.gguf"), GGMLType.Q4_0, seed=5)
    monkeypatch.setenv("TPULAMM_MEGAKERNEL", "1")
    from tpulamm.runtime.engine import Engine as JEngine
    from tpulamm_torch.runtime.engine import Engine
    je = JEngine(path, n_ctx=64)
    te = Engine(path, n_ctx=64, megakernel=True, device="cpu")
    assert je.mega is not None and te.mega is not None
    prompt = "the cat sat on the mat"
    want, _ = je.generate_fast(prompt, n_predict=10, stop_on_eos=False)
    M.reset_launches()
    got, _ = te.generate_fast(prompt, n_predict=10, stop_on_eos=False)
    assert got == want and len(got) == 10
    assert M.LAUNCHES["mega_decode"] == 0                  # the CPU runs none
    n = int(te.n_past[0])
    np.testing.assert_array_equal(te.cache.pos[0, :n].numpy(), np.arange(n))
    np.testing.assert_array_equal(te.cell_pos[0, :n], np.arange(n))


def test_engine_mega_reads_the_whole_cache_as_jax(tmp_path, monkeypatch):
    """A megakernel engine's forwards read the whole cache, as the JAX
    engine's do (engine.py:451), so the flash dispatch sees the same span:
    after a 300-token prefill at n_ctx 1024 both give _kv_span(0) None,
    and the prefill's forwards got kv_span None. _mega_step still reads
    the occupied-span view (the bucket 512)."""
    path = write_tiny_llama(str(tmp_path / "q4.gguf"), GGMLType.Q4_0, seed=5)
    monkeypatch.setenv("TPULAMM_MEGAKERNEL", "1")
    from tpulamm.runtime.engine import Engine as JEngine
    from tpulamm_torch.runtime import engine as TE
    prompt = list(np.random.default_rng(5).integers(3, 512, 300))
    je = JEngine(path, n_ctx=1024)
    te = TE.Engine(path, n_ctx=1024, megakernel=True, device="cpu")
    assert je.mega is not None and te.mega is not None
    spans = []
    real_forward = TE.forward

    def forward(*a, kv_span=None, **kw):
        spans.append(kv_span)
        return real_forward(*a, kv_span=kv_span, **kw)
    monkeypatch.setattr(TE, "forward", forward)
    je.prefill(0, prompt)
    te.prefill(0, prompt)
    assert je._kv_span(0) is None
    assert te._kv_span(0) is None
    assert spans == [None]
    assert te._occupied_span(0) == 512
    widths = []
    real_mega = TE.mega_decode_layers

    def mega(m, x, pos, cell, kpos, *a):
        widths.append(kpos.shape[1])
        return real_mega(m, x, pos, cell, kpos, *a)
    monkeypatch.setattr(TE, "mega_decode_layers", mega)
    te._mega_step(0, 7)
    assert widths == [512]
    assert te._kv_span(0) is None
