"""The port's LoRA path (tpulamm_torch.train.lora, cli.finetune,
cli.export_lora, Engine(lora_path=)) against the JAX package's on the CPU.

Two models: tests/test_train.py's dense 64-wide one for the finetune
arithmetic, and the tiny quantized llama of tests/_torch_port_models.py
(dim 256, 2 layers, ffn 512, vocab 512; every projection a QTensor) as
the base an adapter patches. The JAX side quantizes with its numpy
quantizers (its native codec switched off, as tests/test_torch_quantize_
cli.py does: that codec differs from the numpy reference in rare bits).

Tolerances: init_lora, the adapter files, the patched planes and
export_lora's file exactly; 3 finetune steps (warmup 1) the losses within
1e-5 relative and the adapters within 1e-4 of max|a| and max|b| (Adam
divides each element's step by its own gradient's size, so the packages'
~1e-6 relative gradient differences come out larger in the adapters: 1.7e-5
of max|b| here); the patched engine's prefill logits
within 1e-4 of max|logit| of the JAX engine's (the engines' tolerance in
tests/test_torch_engine.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.cli import export_lora as JEX
from tpulamm.cli import finetune as JFT
from tpulamm.gguf.constants import GGMLType
from tpulamm.models.config import ModelConfig as JConfig
from tpulamm.ops.rope import RopeParams as JRope
from tpulamm.quant import native as j_native
from tpulamm.train import lora as JL
from tpulamm.train import model as JM
from tpulamm.train import train as JT
from tpulamm_torch.cli import export_lora as PEX
from tpulamm_torch.cli import finetune as PFT
from tpulamm_torch.models.config import ModelConfig as PConfig
from tpulamm_torch.ops.qtensor import QTensor
from tpulamm_torch.ops.rope import RopeParams as PRope
from tpulamm_torch.train import lora as PL
from tpulamm_torch.train import model as PM
from tpulamm_torch.train import optim as PO
from tpulamm_torch.train import train as PT

KW = dict(arch="llama", vocab_size=64, dim=64, n_layers=2, n_heads=4,
          n_kv_heads=2, ffn_dim=128, n_ctx_train=64, norm_eps=1e-5,
          compute_dtype="float32")
JCFG = JConfig(rope=JRope(n_rot=16), **KW)
PCFG = PConfig(rope=PRope(n_rot=16), **KW)
DATA = np.tile(np.arange(10, dtype=np.int32), 60)
# the tiny quantized llama's projection shapes (N, K)
SHAPES = {"wq": (256, 256), "wk": (128, 256), "wv": (128, 256),
          "wo": (256, 256), "w_gate": (512, 256), "w_up": (512, 256),
          "w_down": (256, 512)}


@pytest.fixture
def jax_numpy_quantizers(monkeypatch):
    monkeypatch.setattr(j_native, "get_lib", lambda: None)


def _adapter(targets, r=4, alpha=8, seed=0) -> dict:
    """A JAX lora tree for the tiny quantized llama with B != 0."""
    rng = np.random.default_rng(seed)
    layers = []
    for _ in range(2):
        entry = {}
        for key in targets:
            n, k = SHAPES[key]
            entry[key] = {
                "a": jnp.asarray(rng.normal(0, 1.0 / r, (r, k)), jnp.float32),
                "b": jnp.asarray(rng.normal(0, 0.05, (n, r)), jnp.float32)}
        layers.append(entry)
    return {"r": r, "alpha": alpha, "layers": layers}


def _torch_tree(lora: dict) -> dict:
    return {"r": lora["r"], "alpha": lora["alpha"], "layers": [
        {k: {ab: torch.from_numpy(np.array(v)) for ab, v in e.items()}
         for k, e in layer.items()} for layer in lora["layers"]]}


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    return {"dir": d,
            "q4_0": write_tiny_llama(str(d / "q4_0.gguf"), GGMLType.Q4_0),
            "q8_0": write_tiny_llama(str(d / "q8_0.gguf"), GGMLType.Q8_0,
                                     seed=1)}


def test_init_and_merge_lora():
    jp = JM.init_params(JCFG, seed=2)
    pp = PM.init_params(PCFG, seed=2, device="cpu")
    jl = JL.init_lora(jp, r=4, alpha=8, seed=5, targets=("wq", "w_down"))
    pl = PL.init_lora(pp, r=4, alpha=8, seed=5, targets=("wq", "w_down"))
    for a, b in zip(jax.tree_util.tree_leaves(jl["layers"]),
                    PO.tree_leaves(pl["layers"])):
        assert np.array_equal(np.asarray(a), b.numpy())
    # B = 0: the merged model is the base, to the bit
    merged = PL.merge_lora(pp, pl)
    assert torch.equal(merged["layers"][1]["wq"], pp["layers"][1]["wq"])
    for layer in jl["layers"]:
        for ab in layer.values():
            ab["b"] = ab["b"] + 0.01
    for layer in pl["layers"]:
        for ab in layer.values():
            ab["b"] = ab["b"] + 0.01
    want = JL.merge_lora(jp, jl)["layers"][0]["w_down"]
    got = PL.merge_lora(pp, pl)["layers"][0]["w_down"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_finetune_lora_matches_jax():
    tc = dict(lr=5e-3, batch_size=4, seq_len=16, n_steps=3, warmup_steps=1)
    jp = JM.init_params(JCFG, seed=3)
    pp = PM.init_params(PCFG, seed=3, device="cpu")
    targets = ("wq", "wv", "w_up", "w_down")
    jl, jloss = JL.finetune_lora(jp, JCFG, DATA, JT.TrainConfig(**tc), r=8,
                                 alpha=16, targets=targets, log=lambda s: None)
    pl, ploss = PL.finetune_lora(pp, PCFG, DATA, PT.TrainConfig(**tc), r=8,
                                 alpha=16, targets=targets, log=lambda s: None)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    for jlay, play in zip(jl["layers"], pl["layers"]):
        assert list(jlay) == list(play) == sorted(targets)
        for key in targets:
            for ab in ("a", "b"):
                w, g = np.asarray(jlay[key][ab]), play[key][ab].numpy()
                assert np.abs(w - g).max() <= 1e-4 * np.abs(w).max()


def test_adapter_files_both_ways(tmp_path):
    jl = _adapter(("wq", "wv", "w_down"))
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    JL.save_lora_gguf(jl, a)
    PL.save_lora_gguf(_torch_tree(jl), b)
    assert open(a, "rb").read() == open(b, "rb").read()
    back = PL.load_lora_gguf(a)
    assert (back["r"], back["alpha"]) == (4, 8)
    for x, y in zip(jax.tree_util.tree_leaves(JL.load_lora_gguf(b)["layers"]),
                    PO.tree_leaves(back["layers"])):
        assert np.array_equal(np.asarray(x), y.numpy())


@pytest.mark.usefixtures("jax_numpy_quantizers")
@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
def test_apply_lora_planes_equal_jax(bases, tmp_path, fmt):
    from tpulamm.models.loader import load_model as jload
    from tpulamm_torch.models.loader import load_model as pload
    ad = str(tmp_path / "ad.gguf")
    JL.save_lora_gguf(_adapter(("wq", "wv", "w_down"), seed=1), ad)
    jcfg, jparams, _ = jload(bases[fmt], compute_dtype="float32")
    pcfg, pparams, _ = pload(bases[fmt], compute_dtype="float32")
    jout = JL.apply_lora_to_qparams(jparams, JL.load_lora_gguf(ad), jcfg)
    pout = PL.apply_lora_to_qparams(pparams, PL.load_lora_gguf(ad), pcfg)
    for jlay, play, base in zip(jout["layers"], pout["layers"],
                                pparams["layers"]):
        for key in ("wq", "wv", "w_down", "wk"):
            w = play[key]
            assert isinstance(w, QTensor) and w.qtype.name == fmt.upper()
            for name, plane in jlay[key].planes.items():
                got = w.planes[name].numpy()
                assert np.array_equal(got.view(np.asarray(plane).dtype),
                                      np.asarray(plane)), (key, name)
        assert play["wk"] is base["wk"]          # untouched
        assert not torch.equal(play["wq"].planes["scales"],
                               base["wq"].planes["scales"])


@pytest.mark.usefixtures("jax_numpy_quantizers")
def test_engine_lora_path_matches_jax(bases, tmp_path):
    from tpulamm.runtime.engine import Engine as JEngine
    from tpulamm_torch.runtime.engine import Engine as PEngine
    ad = str(tmp_path / "ad.gguf")
    JL.save_lora_gguf(_adapter(("wq", "wk", "w_up"), seed=2), ad)
    toks = [1, 5, 9, 200, 31, 7, 77, 3]
    kw = dict(n_ctx=32, compute_dtype="float32")
    want = JEngine(bases["q4_0"], lora_path=ad, **kw).prefill(
        0, toks, logits_all=True)
    base = PEngine(bases["q4_0"], device="cpu", **kw).prefill(
        0, toks, logits_all=True)
    eng = PEngine(bases["q4_0"], lora_path=ad, device="cpu", **kw)
    got = eng.prefill(0, toks, logits_all=True)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(got - base).max() > 1e-2 * np.abs(base).max()
    # the fused projections carry the delta
    from tpulamm_torch.models.loader import load_model as pload
    cfg, params, _ = pload(bases["q4_0"], compute_dtype="float32")
    patched = PL.apply_lora_to_qparams(params, PL.load_lora_gguf(ad), cfg)
    for layer, want_l in zip(eng.params["layers"], patched["layers"]):
        for name in ("qs", "scales"):
            fused = layer["wqkv_fused"].planes[name]
            assert torch.equal(fused[:, :256], want_l["wq"].planes[name])
            assert torch.equal(fused[:, 256:384], want_l["wk"].planes[name])


@pytest.mark.usefixtures("jax_numpy_quantizers")
def test_export_lora_bytes(bases, tmp_path):
    """export_lora's file equals the JAX tool's for -l and for two -s
    pairs; its patched planes equal Engine(lora_path=)'s; a file that is
    no adapter raises."""
    from tpulamm_torch.runtime.engine import Engine as PEngine
    ad = str(tmp_path / "ad.gguf")
    JL.save_lora_gguf(_adapter(("wq", "w_up"), seed=3), ad)
    for argv in (["-l", ad], ["-s", ad, "0.5", "-s", ad, "0.25"]):
        a, b = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
        assert JEX.main(["-m", bases["q4_0"], "-o", a, "-q", *argv]) == 0
        assert PEX.main(["-m", bases["q4_0"], "-o", b, "-q", *argv]) == 0
        assert open(a, "rb").read() == open(b, "rb").read()
    PEX.export_lora(bases["q4_0"], b, [(ad, 1.0)], verbose=False)
    kw = dict(n_ctx=32, compute_dtype="float32", device="cpu")
    baked = PEngine(b, **kw).params["layers"]
    loaded = PEngine(bases["q4_0"], lora_path=ad, **kw).params["layers"]
    for x, y in zip(baked, loaded):
        for key in ("wqkv_fused", "wgateup_fused", "w_down"):
            for name in x[key].planes:
                assert torch.equal(x[key].planes[name], y[key].planes[name])
    with pytest.raises(ValueError, match="not a LoRA adapter"):
        PEX.export_lora(bases["q4_0"], str(tmp_path / "x.gguf"),
                        [(bases["q4_0"], 1.0)], verbose=False)


def test_finetune_cli_writes_the_jax_adapter(bases, tmp_path):
    """cli.finetune after one step (lr 0: the adapters stay at their
    draws) writes the JAX CLI's adapter byte for byte; after two steps the
    adapters are within 1e-4 of max|a|, max|b|."""
    text = tmp_path / "t.txt"
    text.write_text("the cat sat on the mat and the dog sat too. " * 20)
    argv = ["-m", bases["q4_0"], "--train-data", str(text), "--ctx", "32",
            "-b", "2", "--lora-r", "4", "--targets", "wq,wv,w_down"]
    for iters in ("1", "2"):
        a, b = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
        assert JFT.main(argv + ["--iters", iters, "-o", a]) == 0
        assert PFT.main(argv + ["--iters", iters, "-o", b, "--device",
                                "cpu"]) == 0
        if iters == "1":
            assert open(a, "rb").read() == open(b, "rb").read()
            continue
        ja, pa = JL.load_lora_gguf(a), PL.load_lora_gguf(b)
        for x, y in zip(jax.tree_util.tree_leaves(ja["layers"]),
                        PO.tree_leaves(pa["layers"])):
            x = np.asarray(x)
            assert np.abs(x - y.numpy()).max() <= 1e-4 * np.abs(x).max()
