"""Port parity for llava: CLIP (models/clip.py), the forward's `embeds`
input with Engine.eval_embeds, and cli.llava, against the JAX package.

A tiny CLIP tower (hidden 64, 2 heads, 3 layers, ffn 128, image 56, patch
14) with a projector to 256, written by the port's tools.synth through
convert_hf_clip (read by both loaders), and the tiny Q4_0 llama of
_torch_port_models (dim 256). Tolerances: at f32 compute the encoders
agree within 1e-5 of max|ref| (mlp and mlp_norm; anyres with
spatial_unpad and flat); at the default bf16 compute within cosine
0.9999; the preprocessing is equal bit for bit; eval_embeds' logits within
1e-5 of max|ref| at f32 compute; cli.llava's greedy text on an .npy image
equals the JAX CLI's.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.cli.llava import main as jllava_main
from tpulamm.models import clip as JC
from tpulamm.models.transformer import embed as jembed
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm_torch.cli.llava import main as llava_main
from tpulamm_torch.models import clip as TC
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.tools.synth import write_clip_gguf

PINS = (56, 112, 112, 56, 112, 112)
TOWER = dict(hidden=64, n_heads=2, n_layers=3, ffn=128, image=56, patch=14,
             proj_dim=256, skip_last=0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("llava")
    mm = str(d / "mmproj.gguf")
    write_clip_gguf(mm, 3, **TOWER)
    return {"mmproj": mm, "lm": write_tiny_llama(str(d / "lm.gguf"))}


def _towers(path, dtype="float32"):
    tc, tp = TC.load_clip(path, compute_dtype=dtype, device="cpu")
    jc, jp = JC.load_clip(path, compute_dtype=getattr(jnp, dtype))
    return (tc, tp), (jc, jp)


def _mlp_norm(tower, jtower, rng):
    """Both towers with llava's mlp_norm projector (mm.0, LN mm.1, mm.3,
    LN mm.4) of the same random draws."""
    (tc, tp), (jc, jp) = tower, jtower
    d, h = TOWER["proj_dim"], TOWER["hidden"]
    shapes = {0: (d, h), 1: (d,), 3: (d, d), 4: (d,)}
    tmm, jmm = {}, {}
    for i, shp in shapes.items():
        w = (rng.standard_normal(shp).astype(np.float32) * 0.1
             + (1.0 if len(shp) == 1 else 0.0))
        b = rng.standard_normal(shp[0]).astype(np.float32) * 0.01
        tmm[i] = tuple(torch.from_numpy(a).to(tp["patch_w"].dtype)
                       for a in (w, b))
        jmm[i] = tuple(jnp.asarray(a, jp["patch_w"].dtype) for a in (w, b))
    return ((replace(tc, proj_type="mlp_norm"), {**tp, "mm": tmm}),
            (replace(jc, proj_type="mlp_norm"), {**jp, "mm": jmm}))


@pytest.mark.parametrize("proj", ["mlp", "mlp_norm"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_encode_image_matches_jax(files, proj, cdt):
    tower, jtower = _towers(files["mmproj"], cdt)
    if proj == "mlp_norm":
        tower, jtower = _mlp_norm(tower, jtower, np.random.default_rng(1))
    pix = np.random.default_rng(0).normal(size=(2, 56, 56, 3)).astype(
        np.float32)
    got = TC.encode_image(*tower, pix).numpy()
    ref = np.asarray(JC.encode_image(*jtower, jnp.asarray(pix)))
    assert got.shape == ref.shape == (2, 16, TOWER["proj_dim"])
    if cdt == "float32":
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        cos = (got * ref).sum() / np.linalg.norm(got) / np.linalg.norm(ref)
        assert cos >= 0.9999, cos


def test_preprocessing_equals_jax():
    """preprocess_image (pad to square), select_best_resolution,
    preprocess_anyres and _unpad_spatial: equal arrays."""
    cfg = TC.ClipVisionConfig(hidden_size=64, n_heads=2, n_layers=3,
                              n_ff=128, image_size=56, patch_size=14,
                              image_grid_pinpoints=PINS)
    jcfg = JC.ClipVisionConfig(hidden_size=64, n_heads=2, n_layers=3,
                               n_ff=128, image_size=56, patch_size=14,
                               image_grid_pinpoints=PINS)
    rng = np.random.default_rng(2)
    for hw in ((90, 130), (130, 90), (56, 56), (33, 200)):
        img = rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
        np.testing.assert_array_equal(TC.preprocess_image(img, cfg),
                                      JC.preprocess_image(img, jcfg))
        assert (TC.select_best_resolution(hw, PINS)
                == JC.select_best_resolution(hw, PINS))
        (t, g, o), (jt, jg, jo) = (TC.preprocess_anyres(img, cfg),
                                   JC.preprocess_anyres(img, jcfg))
        np.testing.assert_array_equal(t, jt)
        assert (g, o) == (jg, jo)
        feat = rng.standard_normal((8, 12, 5)).astype(np.float32)
        np.testing.assert_array_equal(TC._unpad_spatial(feat, hw),
                                      JC._unpad_spatial(feat, hw))


@pytest.mark.parametrize("merge", ["spatial_unpad", "flat"])
def test_encode_image_anyres_matches_jax(files, merge, tmp_path):
    """The port reads the anyres keys from the file (the JAX load_clip
    raises on an image_grid_pinpoints array: ROADMAP section 3), so the
    JAX tower gets them by replace, as its own tests do."""
    path = str(tmp_path / "anyres.gguf")
    write_clip_gguf(path, 3, **TOWER, pinpoints=PINS, merge=merge)
    tc, tp = TC.load_clip(path, compute_dtype="float32", device="cpu")
    assert tc.image_grid_pinpoints == PINS and tc.mm_patch_merge_type == merge
    (_, _), (jc, jp) = _towers(files["mmproj"])
    jc = replace(jc, image_grid_pinpoints=PINS, mm_patch_merge_type=merge)
    if tp["image_newline"] is not None:
        jp["image_newline"] = tp["image_newline"].numpy()
    img = np.random.default_rng(4).integers(0, 255, (90, 130, 3)).astype(
        np.uint8)
    got = TC.encode_image_anyres(tc, tp, img)
    ref = JC.encode_image_anyres(jc, jp, img)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_eval_embeds_matches_jax(files):
    """Text, then 40 embeddings in n_ubatch 16 chunks (16, 16, 8), then a
    decode step: the logits equal the JAX engine's (f32 caches: a bf16
    cache rounds last-bit differences of K and V to a bf16 step); the
    token embeddings fed back through eval_embeds give the token prefill's
    logits."""
    kw = dict(n_ctx=128, n_ubatch=16, compute_dtype="float32")
    je = JEngine(files["lm"], kv_dtype=jnp.float32, **kw)
    te = Engine(files["lm"], kv_dtype=torch.float32, device="cpu", **kw)
    emb = np.random.default_rng(5).normal(size=(40, 256)).astype(np.float32)
    for eng in (je, te):
        eng.prefill(0, [1, 300, 301])
    ref, got = je.eval_embeds(0, emb), te.eval_embeds(0, emb)
    assert int(te.n_past[0]) == int(je.n_past[0]) == 43
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    ref, got = je.decode_one(0, 7), te.decode_one(0, 7)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    toks = [1, 9, 33, 7, 300]
    tok_emb = np.asarray(jembed(je.params, je.cfg, jnp.asarray(toks)),
                         np.float32)
    te.reset_slot(0)
    want = te.prefill(0, toks)
    te.reset_slot(0)
    np.testing.assert_allclose(te.eval_embeds(0, tok_emb), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_llava_cli_matches_jax(files, tmp_path, capsys):
    """cli.llava at temp 0 on an .npy image: the same greedy text as the
    JAX CLI (both at their default bf16 compute on the CPU)."""
    img = str(tmp_path / "img.npy")
    np.save(img, np.random.default_rng(0).integers(0, 255, (40, 24, 3))
            .astype(np.uint8))
    argv = ["-m", files["lm"], "--mmproj", files["mmproj"], "--image", img,
            "-p", "the <image> cat", "-n", "6", "--temp", "0", "-c", "128"]
    assert jllava_main(argv) == 0
    ref = capsys.readouterr().out
    assert llava_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == ref and got.strip()
