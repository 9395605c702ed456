"""The port's training path (tpulamm_torch.train, cli.train) against the JAX
package's (tpulamm.train, cli.train) on the CPU, at tests/test_train.py's
size: vocab 64, dim 64, 2 layers, 4 / 2 heads, ffn 128.

Tolerances: init_params, sample_batches and every GGUF file exactly (bit
for bit, byte for byte); logits, the loss and every gradient within 1e-5
of max|ref| (with and without remat); 5 AdamW steps (warmup count and
clipping included, both clip branches) params within 1e-5 of max|p| and
losses within 1e-5 relative; 3 L-BFGS steps (optax.lbfgs) at two
learning rates (the zoom search takes 1-6 trials a step there) each
step's loss within 1e-4 relative and the params within 1e-4 of max|p|.
A file written after steps at lr > 0 cannot be byte-equal (the params
differ in their last bits), so the CLI's file is compared after its
first step, which runs at lr 0 (the schedule's count before increment).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.cli import train as JCLI
from tpulamm.gguf.constants import GGMLType
from tpulamm.models.config import ModelConfig as JConfig
from tpulamm.ops.rope import RopeParams as JRope
from tpulamm.train import model as JM
from tpulamm.train import train as JT
from tpulamm_torch.cli import train as PCLI
from tpulamm_torch.models.config import ModelConfig as PConfig
from tpulamm_torch.ops.rope import RopeParams as PRope
from tpulamm_torch.train import model as PM
from tpulamm_torch.train import optim as PO
from tpulamm_torch.train import train as PT

KW = dict(arch="llama", vocab_size=64, dim=64, n_layers=2, n_heads=4,
          n_kv_heads=2, ffn_dim=128, n_ctx_train=64, norm_eps=1e-5,
          compute_dtype="float32")
JCFG = JConfig(rope=JRope(n_rot=16), **KW)
PCFG = PConfig(rope=PRope(n_rot=16), **KW)
DATA = np.tile(np.arange(10, dtype=np.int32), 60)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(want, got, tol):
    """Each leaf of `got` within tol x max|leaf of want|."""
    wl, gl = jax.tree_util.tree_leaves(want), PO.tree_leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        w, g = _np(w), _np(g)
        assert w.shape == g.shape
        assert np.abs(w - g).max() <= tol * np.abs(w).max()


def test_init_params_and_batches_are_equal():
    jp = JM.init_params(JCFG, seed=3)
    pp = PM.init_params(PCFG, seed=3, device="cpu")
    wl, gl = jax.tree_util.tree_leaves(jp), PO.tree_leaves(pp)
    assert len(wl) == len(gl) == 3 + 9 * 2
    for w, g in zip(wl, gl):
        assert np.array_equal(np.asarray(w), g.numpy())
    tc = dict(batch_size=5, seq_len=16, seed=7)
    jb = JT.sample_batches(DATA, JT.TrainConfig(**tc))
    pb = PT.sample_batches(DATA, PT.TrainConfig(**tc))
    for _ in range(3):
        assert np.array_equal(next(jb), next(pb))


def test_init_params_default_device_is_cuda():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PM.init_params(PCFG)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_gradients(remat):
    jp = JM.init_params(JCFG, seed=1)
    pp = PM.init_params(PCFG, seed=1, device="cpu")
    batch = np.stack([DATA[:17], DATA[3:20]])
    jl = JM.forward_train(jp, JCFG, jnp.asarray(batch))
    pl = PM.forward_train(pp, PCFG, torch.as_tensor(batch))
    ref = np.asarray(jl)
    assert pl.dtype == torch.float32
    assert np.abs(pl.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.causal_lm_loss(p, JCFG, jnp.asarray(batch),
                                    remat=remat)))(jp)
    leaves = PO.tree_leaves(pp)
    ploss, pg = PT.value_and_grad(
        lambda t: PM.causal_lm_loss(t, PCFG, torch.as_tensor(batch),
                                    remat=remat), pp, leaves)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _close(jg, PO.tree_unflatten(pp, pg), 1e-5)


@pytest.mark.parametrize("grad_clip", [1.0, 1e4])
def test_adamw_steps_match_optax(grad_clip):
    """5 steps, 2 of warmup (step 0 at lr 0); the global gradient norm of
    these steps is 3.9-7.6, so clip 1.0 scales every step and 1e4 none."""
    tc = dict(lr=3e-3, batch_size=4, seq_len=16, n_steps=5, warmup_steps=2,
              grad_clip=grad_clip)
    jp, jl = JT.train(JM.init_params(JCFG, seed=0), JCFG, DATA,
                      JT.TrainConfig(**tc), log_every=0)
    pp, pl = PT.train(PM.init_params(PCFG, seed=0, device="cpu"), PCFG,
                      DATA, PT.TrainConfig(**tc), log_every=0)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _close(jp, pp, 1e-5)


def test_first_adamw_step_runs_at_lr_zero():
    p0 = PM.init_params(PCFG, seed=0, device="cpu")
    before = [t.clone() for t in PO.tree_leaves(p0)]
    p1, _ = PT.train(p0, PCFG, DATA, PT.TrainConfig(batch_size=2, seq_len=8,
                                                     n_steps=1), log_every=0)
    assert all(torch.equal(a, b) for a, b in zip(before, PO.tree_leaves(p1)))


def test_schedule_matches_optax():
    import optax
    for warm, n in ((10, 100), (3, 4), (0, 5), (5, 5)):
        tc = PT.TrainConfig(lr=3e-4, warmup_steps=warm, n_steps=n)
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, tc.lr, warm),
             optax.cosine_decay_schedule(tc.lr, max(n - warm, 1))], [warm])
        for c in range(n + 3):
            want = float(sched(jnp.asarray(c, jnp.int32)))
            assert abs(PO.schedule(tc, c) - want) <= 1e-7 * tc.lr


@pytest.mark.parametrize("lr", [0.5, 50.0])
def test_lbfgs_steps_match_optax(lr):
    """At 1 layer (the JAX step's compile sets this test's time)."""
    jcfg = dataclasses.replace(JCFG, n_layers=1)
    pcfg = dataclasses.replace(PCFG, n_layers=1)
    tc = dict(optimizer="lbfgs", lr=lr, batch_size=4, seq_len=16, n_steps=3)
    jp, jl = JT.train(JM.init_params(jcfg, seed=0), jcfg, DATA,
                      JT.TrainConfig(**tc), log_every=0)
    stats = {}
    pp, pl = PT.train(PM.init_params(pcfg, seed=0, device="cpu"), pcfg,
                      DATA, PT.TrainConfig(**tc), log_every=0, stats=stats)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    _close(jp, pp, 1e-4)
    assert len(stats["trials"]) == 3 and min(stats["trials"]) >= 1


def test_train_with_grad_mask_freezes_tensors():
    jp0 = JM.init_params(JCFG, seed=2)
    pp0 = PM.init_params(PCFG, seed=2, device="cpu")
    jmask = jax.tree_util.tree_map(jnp.ones_like, jp0)
    jmask["tok_emb"] = jnp.zeros_like(jmask["tok_emb"])
    pmask = PO.tree_unflatten(pp0, [torch.from_numpy(np.array(m)) for m in
                                    jax.tree_util.tree_leaves(jmask)])
    tc = dict(lr=3e-3, batch_size=4, seq_len=16, n_steps=3, warmup_steps=1,
              weight_decay=0.0)
    emb0 = pp0["tok_emb"].clone()
    jp, _ = JT.train(jp0, JCFG, DATA, JT.TrainConfig(**tc), log_every=0,
                     grad_mask=jmask)
    pp, _ = PT.train(pp0, PCFG, DATA, PT.TrainConfig(**tc), log_every=0,
                     grad_mask=pmask)
    assert torch.equal(pp["tok_emb"], emb0)
    _close(jp, pp, 1e-5)


def test_train_mesh_raises():
    """train(mesh=) runs since the training mesh was ported
    (tests/test_torch_train_mesh.py); it raises where the JAX sharding
    would: a batch that dp does not divide, heads that tp does not."""
    from tpulamm_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="dp=2"):
        PT.train(PM.init_params(PCFG, device="cpu"), PCFG, DATA,
                 PT.TrainConfig(n_steps=1, batch_size=3, seq_len=8),
                 mesh=make_mesh(2, 1, "cpu"))
    with pytest.raises(ValueError, match="tp=4"):
        PT.train(PM.init_params(PCFG, device="cpu"), PCFG, DATA,
                 PT.TrainConfig(n_steps=1), mesh=make_mesh(1, 4, "cpu"))


def test_save_params_gguf_bytes(tmp_path):
    """The same params (the JAX ones) written by both packages, with a
    byte vocab: the same file; each package loads the other's."""
    jp = JM.init_params(JCFG, seed=4)
    pp = PO.tree_unflatten(PM.init_params(PCFG, seed=4, device="cpu"),
                           [torch.from_numpy(np.array(x)) for x in
                            jax.tree_util.tree_leaves(jp)])
    vocab = JCLI.byte_vocab()
    a, b = tmp_path / "j.gguf", tmp_path / "p.gguf"
    JM.save_params_gguf(jp, JCFG, str(a), vocab=vocab)
    PM.save_params_gguf(pp, PCFG, str(b), vocab=PCLI.byte_vocab())
    assert a.read_bytes() == b.read_bytes()
    assert PCLI.byte_vocab() == vocab
    JM.save_params_gguf(jp, JCFG, str(a))
    PM.save_params_gguf(pp, PCFG, str(b))
    assert a.read_bytes() == b.read_bytes()


def test_trained_model_roundtrips_through_gguf(tmp_path):
    """train -> save GGUF -> the port's engine generates the pattern (as
    tests/test_train.py's JAX round trip does)."""
    params = PM.init_params(PCFG, seed=0, device="cpu")
    tc = PT.TrainConfig(lr=3e-3, batch_size=8, seq_len=32, n_steps=80,
                        warmup_steps=5)
    params, losses = PT.train(params, PCFG, DATA, tc, log_every=0)
    assert losses[-1] < 0.8
    path = str(tmp_path / "trained.gguf")
    PM.save_params_gguf(params, PCFG, path)

    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.sampling import SamplingParams
    eng = Engine(path, n_ctx=64, device="cpu")
    ids, _ = eng.generate([0, 1, 2, 3], n_predict=8,
                          sampling=SamplingParams(temp=0.0),
                          stop_on_eos=False)
    assert ids == [4, 5, 6, 7, 8, 9, 0, 1]


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("train") / "text.txt"
    p.write_text("the quick brown fox jumps over the lazy dog. " * 12)
    return str(p)


@pytest.mark.parametrize("vocab", ["bytes", "gguf"])
def test_train_cli_writes_the_jax_file(tmp_path, corpus_file, vocab):
    """cli.train after one step (lr 0) writes the JAX CLI's file byte for
    byte, with the byte vocab and with --vocab-model (the tiny SPM model's
    512-token vocab)."""
    argv = ["--train-data", corpus_file, "--embd", "64", "--head", "4",
            "--head-kv", "2", "--layer", "2", "--ff", "128", "--ctx", "32",
            "-b", "2", "--iters", "1", "--seed", "3"]
    if vocab == "gguf":
        argv += ["--vocab-model", write_tiny_llama(
            str(tmp_path / "vocab.gguf"), GGMLType.Q8_0)]
    a, b = tmp_path / "j.gguf", tmp_path / "p.gguf"
    assert JCLI.main(argv + ["-o", str(a)]) == 0
    assert PCLI.main(argv + ["-o", str(b), "--device", "cpu"]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_train_cli_grad_checkpointing(tmp_path, corpus_file):
    """Three steps with --grad-checkpointing: the port's and the JAX
    file's tensors within 1e-5 of max|w|."""
    from tpulamm_torch.gguf.reader import GGUFReader
    argv = ["--train-data", corpus_file, "--embd", "64", "--head", "4",
            "--head-kv", "2", "--layer", "2", "--ff", "128", "--ctx", "16",
            "-b", "2", "--iters", "3", "--grad-checkpointing", "--lr",
            "0.01"]
    a, b = tmp_path / "j.gguf", tmp_path / "p.gguf"
    assert JCLI.main(argv + ["-o", str(a)]) == 0
    assert PCLI.main(argv + ["-o", str(b), "--device", "cpu"]) == 0
    ra, rb = GGUFReader(str(a)), GGUFReader(str(b))
    assert list(ra.tensors) == list(rb.tensors)
    for name, info in ra.tensors.items():
        w, g = info.to_f32(), rb.tensors[name].to_f32()
        assert np.abs(w - g).max() <= 1e-5 * np.abs(w).max(), name
