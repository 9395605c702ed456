"""The port's GPipe pipeline (tpulamm_torch.parallel.pipeline) against the
JAX one (tpulamm.parallel.pipeline, shard_map over conftest's 8 virtual
CPU devices), at tests/test_torch_train.py's widths with 4 layers (vocab
64, dim 64, 4 / 2 heads, ffn 128), 4 microbatches of 2 x 16 tokens.

Tolerances: at pp 2 and 4 the loss within 1e-5 relative of the JAX
pipeline's and every gradient within 1e-5 of its tensor's max|g| (the JAX
test holds its pipeline to the unpipelined loss at 1e-4 and its grads at
rtol 2e-3); the port's pipeline against the port's unpipelined
causal_lm_loss likewise. 3 train_step_pp steps with make_optimizer(tc) on
each side (AdamW, warmup, clip): each loss within 1e-5 relative; every
param within 2e-4 of its tensor's max|p| and all but 0.1% of the
elements within 1e-6 (Adam turns a gradient that rounding leaves near 0 into
a full step of either sign: the few elements there part by up to ~lr).
Across two gloo processes (tests/_torch_mesh_worker.py "pipeline": pp 2,
one stage a process, and pp 4, two) every loss and param equals the
one-process run's bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_mesh_worker import run_training
from tpulamm.models.config import ModelConfig as JConfig
from tpulamm.ops.rope import RopeParams as JRope
from tpulamm.parallel import pipeline as JP
from tpulamm.train import model as JM
from tpulamm.train import train as JT
from tpulamm_torch.models.config import ModelConfig as PConfig
from tpulamm_torch.ops.rope import RopeParams as PRope
from tpulamm_torch.parallel import pipeline as PP
from tpulamm_torch.train import model as PM
from tpulamm_torch.train import optim as PO
from tpulamm_torch.train import train as PT

KW = dict(arch="llama", vocab_size=64, dim=64, n_layers=4, n_heads=4,
          n_kv_heads=2, ffn_dim=128, n_ctx_train=64, norm_eps=1e-5,
          compute_dtype="float32")
JCFG = JConfig(rope=JRope(n_rot=16), **KW)
PCFG = PConfig(rope=PRope(n_rot=16), **KW)
M, MB, T = 4, 2, 16
TOKENS = np.random.default_rng(0).integers(0, 64, (M, MB, T + 1)).astype(
    np.int32)


def _max_rel(want: list, got: list) -> float:
    return max(float(np.abs(np.asarray(w) - g.detach().numpy()).max()
                     / np.abs(np.asarray(w)).max())
               for w, g in zip(want, got))


def _port_grads(n_pp: int):
    params = PP.stack_layer_params(PM.init_params(PCFG, seed=0,
                                                  device="cpu"))
    loss_fn = PP.make_pipeline_loss(PCFG, PP.make_pp_mesh(n_pp, "cpu"), M)
    return PT.value_and_grad(lambda p: loss_fn(p, TOKENS), params,
                             PO.tree_leaves(params))


@pytest.mark.parametrize("n_pp", [2, 4])
def test_loss_and_grads_match_jax(n_pp):
    loss_fn = JP.make_pipeline_loss(JCFG, JP.make_pp_mesh(n_pp), M)
    jl, jg = jax.value_and_grad(loss_fn)(
        JP.stack_layer_params(JM.init_params(JCFG, seed=0)),
        jnp.asarray(TOKENS))
    pl, pg = _port_grads(n_pp)
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _max_rel(jax.tree_util.tree_leaves(jg), pg) <= 1e-5


def test_matches_unpipelined_loss():
    p = PM.init_params(PCFG, seed=0, device="cpu")
    flat = torch.as_tensor(TOKENS.reshape(-1, T + 1))
    rl, rg = PT.value_and_grad(lambda t: PM.causal_lm_loss(t, PCFG, flat),
                               p, PO.tree_leaves(p))
    ref = PP.stack_layer_params(PO.tree_unflatten(p, rg))
    pl, pg = _port_grads(4)
    assert abs(float(pl) - float(rl)) <= 1e-5 * abs(float(rl))
    assert _max_rel([g.numpy() for g in PO.tree_leaves(ref)], pg) <= 1e-5


@pytest.mark.parametrize("n_pp", [2, 4])
def test_train_steps_match_jax(n_pp):
    tc = dict(lr=3e-3, n_steps=3, warmup_steps=1)
    jmesh = JP.make_pp_mesh(n_pp)
    js = JP.stack_layer_params(JM.init_params(JCFG, seed=0))
    jopt = JT.make_optimizer(JT.TrainConfig(**tc))
    jst = jopt.init(js)
    pmesh = PP.make_pp_mesh(n_pp, "cpu")
    ps = PP.stack_layer_params(PM.init_params(PCFG, seed=0, device="cpu"))
    popt = PT.make_optimizer(PT.TrainConfig(**tc))
    pst = popt.init(PO.tree_leaves(ps))
    for _ in range(3):
        js, jst, jl = JP.train_step_pp(JCFG, jmesh, js, jopt, jst,
                                       jnp.asarray(TOKENS), n_micro=M)
        ps, pst, pl = PP.train_step_pp(PCFG, pmesh, ps, popt, pst, TOKENS,
                                       n_micro=M)
        assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    n_far = n_all = 0
    for w, g in zip(jax.tree_util.tree_leaves(js), PO.tree_leaves(ps)):
        w = np.asarray(w)
        d = np.abs(w - g.numpy()) / np.abs(w).max()
        assert d.max() <= 2e-4
        n_far += int((d > 1e-6).sum())
        n_all += d.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def test_stack_plan_and_save(tmp_path):
    """stack / unstack round trip in layer order, the plan, and the
    unstacked tree written by save_params_gguf as the unpipelined one."""
    p = PM.init_params(PCFG, seed=3, device="cpu")
    st = PP.stack_layer_params(p)
    assert st["layers"]["wq"].shape == (4, 64, 64)
    assert PP.pipeline_specs(st) == {
        "tok_emb": None, "out_norm": None, "output": None,
        "layers": {k: "pp" for k in p["layers"][0]}}
    a, b = tmp_path / "a.gguf", tmp_path / "b.gguf"
    PM.save_params_gguf(p, PCFG, str(a))
    PM.save_params_gguf(PP.unstack_layer_params(st), PCFG, str(b))
    assert a.read_bytes() == b.read_bytes()
    mesh = PP.make_pp_mesh(2, "cpu")
    assert PP.shard_stages(st, mesh) is st
    assert list(mesh.stages) == [0, 1]


def test_raises():
    with pytest.raises(ValueError, match="must divide"):
        PP.make_pipeline_loss(PCFG, PP.make_pp_mesh(3, "cpu"), M)
    ps = PP.stack_layer_params(PM.init_params(PCFG, seed=0, device="cpu"))
    mesh = PP.make_pp_mesh(2, "cpu")
    opt = PT.make_optimizer(PT.TrainConfig(optimizer="lbfgs"))
    # as in JAX, the step gives the update no value: L-BFGS cannot run
    with pytest.raises(TypeError, match="value"):
        PP.train_step_pp(PCFG, mesh, ps, opt, opt.init(PO.tree_leaves(ps)),
                         TOKENS, n_micro=M)


@pytest.mark.parametrize("n_pp", [2, 4])
def test_two_process_pipeline(tmp_path, n_pp):
    one, *procs = run_training("pipeline", tmp_path, str(n_pp))
    for res in procs:
        assert res.files == one.files
        for k in one.files:
            assert np.array_equal(res[k], one[k]), k
    assert one["losses"][-1] < one["losses"][0]
