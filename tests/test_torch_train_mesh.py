"""The port's sharded training (train.train(mesh=), train.shards'
TrainShards, train.model.forward_train over a rank list) against the JAX
train(mesh=jax make_mesh(dp, tp)) on conftest's 8 virtual CPU devices, at
tests/test_torch_train.py's size (vocab 64, dim 64, 2 layers, 4 / 2 heads,
ffn 128).

Tolerances: the shard plan of the dense training tree equal to the JAX
param_pspecs at tp 2 and 4; at (dp, tp) in {(2, 2), (1, 2), (4, 1)} 5
AdamW steps (warmup and clipping included) with each loss within 1e-5
relative and every param within 1e-5 of its tensor's max|p|, returned in
the global layout; 2 L-BFGS steps at (2, 2) and 1 layer, losses within
1e-4 relative and params within 1e-4 of max|p| (test_torch_train.py's
L-BFGS tolerances); a grad_mask run at (2, 2) (frozen tensors unchanged
bit for bit, the rest within 1e-5); an FFN width and a vocab tp does not
divide (replicated, computed once) against the unmeshed port within
1e-5; remat under the mesh against the same steps without it within
1e-6. Across two gloo processes
(tests/_torch_mesh_worker.py "train", tp 2, one rank each, 4 layers, 3
AdamW then 2 L-BFGS steps) every loss and param equals the one-process
tp 2 run's bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_mesh_worker import run_training
from tpulamm.models.config import ModelConfig as JConfig
from tpulamm.ops.rope import RopeParams as JRope
from tpulamm.parallel import mesh as jmesh
from tpulamm.train import model as JM
from tpulamm.train import train as JT
from tpulamm_torch.models.config import ModelConfig as PConfig
from tpulamm_torch.ops.rope import RopeParams as PRope
from tpulamm_torch.parallel.mesh import make_mesh, param_plan
from tpulamm_torch.train import model as PM
from tpulamm_torch.train import optim as PO
from tpulamm_torch.train import train as PT
from tpulamm_torch.train.shards import TrainShards

KW = dict(arch="llama", vocab_size=64, dim=64, n_layers=2, n_heads=4,
          n_kv_heads=2, ffn_dim=128, n_ctx_train=64, norm_eps=1e-5,
          compute_dtype="float32")
JCFG = JConfig(rope=JRope(n_rot=16), **KW)
PCFG = PConfig(rope=PRope(n_rot=16), **KW)
DATA = np.tile(np.arange(10, dtype=np.int32), 60)


def _close(want, got, tol):
    """Each leaf of `got` (global layout) within tol x max|leaf of want|."""
    wl, gl = jax.tree_util.tree_leaves(want), PO.tree_leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        w, g = np.asarray(w), g.detach().numpy()
        assert w.shape == g.shape
        assert np.abs(w - g).max() <= tol * np.abs(w).max()


def _axis(spec):
    """The plan's letter of a JAX PartitionSpec: "N" on dim 0, "K" on 1."""
    if len(spec) and spec[0] == "tp":
        return "N"
    return "K" if len(spec) > 1 and spec[1] == "tp" else None


@pytest.mark.parametrize("tp", [2, 4])
def test_plan_equals_param_pspecs(tp):
    jp = JM.init_params(JCFG, seed=0)
    specs = jmesh.param_pspecs(jp, JCFG, jmesh.make_mesh(1, tp))
    plan = param_plan(PM.init_params(PCFG, seed=0, device="cpu"), tp)
    for key in ("tok_emb", "out_norm", "output"):
        assert plan[key] == _axis(specs[key]), key
    for lp, ls in zip(plan["layers"], specs["layers"]):
        assert set(lp) == set(ls)
        for key in lp:
            assert lp[key] == _axis(ls[key]), key
    assert plan["output"] == "N" and plan["layers"][0]["w_down"] == "K"


def test_shards_round_trip():
    """The unique leaves: the replicated tensors once and each rank's
    shards; gather restores the global tensors; vdot counts each element
    once."""
    p = PM.init_params(PCFG, seed=5, device="cpu")
    sh = TrainShards(p, make_mesh(2, 2, "cpu"))
    # the head is vocab-sharded: tok_emb, out_norm and two norms a layer
    n_repl = 2 + 2 * PCFG.n_layers
    assert sh.n_repl == n_repl
    assert len(sh.leaves) == n_repl + 2 * (len(PO.tree_leaves(p)) - n_repl)
    for a, b in zip(PO.tree_leaves(p), sh.gather(sh.leaves)):
        assert torch.equal(a, b)
    full = PO.tree_vdot(PO.tree_leaves(p), PO.tree_leaves(p))
    assert abs(float(sh.vdot(sh.leaves, sh.leaves)) - float(full)) \
        <= 1e-6 * float(full)
    ranks = sh.ranks(sh.leaves)
    assert ranks[0]["tok_emb"] is ranks[1]["tok_emb"]
    assert ranks[1]["layers"][0]["wq"].shape == (32, 64)
    assert ranks[1]["layers"][0]["wo"].shape == (64, 32)


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 2), (4, 1)])
def test_adamw_steps_match_jax(dp, tp):
    tc = dict(lr=3e-3, batch_size=4, seq_len=16, n_steps=5, warmup_steps=2)
    jp, jl = JT.train(JM.init_params(JCFG, seed=0), JCFG, DATA,
                      JT.TrainConfig(**tc), log_every=0,
                      mesh=jmesh.make_mesh(dp, tp))
    p0 = PM.init_params(PCFG, seed=0, device="cpu")
    pp, pl = PT.train(p0, PCFG, DATA, PT.TrainConfig(**tc), log_every=0,
                      mesh=make_mesh(dp, tp, "cpu"))
    assert pp is p0                      # the caller's tensors, updated
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _close(jp, pp, 1e-5)


def test_lbfgs_steps_match_jax():
    jcfg = dataclasses.replace(JCFG, n_layers=1)
    pcfg = dataclasses.replace(PCFG, n_layers=1)
    tc = dict(optimizer="lbfgs", lr=0.5, batch_size=4, seq_len=16,
              n_steps=2)
    jp, jl = JT.train(JM.init_params(jcfg, seed=0), jcfg, DATA,
                      JT.TrainConfig(**tc), log_every=0,
                      mesh=jmesh.make_mesh(2, 2))
    stats = {}
    pp, pl = PT.train(PM.init_params(pcfg, seed=0, device="cpu"), pcfg,
                      DATA, PT.TrainConfig(**tc), log_every=0, stats=stats,
                      mesh=make_mesh(2, 2, "cpu"))
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    _close(jp, pp, 1e-4)
    assert len(stats["trials"]) == 2 and min(stats["trials"]) >= 1


def test_grad_mask_matches_jax():
    """LoRA-style freezing: only the attention's wq and wv train."""
    jp0 = JM.init_params(JCFG, seed=2)
    pp0 = PM.init_params(PCFG, seed=2, device="cpu")

    def mask(tree, ones, zeros):
        m = {k: zeros(v) for k, v in tree.items() if k != "layers"}
        m["layers"] = [{k: (ones(v) if k in ("wq", "wv") else zeros(v))
                        for k, v in lyr.items()} for lyr in tree["layers"]]
        return m
    jmask = mask(jp0, jnp.ones_like, jnp.zeros_like)
    pmask = mask(pp0, torch.ones_like, torch.zeros_like)
    before = {k: pp0["layers"][0][k].clone()
              for k in ("wk", "w_down", "wq")}
    emb0 = pp0["tok_emb"].clone()
    tc = dict(lr=3e-3, batch_size=4, seq_len=16, n_steps=3, warmup_steps=1,
              weight_decay=0.0)
    jp, _ = JT.train(jp0, JCFG, DATA, JT.TrainConfig(**tc), log_every=0,
                     grad_mask=jmask, mesh=jmesh.make_mesh(2, 2))
    pp, _ = PT.train(pp0, PCFG, DATA, PT.TrainConfig(**tc), log_every=0,
                     grad_mask=pmask, mesh=make_mesh(2, 2, "cpu"))
    assert torch.equal(pp["tok_emb"], emb0)
    for k in ("wk", "w_down"):
        assert torch.equal(pp["layers"][0][k], before[k])
    assert not torch.equal(pp["layers"][0]["wq"], before["wq"])
    _close(jp, pp, 1e-5)


def test_replicated_ffn_and_head():
    """An FFN width and a vocab that tp 2 does not divide: the plan keeps
    w_gate / w_up / w_down and the head replicated, and the meshed run
    computes each once (JAX's GSPMD runs any shape): 3 AdamW steps equal
    the unmeshed port's within 1e-5 (losses relative, params of max|p|)."""
    cfg = dataclasses.replace(PCFG, ffn_dim=129, vocab_size=65)
    plan = param_plan(PM.init_params(cfg, device="cpu"), 2)
    assert plan["output"] is None and plan["layers"][0]["w_down"] is None
    tc = PT.TrainConfig(lr=3e-3, batch_size=4, seq_len=16, n_steps=3,
                        warmup_steps=1)
    want, wl = PT.train(PM.init_params(cfg, seed=1, device="cpu"), cfg,
                        DATA, tc, log_every=0)
    got, gl = PT.train(PM.init_params(cfg, seed=1, device="cpu"), cfg,
                       DATA, tc, log_every=0, mesh=make_mesh(1, 2, "cpu"))
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    for a, b in zip(PO.tree_leaves(want), PO.tree_leaves(got)):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()


def test_remat_under_mesh():
    """remat (torch.utils.checkpoint a rank-list layer) recomputes the same
    forward: 2 AdamW steps at dp 2 x tp 2 with and without it, the losses
    and params equal within 1e-6."""
    tc = dict(lr=3e-3, batch_size=4, seq_len=16, n_steps=2, warmup_steps=1)
    runs = [PT.train(PM.init_params(PCFG, seed=3, device="cpu"), PCFG, DATA,
                     PT.TrainConfig(remat=r, **tc), log_every=0,
                     mesh=make_mesh(2, 2, "cpu")) for r in (False, True)]
    (want, wl), (got, gl) = runs
    np.testing.assert_allclose(gl, wl, rtol=1e-6)
    for a, b in zip(PO.tree_leaves(want), PO.tree_leaves(got)):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()


def test_two_process_train(tmp_path):
    one, *procs = run_training("train", tmp_path)
    for res in procs:
        assert res.files == one.files
        for k in one.files:
            assert np.array_equal(res[k], one[k]), k
    assert len(one["losses"]) == 5 and one["losses"][-1] < one["losses"][0]
