"""dp across processes: the port's mesh with its dp groups in different
processes, for serving and for training, on the CPU (gloo).

Every case starts its processes from tests/_torch_mesh_worker.py together
with the same run in one process (one torch thread each), and holds each
process to that one-process run bit for bit:

- the mesh's rank blocks: whole dp groups or a part of one; a block that
  splits a dp group unevenly raises ValueError (block_size here, and
  make_mesh(3, P) over the P processes of every engine case);
- Engine(dp=2, tp=1) and Engine(dp=2, tp=2) over 2 processes (one dp group
  each) and Engine(dp=2, tp=2) over 4 (one rank each: the tp groups and the
  dp exchange both cross processes), n_slots 4, n_ctx 64, f32: the last
  slot's prefill logits (logits_all) and 12 greedy generate_fast tokens;
  a seq_cp and a move_slot from dp group 0 to the last group, then a
  decode from each copy (the destination's rows, held in another process
  than the source's, hold the copied positions: the copy is not skipped);
  save_session, its file equal to the one-process file entry by entry
  (the zip headers carry the write time) and written in process 0's
  working directory only (each process runs in a directory of its own),
  loaded into a fresh engine whose next 4 greedy tokens are the saved
  engine's (process 0 reads it and sends the others their parts). The one-process runs
  are held to the JAX Engine(tp=2, dp=2) on conftest's 8 virtual devices:
  logits within rtol / atol 2e-4, the same tokens;
- a mamba Engine(dp=2) over 2 processes (its slots on dp only): the same
  drive, the copies moving the recurrent state's rows;
- train(mesh=make_mesh(2, 1)) over 2 processes and make_mesh(2, 2) over 4,
  3 AdamW then 2 L-BFGS steps (the worker's train_run): losses and params
  bit for bit; the one-process runs against the JAX train(mesh=) at the
  same (dp, tp): AdamW losses within 1e-5 relative, L-BFGS losses within
  1e-4, the params after the L-BFGS steps within 1e-4 of each tensor's
  max|p| (tests/test_torch_train_mesh.py's tolerances);
- the two-process server at --dp 2 --tp 2 with 4 slots and a system
  prompt (its seq_cp fan-out crosses the processes): four concurrent
  greedy completions equal to the one-process dp 2 x tp 2 server's.
"""

import json
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_mesh_worker import (DATA, LBFGS_STEPS, PROMPT, SYSTEM,
                                TRAIN_KW, TRAIN_STEPS, _free_port, run_dp,
                                run_training)
from test_torch_multihost import _finish, _post, _spawn, _wait_health
from tpulamm.gguf.constants import GGMLType
from tpulamm.models.config import ModelConfig as JConfig
from tpulamm.ops.rope import RopeParams as JRope
from tpulamm.parallel import mesh as jmesh
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm.train import model as JM
from tpulamm.train import train as JT
from tpulamm_torch.parallel.mesh import block_size
from tpulamm_torch.server.server import serve
from tpulamm_torch.tools.synth import write_llama_gguf, write_mamba_gguf

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The multihost tests' model (8 heads over 8 KV heads, F32, dim 256)
    and a 2-layer mamba."""
    d = tmp_path_factory.mktemp("dpp")
    out = {"llama": str(d / "m.gguf"), "mamba": str(d / "mamba.gguf")}
    write_llama_gguf(out["llama"], 2, np.random.default_rng(31), dim=256,
                     ffn=512, n_head=8, vocab=512, qtype=GGMLType.F32,
                     std=0.08)
    write_mamba_gguf(out["mamba"], 2, 23, dim=256, d_inner=512, d_state=16,
                     d_conv=4, dt_rank=16, vocab=512)
    return out


@pytest.mark.parametrize("dp,tp,count,n_local", [
    (2, 1, 2, 1), (2, 2, 2, 2), (2, 2, 4, 1), (4, 2, 2, 4), (1, 4, 2, 2),
    (2, 3, 2, 3), (3, 2, 3, 2)])
def test_rank_blocks(dp, tp, count, n_local):
    assert block_size(dp, tp, count) == n_local


@pytest.mark.parametrize("dp,tp,count", [(3, 2, 2), (3, 4, 2), (2, 2, 3)])
def test_uneven_rank_blocks_raise(dp, tp, count):
    with pytest.raises(ValueError, match=f"mesh \\({dp}, {tp}\\)"):
        block_size(dp, tp, count)


def _entries(path) -> list:
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


def _held_to_one(one, procs, tmp_path, count):
    """Every process's results equal the one-process run's bit for bit,
    the destination's rows after the seq_cp are held once over the
    processes and equal the reference's, and the session file, in process
    0's working directory alone, holds the reference's entries."""
    for r in procs:
        for key in ("logits", "tokens", "cp", "mv", "next_loaded",
                    "next_kept"):
            assert np.array_equal(r[key], one[key]), key
        assert r["next_loaded"].tolist() == r["next_kept"].tolist()
        assert str(r["uneven"]).startswith(
            f"mesh (3, {count}) over {count} processes: a block of 3 ranks "
            "splits a dp group")
    held = [row for r in procs for row in json.loads(str(r["copied"]))]
    assert held == json.loads(str(one["copied"]))
    assert _entries(tmp_path / "p0" / "session.npz") == \
        _entries(tmp_path / "session_one.npz")
    # the other processes' working directories never held the file: their
    # loads came from process 0
    assert not any((tmp_path / f"p{i}" / "session.npz").exists()
                   for i in range(1, count))
    return held


@pytest.fixture(scope="module")
def jax_dp2_tp2(models):
    je = JEngine(models["llama"], n_ctx=64, n_slots=4, tp=2, dp=2,
                 compute_dtype="float32", kv_dtype=jnp.float32)
    return (je.prefill(3, PROMPT, logits_all=True),
            je.generate_fast(PROMPT, n_predict=12, stop_on_eos=False,
                             slot=3)[0])


@pytest.mark.parametrize("dp,tp,count", [(2, 1, 2), (2, 2, 2), (2, 2, 4)])
def test_engine_across_processes(models, jax_dp2_tp2, tmp_path, dp, tp,
                                 count):
    one, *procs = run_dp(models["llama"], dp, tp, count, tmp_path)
    held = _held_to_one(one, procs, tmp_path, count)
    # the last group's first slot got slot 0's six cells on every tp index
    # (a copy whose source is in another process is not skipped)
    assert held == [list(range(len(PROMPT))) + [-1] * (65 - len(PROMPT))
                    ] * tp
    n_local = dp * tp // count
    last = procs[-1]["mesh"]
    assert str(last) == (
        f"mesh (dp {dp}, tp {tp}): "
        + (f"rank {count - 1}" if n_local == 1 else
           f"ranks {dp * tp - n_local}-{dp * tp - 1}")
        + f" of {dp * tp} on cpu, process {count - 1} of {count}")
    logits, tokens = jax_dp2_tp2
    np.testing.assert_allclose(one["logits"], logits, **TOL)
    assert one["tokens"].tolist() == tokens


def test_mamba_across_processes(models, tmp_path):
    one, *procs = run_dp(models["mamba"], 2, 1, 2, tmp_path)
    held = _held_to_one(one, procs, tmp_path, 2)
    assert len(held) == 1 and held[0][0] > 0     # the state's rows came


@pytest.mark.parametrize("dp,tp,count", [(2, 1, 2), (2, 2, 4)])
def test_train_across_processes(tmp_path, dp, tp, count):
    one, *procs = run_training("train", tmp_path, str(dp), str(tp),
                               nproc=count)
    for res in procs:
        assert res.files == one.files
        for k in one.files:
            assert np.array_equal(res[k], one[k]), k
    cfg = JConfig(rope=JRope(n_rot=16), **TRAIN_KW)
    data = np.asarray(DATA, np.int32)
    mesh = jmesh.make_mesh(dp, tp)
    jp, la = JT.train(JM.init_params(cfg, seed=0), cfg, data,
                      JT.TrainConfig(lr=3e-3, batch_size=4, seq_len=16,
                                     n_steps=TRAIN_STEPS, warmup_steps=1),
                      log_every=0, mesh=mesh)
    jp, lb = JT.train(jp, cfg, data, JT.TrainConfig(
        optimizer="lbfgs", lr=0.5, batch_size=4, seq_len=16,
        n_steps=LBFGS_STEPS, seed=1), log_every=0, mesh=mesh)
    got = one["losses"]
    np.testing.assert_allclose(got[:TRAIN_STEPS], la, rtol=1e-5)
    np.testing.assert_allclose(got[TRAIN_STEPS:], lb, rtol=1e-4)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    assert len(want) == len(one.files) - 1
    for i, w in enumerate(want):
        assert np.abs(one[f"leaf{i}"] - w).max() <= 1e-4 * np.abs(w).max()


REQS = [{"prompt": p, "n_predict": n, "temperature": 0.0,
         "repeat_penalty": 1.0}
        for p, n in (("the cat sat on the mat. the cat", 12),
                     ("a mat", 8), ("the dog", 10), ("on the", 6))]


def _four(base):
    with ThreadPoolExecutor(4) as ex:
        return list(ex.map(lambda r: _post(base, "/completion", r), REQS))


def test_server_dp2_tp2_across_processes(models):
    """The two-process server at --dp 2 --tp 2 (process 0 serves HTTP and
    mirrors its engine calls, process 1 holds dp group 1): four
    concurrent greedy requests over 4 slots after the system prompt's
    fan-out, each equal to the one-process dp 2 x tp 2 server's."""
    path = models["llama"]
    http0 = _free_port()
    procs = _spawn(["server", str(_free_port())],
                   [path, str(http0), str(_free_port()),
                    "dp=2,tp=2,np=4,sys"])
    started = threading.Event()
    threading.Thread(target=serve, args=(path,), daemon=True, kwargs=dict(
        host="127.0.0.1", port=0, n_slots=4, n_ctx=128, tp=2, dp=2,
        system_prompt=SYSTEM, started=started, compute_dtype="float32",
        device="cpu")).start()
    try:
        assert started.wait(timeout=120)
        one = _four(f"http://127.0.0.1:{started.httpd.server_port}")
        base = f"http://127.0.0.1:{http0}"
        _wait_health(base, procs)
        two = _four(base)
    finally:
        if started.is_set():
            started.sched.running = False
            started.httpd.shutdown()
        procs[0].terminate()          # the frontend stops the worker first
        outs = _finish(procs, 60)
    assert procs[1].returncode == 0, outs[1][1].decode()[-2000:]
    for (st1, o1), (st2, o2) in zip(one, two):
        assert st1 == st2 == 200 and o1["tokens_predicted"] > 0
        assert o2["content"] == o1["content"]
