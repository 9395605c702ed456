"""Subprocess worker of tests/test_torch_multihost.py,
tests/test_torch_train_mesh.py and tests/test_torch_pipeline.py (not a
test): one process of a two-process port mesh or pipeline over gloo on the
CPU. It imports the port only (no JAX).

    engine COORD_PORT PID MODEL OUT_DIR
        the process joins the world (2 processes, 4 tp ranks each), builds
        Engine(tp=8) and writes its prefill logits and greedy tokens to
        OUT_DIR/procPID.json.
    server COORD_PORT PID MODEL HTTP_PORT BCAST_PORT [OPTS]
        the two-process server (tp=8, 2 slots): process 0 serves HTTP and
        mirrors its engine calls, process 1 applies them and exits 0 when
        the channel closes. OPTS: a comma list, "lookup" for
        --lookup-decoding, "hb=SECONDS" for the heartbeat deadline.
    train COORD_PORT PID OUT_DIR
        training over a tp 2 mesh across the two processes (one rank
        each, gloo): TRAIN_STEPS AdamW steps then LBFGS_STEPS L-BFGS steps
        (train_run); writes the losses and the params in the global layout
        to OUT_DIR/procPID.npz.
    pipeline COORD_PORT PID OUT_DIR N_PP
        the GPipe pipeline at pp N_PP across the two processes (N_PP / 2
        stages each): PP_STEPS AdamW train_step_pp steps (pipeline_run);
        writes the losses and the gathered stacked params to
        OUT_DIR/procPID.npz.
    one MODE OUT_DIR [N_PP]
        the same run (MODE "train" or "pipeline") in one process, the
        reference, written to OUT_DIR/one.npz.
Each training run uses one torch thread, so the processes and the
one-process reference multiply alike.
"""

import json
import os
import sys

PROMPT = [1, 17, 42, 5, 99, 7]


def engine(port, pid, model, outdir) -> int:
    from tpulamm_torch.parallel.distributed import init_distributed
    info = init_distributed(coordinator=f"127.0.0.1:{port}",
                            num_processes=2, process_id=int(pid), ranks=8)
    assert info["local_devices"] == 4 and info["global_devices"] == 8, info
    import numpy as np
    import torch

    from tpulamm_torch.runtime.engine import Engine
    torch.set_num_threads(2)
    eng = Engine(model, n_ctx=64, tp=8, compute_dtype="float32",
                 kv_dtype=torch.float32, device="cpu")
    logits = eng.prefill(0, PROMPT, logits_all=True)
    toks, _ = eng.generate_fast(PROMPT, n_predict=12, stop_on_eos=False)
    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
        json.dump({"info": info, "mesh": eng.mesh.describe(),
                   "logits": np.asarray(logits, np.float64).tolist(),
                   "tokens": [int(t) for t in toks]}, f)
    return 0


def server(port, pid, model, http_port, bport, opts="") -> int:
    opts = [o for o in opts.split(",") if o]
    heartbeat = 5.0
    for o in opts:
        if o.startswith("hb="):
            heartbeat = float(o[3:])
    import signal
    import threading
    import time

    import torch

    from tpulamm_torch.parallel.distributed import init_distributed
    from tpulamm_torch.server.server import serve
    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=2,
                     process_id=int(pid), ranks=8)
    torch.set_num_threads(2)
    started = threading.Event()
    if int(pid) == 0:
        # on SIGTERM stop the worker over the broadcast channel first,
        # give it a beat to exit, then go
        def on_term(sig, frm):
            def stop():
                sched = getattr(started, "sched", None)
                if sched is not None:
                    sched.running = False
                    eng = sched.engine
                    if hasattr(eng, "shutdown_workers"):
                        eng.shutdown_workers()
                time.sleep(1.0)
                os._exit(0)
            threading.Thread(target=stop, daemon=True).start()
        signal.signal(signal.SIGTERM, on_term)
    serve(model, host="127.0.0.1", port=int(http_port), n_slots=2,
          n_ctx=128, tp=8, broadcast=("127.0.0.1", int(bport)),
          started=started, lookup_decoding="lookup" in opts,
          heartbeat=heartbeat, compute_dtype="float32", device="cpu")
    # the worker returns on the stop frame or the channel's EOF; skip the
    # interpreter teardown of the process group
    os._exit(0)


# -- training (tests/test_torch_train_mesh.py, tests/test_torch_pipeline.py)

TRAIN_KW = dict(arch="llama", vocab_size=64, dim=64, n_layers=4,
                n_heads=4, n_kv_heads=2, ffn_dim=128, n_ctx_train=64,
                norm_eps=1e-5, compute_dtype="float32")
TRAIN_STEPS, LBFGS_STEPS, PP_STEPS = 3, 2, 3
DATA = list(range(10)) * 60


def train_cfg():
    from tpulamm_torch.models.config import ModelConfig
    from tpulamm_torch.ops.rope import RopeParams
    return ModelConfig(rope=RopeParams(n_rot=16), **TRAIN_KW)


def _leaves(tree):
    from tpulamm_torch.train.optim import tree_leaves
    return [x.detach().numpy() for x in tree_leaves(tree)]


def train_run(mesh) -> dict:
    """AdamW, then L-BFGS, over `mesh` from init_params(seed 0)."""
    import numpy as np

    from tpulamm_torch.train.model import init_params
    from tpulamm_torch.train.train import TrainConfig, train
    cfg = train_cfg()
    params = init_params(cfg, seed=0, device="cpu")
    data = np.asarray(DATA, np.int32)
    _, la = train(params, cfg, data, TrainConfig(
        lr=3e-3, batch_size=4, seq_len=16, n_steps=TRAIN_STEPS,
        warmup_steps=1), log_every=0, mesh=mesh)
    _, lb = train(params, cfg, data, TrainConfig(
        optimizer="lbfgs", lr=0.5, batch_size=4, seq_len=16,
        n_steps=LBFGS_STEPS, seed=1), log_every=0, mesh=mesh)
    return {"losses": np.asarray(la + lb), "leaves": _leaves(params)}


def pipeline_tokens():
    import numpy as np
    return np.random.default_rng(0).integers(0, 64, (4, 2, 17))


def pipeline_run(mesh) -> dict:
    """PP_STEPS train_step_pp steps at n_micro 4 from init_params(seed
    0), stacked and cut to this process's stages."""
    import numpy as np

    from tpulamm_torch.parallel import pipeline as pp
    from tpulamm_torch.train import optim
    from tpulamm_torch.train.model import init_params
    from tpulamm_torch.train.train import TrainConfig, make_optimizer
    cfg = train_cfg()
    local = pp.shard_stages(pp.stack_layer_params(
        init_params(cfg, seed=0, device="cpu")), mesh)
    opt = make_optimizer(TrainConfig(lr=3e-3, n_steps=PP_STEPS,
                                     warmup_steps=1))
    state = opt.init(optim.tree_leaves(local))
    losses = []
    for _ in range(PP_STEPS):
        local, state, loss = pp.train_step_pp(cfg, mesh, local, opt, state,
                                              pipeline_tokens(), n_micro=4)
        losses.append(float(loss))
    return {"losses": np.asarray(losses),
            "leaves": _leaves(pp.gather_stages(local, mesh))}


def _save(path, res) -> None:
    import numpy as np
    np.savez(path, losses=res["losses"],
             **{f"leaf{i}": x for i, x in enumerate(res["leaves"])})


def _train_mode(run, make, port, pid, outdir) -> int:
    import torch

    from tpulamm_torch.parallel.distributed import init_distributed
    torch.set_num_threads(1)
    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=2,
                     process_id=int(pid))
    _save(os.path.join(outdir, f"proc{pid}.npz"), run(make()))
    return 0


def train_tp(port, pid, outdir) -> int:
    from tpulamm_torch.parallel.mesh import make_mesh
    return _train_mode(train_run, lambda: make_mesh(1, 2, "cpu"), port, pid,
                       outdir)


def pipeline(port, pid, outdir, n_pp) -> int:
    from tpulamm_torch.parallel.pipeline import make_pp_mesh
    return _train_mode(pipeline_run, lambda: make_pp_mesh(int(n_pp), "cpu"),
                       port, pid, outdir)


def one(mode, outdir, n_pp="0") -> int:
    import torch

    from tpulamm_torch.parallel.mesh import make_mesh
    from tpulamm_torch.parallel.pipeline import make_pp_mesh
    torch.set_num_threads(1)
    res = (train_run(make_mesh(1, 2, "cpu")) if mode == "train"
           else pipeline_run(make_pp_mesh(int(n_pp), "cpu")))
    _save(os.path.join(outdir, "one.npz"), res)
    return 0


def run_training(mode: str, outdir, *extra) -> list:
    """Start the one-process reference and the two processes of `mode`
    ("train" or "pipeline") together -> their npz results (one, proc0,
    proc1). For the tests, which import this module."""
    import socket
    import subprocess

    import numpy as np
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    cmds = [["one", mode, str(outdir), *extra]] + [
        [mode, port, str(pid), str(outdir), *extra] for pid in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *c],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for c in cmds]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=240)[1])
        except subprocess.TimeoutExpired:
            p.kill()
            errs.append(p.communicate()[1])
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise RuntimeError(err.decode()[-3000:])
    return [np.load(os.path.join(outdir, f"{n}.npz"))
            for n in ("one", "proc0", "proc1")]


if __name__ == "__main__":
    mode, *rest = sys.argv[1:]
    sys.exit({"engine": engine, "server": server, "train": train_tp,
              "pipeline": pipeline, "one": one}[mode](*rest))
