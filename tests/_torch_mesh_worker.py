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
        OPTS may also hold "dp=D", "tp=T", "np=SLOTS" (default dp 1, tp 8,
        2 slots) and "sys" for the system prompt SYSTEM.
    train COORD_PORT PID NPROC OUT_DIR [DP TP]
        training over a dp x tp mesh (default 1 x 2) across NPROC
        processes (gloo): TRAIN_STEPS AdamW steps then LBFGS_STEPS L-BFGS
        steps (train_run); writes the losses and the params in the global
        layout to OUT_DIR/procPID.npz.
    pipeline COORD_PORT PID NPROC OUT_DIR N_PP
        the GPipe pipeline at pp N_PP across the two processes (N_PP / 2
        stages each): PP_STEPS AdamW train_step_pp steps (pipeline_run);
        writes the losses and the gathered stacked params to
        OUT_DIR/procPID.npz.
    one MODE OUT_DIR [N_PP | DP TP]
        the same run (MODE "train" or "pipeline") in one process, the
        reference, written to OUT_DIR/one.npz.
    dp COORD_PORT PID NPROC DP TP MODEL OUT_DIR
        one of NPROC processes of a dp x tp serving mesh over gloo (NPROC
        1: the one-process reference, no world): dp_run, written to
        OUT_DIR/dpPID.npz (dp_one.npz for the reference); each process
        runs in OUT_DIR/pPID, process 0 writing the session file there
        (the reference: OUT_DIR/session_one.npz).
Each run uses one torch thread, so the processes and the one-process
reference multiply alike.
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


SYSTEM = "You are a cat on a mat."     # the server's "sys" system prompt


def server(port, pid, model, http_port, bport, opts="") -> int:
    opts = [o for o in opts.split(",") if o]
    kw = dict(o.split("=") for o in opts if "=" in o)
    heartbeat = float(kw.get("hb", 5.0))
    dp, tp = int(kw.get("dp", 1)), int(kw.get("tp", 8))
    import signal
    import threading
    import time

    import torch

    from tpulamm_torch.parallel.distributed import init_distributed
    from tpulamm_torch.server.server import serve
    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=2,
                     process_id=int(pid), ranks=dp * tp)
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
    serve(model, host="127.0.0.1", port=int(http_port),
          n_slots=int(kw.get("np", 2)), n_ctx=128, tp=tp, dp=dp,
          broadcast=("127.0.0.1", int(bport)), started=started,
          lookup_decoding="lookup" in opts,
          system_prompt=SYSTEM if "sys" in opts else None,
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


def _train_mode(run, make, port, pid, nproc, outdir) -> int:
    import torch

    from tpulamm_torch.parallel.distributed import init_distributed
    torch.set_num_threads(1)
    init_distributed(coordinator=f"127.0.0.1:{port}",
                     num_processes=int(nproc), process_id=int(pid))
    _save(os.path.join(outdir, f"proc{pid}.npz"), run(make()))
    return 0


def train_tp(port, pid, nproc, outdir, dp="1", tp="2") -> int:
    from tpulamm_torch.parallel.mesh import make_mesh
    return _train_mode(train_run, lambda: make_mesh(int(dp), int(tp), "cpu"),
                       port, pid, nproc, outdir)


def pipeline(port, pid, nproc, outdir, n_pp) -> int:
    from tpulamm_torch.parallel.pipeline import make_pp_mesh
    return _train_mode(pipeline_run, lambda: make_pp_mesh(int(n_pp), "cpu"),
                       port, pid, nproc, outdir)


def one(mode, outdir, *extra) -> int:
    import torch

    from tpulamm_torch.parallel.mesh import make_mesh
    from tpulamm_torch.parallel.pipeline import make_pp_mesh
    torch.set_num_threads(1)
    if mode == "train":
        dp, tp = (int(x) for x in (extra or (1, 2)))
        res = train_run(make_mesh(dp, tp, "cpu"))
    else:
        res = pipeline_run(make_pp_mesh(int(extra[0]), "cpu"))
    _save(os.path.join(outdir, "one.npz"), res)
    return 0


# -- serving across processes (tests/test_torch_dp_procs.py) -----------------

def dp_run(model, dp: int, tp: int, session: str) -> dict:
    """The same drive in every process of a dp x tp mesh and in the
    one-process reference, on Engine(n_slots=2 * dp) (a llama or a mamba
    model): over P processes make_mesh(3, P), whose blocks of 3 ranks
    split its dp groups, refused ("uneven": its message); the prefill logits of the last slot (the last dp
    group) and 12 greedy generate_fast tokens there; slot 0 (group 0)
    copied to the first slot of the last group by seq_cp ("copied": this
    process's rows of it afterwards, positions or the recurrent state's
    sum, one a local rank) and a decode from the copy ("cp"); slot 0 moved
    to the last slot by move_slot and a decode there ("mv"); the state
    saved to `session`, loaded into a fresh engine, and 4 greedy steps from
    the last slot in both ("next_loaded", "next_kept"); a load of a file
    that is not there, with missing_ok, gives None first."""
    import numpy as np
    import torch

    from tpulamm_torch.parallel.distributed import world
    from tpulamm_torch.parallel.mesh import make_mesh
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.kvcache import KVCache
    from tpulamm_torch.runtime.session import load_session, save_session
    res = {"uneven": ""}
    if world() is not None:
        try:
            make_mesh(3, world()[1], "cpu")
        except ValueError as e:
            res["uneven"] = str(e)

    def engine():
        return Engine(model, n_ctx=64, n_slots=2 * dp, tp=tp, dp=dp,
                      compute_dtype="float32", kv_dtype=torch.float32,
                      device="cpu")
    eng = engine()
    last, dst = eng.n_slots - 1, eng.n_slots - 2
    res["mesh"] = eng.mesh.describe()
    res["logits"] = eng.prefill(last, PROMPT, logits_all=True)
    res["tokens"] = eng.generate_fast(PROMPT, n_predict=12,
                                      stop_on_eos=False, slot=last)[0]
    for s in range(eng.n_slots):
        eng.reset_slot(s)
    eng.prefill(0, PROMPT)
    eng.seq_cp(0, dst)
    res["copied"] = [c.pos[r].tolist() if isinstance(c, KVCache)
                     else [float(c.conv[:, r].abs().sum())]
                     for c, r in eng.cache.rows(dst)]
    res["cp"] = eng.decode_one(dst, 7)
    eng.move_slot(0, last)
    res["mv"] = eng.decode_one(last, 7)
    save_session(session, eng, tokens=PROMPT)
    fresh = engine()
    assert load_session("absent.npz", fresh, missing_ok=True) is None
    assert load_session(session, fresh) == PROMPT
    for key, e in (("next_loaded", fresh), ("next_kept", eng)):
        tok, out = 11, []
        for _ in range(4):
            tok = int(np.argmax(e.decode_one(last, tok)))
            out.append(tok)
        res[key] = out
    return res


def dp(port, pid, nproc, n_dp, n_tp, model, outdir) -> int:
    import numpy as np
    import torch
    torch.set_num_threads(1)
    tag = "one" if int(nproc) == 1 else pid
    session = os.path.join(outdir, "session_one.npz")
    if int(nproc) > 1:
        from tpulamm_torch.parallel.distributed import init_distributed
        init_distributed(coordinator=f"127.0.0.1:{port}",
                         num_processes=int(nproc), process_id=int(pid),
                         ranks=int(n_dp) * int(n_tp))
        # a working directory of its own for each process, as on hosts
        # that share no disk: the session file is where process 0 runs
        os.makedirs(os.path.join(outdir, f"p{pid}"))
        os.chdir(os.path.join(outdir, f"p{pid}"))
        session = "session.npz"
    res = dp_run(model, int(n_dp), int(n_tp), session)
    np.savez(os.path.join(outdir, f"dp{tag}.npz"),
             **{k: np.asarray(v) for k, v in res.items()
                if k != "copied"},
             copied=np.asarray(json.dumps(res["copied"])))
    return 0


def _free_port() -> int:
    """A free TCP port on localhost (for the tests that start workers)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_all(cmds: list, timeout: float = 240) -> None:
    """Start this module once for each argument list in `cmds`, all
    together, and wait for every one (killed after `timeout` s); raises
    with the error output of any that failed."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *c],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for c in cmds]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=timeout)[1])
        except subprocess.TimeoutExpired:
            p.kill()
            errs.append(p.communicate()[1])
    for c, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"{c[0]} returned {p.returncode}: "
                               + err.decode()[-3000:])


def run_training(mode: str, outdir, *extra, nproc: int = 2) -> list:
    """Start the one-process reference and the nproc processes of `mode`
    ("train" or "pipeline") together -> their npz results (one, proc0,
    proc1, ...). For the tests, which import this module."""
    import numpy as np
    port = str(_free_port())
    run_all([["one", mode, str(outdir), *extra]] + [
        [mode, port, str(pid), str(nproc), str(outdir), *extra]
        for pid in range(nproc)])
    return [np.load(os.path.join(outdir, f"{n}.npz"))
            for n in ["one"] + [f"proc{i}" for i in range(nproc)]]


def run_dp(model: str, n_dp: int, n_tp: int, nproc: int, outdir) -> list:
    """dp_run in nproc processes and in the one-process reference, all
    started together -> their npz results (one, proc0, ...)."""
    import numpy as np
    port = str(_free_port())
    args = [str(n_dp), str(n_tp), model, str(outdir)]
    run_all([["dp", "0", "0", "1", *args]] + [
        ["dp", port, str(pid), str(nproc), *args] for pid in range(nproc)])
    return [np.load(os.path.join(outdir, f"dp{n}.npz"))
            for n in ["one"] + list(range(nproc))]


if __name__ == "__main__":
    mode, *rest = sys.argv[1:]
    sys.exit({"engine": engine, "server": server, "train": train_tp,
              "pipeline": pipeline, "one": one, "dp": dp}[mode](*rest))
