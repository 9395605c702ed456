"""The port's mesh across processes and its multi-host server transport,
on the CPU (gloo).

- two port processes (tests/_torch_mesh_worker.py, 4 tp ranks each, tp 8
  over both): the same logits and tokens in both, bit for bit those of a
  one-process port tp 8 engine, and the JAX tp 8 engine's tokens;
- the two-process server (process 0 serves HTTP and mirrors its engine
  calls, process 1 applies them), as the three cases of
  tests/test_multihost_server.py: concurrent greedy completions equal to a
  one-process tp 8 server's, the lookup tier over the transport, and the
  worker's death answered with 503 within the heartbeat deadline;
- the transport's repair: a send that outlasts the heartbeat deadline no
  longer declares the worker lost (the JAX broadcaster's socket timeout
  does);
- a request whose assignment meets the lost transport (a mirrored call
  raising WorkerLost, or any error once the worker is declared lost) is
  answered 503, never 400, with no further mirrored call (no process
  spawned: a Scheduler over an engine whose calls raise).
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_mesh_worker import _free_port
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm.server import multihost as jmh
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.runtime.sampling import SamplingParams
from tpulamm_torch.server import multihost as tmh
from tpulamm_torch.server.server import (WORKER_LOST, Request, Scheduler,
                                         serve)
from tpulamm_torch.tools.synth import write_llama_gguf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mesh_worker.py")
PROMPT = [1, 17, 42, 5, 99, 7]       # the worker's


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """8 heads over 8 KV heads, F32 (the shape of tests/test_multihost.py,
    at dim 256)."""
    path = str(tmp_path_factory.mktemp("mh") / "m.gguf")
    write_llama_gguf(path, 2, np.random.default_rng(31), dim=256, ffn=512,
                     n_head=8, vocab=512, qtype=GGMLType.F32, std=0.08)
    return path


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _spawn(*args):
    return [subprocess.Popen([sys.executable, WORKER, *args[0], str(pid),
                              *args[1]], env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE) for pid in range(2)]


def _finish(procs, timeout=300):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    return outs


def test_two_process_mesh_engine(model_path, tmp_path):
    procs = _spawn(["engine", str(_free_port())], [model_path, str(tmp_path)])
    outs = _finish(procs)
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    res = [json.load(open(tmp_path / f"proc{i}.json")) for i in range(2)]
    assert res[0]["tokens"] == res[1]["tokens"]
    assert res[0]["logits"] == res[1]["logits"]
    assert res[1]["mesh"] == ("mesh (dp 1, tp 8): ranks 4-7 of 8 on cpu, "
                              "process 1 of 2")
    one = Engine(model_path, n_ctx=64, tp=8, compute_dtype="float32",
                 kv_dtype=torch.float32, device="cpu")
    logits = one.prefill(0, PROMPT, logits_all=True)
    assert np.array_equal(np.asarray(res[0]["logits"]),
                          logits.astype(np.float64))
    toks = one.generate_fast(PROMPT, n_predict=12, stop_on_eos=False)[0]
    assert res[0]["tokens"] == toks
    je = JEngine(model_path, n_ctx=64, tp=8, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    assert je.generate_fast(PROMPT, n_predict=12,
                            stop_on_eos=False)[0] == toks


def _post(base, path, body, timeout=120):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(base, path, timeout=60):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.status, r.read().decode()


def _wait_health(base, procs, deadline=240):
    t0 = time.time()
    while time.time() - t0 < deadline:
        if any(p.poll() is not None for p in procs):
            raise RuntimeError("a server process exited: " + "".join(
                p.communicate()[1].decode()[-2000:] for p in procs))
        try:
            with urllib.request.urlopen(base + "/health", timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.5)
    raise TimeoutError("server did not come up")


def _counter(metrics: str, name: str) -> int:
    return [int(float(ln.split()[-1])) for ln in metrics.splitlines()
            if ln.startswith(name + " ")][0]


@pytest.fixture(scope="module")
def one_process(model_path):
    """The one-process tp 8 server the two-process ones are held to."""
    started = threading.Event()
    threading.Thread(target=serve, args=(model_path,), kwargs=dict(
        host="127.0.0.1", port=0, n_slots=2, n_ctx=128, tp=8,
        lookup_decoding=True, started=started, compute_dtype="float32",
        device="cpu"), daemon=True).start()
    assert started.wait(timeout=300)
    yield f"http://127.0.0.1:{started.httpd.server_port}"
    started.sched.running = False
    started.httpd.shutdown()


def _two_process_server(model_path, opts=""):
    http0 = _free_port()
    procs = _spawn(["server", str(_free_port())],
                   [model_path, str(http0), str(_free_port()), opts])
    base = f"http://127.0.0.1:{http0}"
    _wait_health(base, procs)
    return procs, base


@pytest.mark.parametrize("opts", ["", "lookup"])
def test_two_process_server(model_path, one_process, opts):
    """Concurrent greedy requests over the two-process server (a response
    needs both processes to step the same program), a repeat of the first
    reproducing it, each equal to the one-process tp 8 server's; with
    "lookup" the prompt-lookup tier ran over the transport."""
    procs, base = _two_process_server(model_path, opts)
    reqs = [{"prompt": "the cat sat on the mat. the cat sat on the",
             "n_predict": 16, "temperature": 0.0, "repeat_penalty": 1.0},
            {"prompt": "a mat", "n_predict": 8, "temperature": 0.0}]
    try:
        with ThreadPoolExecutor(2) as ex:
            mh = list(ex.map(lambda r: _post(base, "/completion", r), reqs))
        st, again = _post(base, "/completion", reqs[0])
        assert st == 200 and again["content"] == mh[0][1]["content"]
        metrics = _get(base, "/metrics")[1]
    finally:
        procs[0].terminate()          # the frontend stops the worker first
        outs = _finish(procs, 60)
    assert procs[1].returncode == 0, outs[1][1].decode()[-2000:]
    for (st, obj), r in zip(mh, reqs):
        assert st == 200 and obj["tokens_predicted"] > 0
        assert obj["content"] == _post(one_process, "/completion",
                                       r)[1]["content"]
    if opts == "lookup":
        assert _counter(metrics, "llamacpp:spec_blocks_total") > 0


def test_two_process_server_worker_death(model_path):
    """The worker killed: within the 2 s heartbeat deadline (+ margin) the
    next request is answered 503, and /metrics counts the lost worker."""
    procs, base = _two_process_server(model_path, "hb=2.0")
    try:
        st, _ = _post(base, "/completion", {"prompt": "the cat",
                                            "n_predict": 4,
                                            "temperature": 0.0})
        assert st == 200
        procs[1].kill()
        t0, code = time.time(), None
        while time.time() - t0 < 30 and code is None:
            try:
                _post(base, "/completion", {"prompt": "a mat",
                                            "n_predict": 32,
                                            "temperature": 0.0}, timeout=20)
            except urllib.error.HTTPError as e:
                code = e.code
            except OSError:
                time.sleep(0.5)
        assert code == 503
        assert time.time() - t0 < 2.0 + 10.0
        assert _counter(_get(base, "/metrics")[1],
                        "llamacpp:mh_workers_lost") >= 1
    finally:
        for p in procs:
            p.kill()
        _finish(procs, 30)


@pytest.mark.parametrize("pkg,lost", [(tmh, False), (jmh, True)])
def test_slow_send_is_not_a_lost_worker(pkg, lost):
    """A worker that heartbeats but reads a frame only after 3 s: the
    frame's send outlasts dead_after (1 s). The port's broadcaster keeps
    the worker and the frame arrives whole; the JAX broadcaster, whose
    heartbeat deadline is the timeout of the socket it sends on, declares
    the worker lost."""
    port = _free_port()
    got, done = {}, threading.Event()

    def worker():
        s = pkg.connect_worker("127.0.0.1", port)
        stop = threading.Event()

        def beat():
            while not stop.wait(0.2):
                try:
                    pkg._send_frame(s, pkg._HB)
                except OSError:
                    return
        threading.Thread(target=beat, daemon=True).start()
        time.sleep(3.0)
        got["frame"] = pkg._recv_frame(s)
        done.wait(30)               # open until the broadcaster is read
        stop.set()
        s.close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    tx = pkg.CallBroadcaster(port, 1, dead_after=1.0)
    time.sleep(0.2)                  # the monitor is watching
    big = np.arange(8 << 20, dtype=np.int64)   # 64 MB: more than the buffers
    try:
        tx.send("decode_batch", (big,), {})
        sent = True
    except pkg.WorkerLost:
        sent = False
    was_lost = bool(tx.lost)
    done.set()
    tx.stop()                        # the worker's read ends at EOF
    t.join(timeout=30)
    assert was_lost == lost and sent != lost
    if not lost:
        method, args, _ = pickle.loads(got["frame"])
        assert method == "decode_batch" and np.array_equal(args[0], big)


class _LostEngine:
    """The engine of a server whose worker died: the mirrored call named
    `fails` raises WorkerLost, as MirroredEngine's calls do once the
    transport is lost; with `fails` "prefill" the heartbeat monitor
    declares the worker lost during the prefill (the request already in its
    slot) and the step fails with the collective's own error. Every call
    is recorded."""

    n_ctx, recurrent, tokenizer = 64, False, None
    cfg = SimpleNamespace(vocab_size=32)

    def __init__(self, fails):
        self.fails, self.calls, self.sched = fails, [], None
        self.n_past = np.zeros(2, np.int64)
        self.cell_pos = np.full((2, 64), -1, np.int64)

    def _call(self, name):
        self.calls.append(name)
        if name == self.fails == "prefill":
            self.sched.on_worker_lost(0)
            raise RuntimeError("connection closed by peer")
        if name == self.fails:
            raise tmh.WorkerLost("worker(s) [0] lost")

    def reset_slot(self, slot):
        self._call("reset_slot")

    def embed(self, prompt, slot=0):
        self._call("embed")

    def prefill(self, slot, tokens):
        self._call("prefill")


@pytest.mark.parametrize("kind,fails,calls", [
    ("completion", "reset_slot", ["reset_slot"]),
    ("embedding", "embed", ["embed"]),
    ("completion", "prefill", ["reset_slot", "prefill"])])
def test_assign_answers_a_lost_worker_503(kind, fails, calls):
    eng = _LostEngine(fails)
    sched = Scheduler(eng, 2)
    eng.sched = sched
    req = Request(prompt=[1, 5, 7], params=SamplingParams(), n_predict=4,
                  stream=False, embed=kind == "embedding")
    sched.submit(req)
    sched._assign()
    item = req.out.get_nowait()
    assert item[0] == "error" and item[1] == WORKER_LOST
    assert req.error_status == 503
    assert eng.calls == calls          # the teardown made no mirrored call
    assert all(s.req is None for s in sched.slots)
    assert req.rid not in sched.requests
