"""Subprocess worker of tests/test_torch_multihost.py (not a test): one
process of a two-process port mesh over gloo on the CPU. It imports the
port only (no JAX).

    engine COORD_PORT PID MODEL OUT_DIR
        the process joins the world (2 processes, 4 tp ranks each), builds
        Engine(tp=8) and writes its prefill logits and greedy tokens to
        OUT_DIR/procPID.json.
    server COORD_PORT PID MODEL HTTP_PORT BCAST_PORT [OPTS]
        the two-process server (tp=8, 2 slots): process 0 serves HTTP and
        mirrors its engine calls, process 1 applies them and exits 0 when
        the channel closes. OPTS: a comma list, "lookup" for
        --lookup-decoding, "hb=SECONDS" for the heartbeat deadline.
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


if __name__ == "__main__":
    mode, *rest = sys.argv[1:]
    sys.exit({"engine": engine, "server": server}[mode](*rest))
