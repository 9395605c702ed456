"""Multi-host serving transport: one HTTP frontend, N SPMD workers
(counterpart of tpulamm.server.multihost; host Python, copied with one
repair, below).

The reference's multi-process slot is `ggml-mpi.c` (layer-pipeline over
MPI, dead at b2430 -- SURVEY 5.8); the north star instead asks for
multi-host SERVING. The design (one host program on every process):

- Every process builds the SAME Engine over the GLOBAL mesh
  (parallel.distributed: each process its block of the ranks), exactly
  like cli.main's multi-process path.
- Process 0 runs the full HTTP server + scheduler. Its engine is wrapped
  in `MirroredEngine`: every state-mutating / device-stepping method call
  is serialized (method name + args -- token ids and slot maps, a few
  hundred bytes) to all workers over a TCP side channel BEFORE executing
  locally, under one lock, so the frame stream is exactly process 0's
  execution order.
- Worker processes run `worker_loop`: apply each received call to their
  local Engine verbatim. Each step inside those methods is the meeting
  point -- the collectives over the global mesh (torch.distributed)
  require every process to issue the identical computation, which the
  mirrored call stream guarantees (host-side mirrors stay bit-identical because
  Engine methods are deterministic functions of their args + state).
- All host-side DECISIONS (sampling, slot assignment, grammar, stop
  strings, HTTP) live on process 0 only; whatever they decide reaches
  workers inside the next call's args. Workers hold no Sampler, no HTTP.

Request payloads never cross the channel -- only engine calls do -- so the
frontend's scheduler logic (timing-dependent queue pulls) cannot diverge
across hosts.

The scheduler's speculation tiers (prompt-lookup and draft-model blocks)
replicate like everything else: their device cycles live in Engine
methods (`spec_lookup_block`, `spec_lookup_block_multi`,
`spec_draft_block`) listed in MIRRORED.

Failure story (a worker process dying would otherwise block process 0's
next collective FOREVER with no error): workers send a heartbeat frame
back over the broadcast socket every `heartbeat` seconds; a monitor
thread on process 0 declares a worker lost after `dead_after` silent
seconds (or EOF), fires `on_worker_lost` (the server fails in-flight
requests with 503s and refuses new ones), and every subsequent mirrored
call raises WorkerLost instead of issuing a doomed SPMD step.

The repair: the JAX monitor sets the heartbeat deadline (`dead_after`) as
the timeout of the socket that `send` writes with sendall, so a frame that
takes longer than dead_after to send looks like a lost worker. Here the
socket stays blocking in both directions and the monitor waits for each
heartbeat with select on the receive side alone.
"""

from __future__ import annotations

import pickle
import select
import socket
import struct
import threading
import time

# Engine methods whose calls must replicate on every process: anything
# that mutates engine/device state or launches a device step.
MIRRORED = (
    "reset_slot", "prefill", "rollback", "decode_batch",
    "decode_batch_fast", "decode_batch_sampled", "decode_one",
    "seq_cp", "seq_rm", "seq_add", "seq_div", "move_slot", "embed",
    "spec_lookup_block", "spec_lookup_block_multi", "spec_draft_block",
)
_STOP = "__stop__"
_HB = b"\x00hb"                       # worker -> frontend heartbeat frame
# connection handshake: rejects accidental/foreign connections grabbing a
# worker slot. The channel otherwise trusts the cluster network -- the
# same assumption torch.distributed's own (unauthenticated) rendezvous
# makes; do not expose the broadcast port beyond the cluster fabric.
_MAGIC = b"tpulamm-mh1\n"


class WorkerLost(RuntimeError):
    """A mirrored call was refused because a worker is gone: issuing the
    step on the remaining processes would hang in the collective."""


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> bytes | None:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack("<I", hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class CallBroadcaster:
    """Process-0 side: accept n_workers connections, fan frames out, and
    watch the reverse direction for heartbeats (worker-failure
    detection)."""

    def __init__(self, port: int, n_workers: int, host: str = "",
                 timeout: float = 120.0, on_worker_lost=None,
                 dead_after: float = 5.0):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # bind the coordinator interface specifically, not 0.0.0.0
        srv.bind((host or "127.0.0.1", port))
        srv.listen(n_workers)
        srv.settimeout(timeout)
        self.conns = []
        self.on_worker_lost = on_worker_lost
        self.dead_after = dead_after
        self.lost: set[int] = set()
        self._lock = threading.Lock()
        while len(self.conns) < n_workers:
            conn, addr = srv.accept()
            conn.settimeout(timeout)
            hello = conn.recv(len(_MAGIC))
            if hello != _MAGIC:      # not a tpulamm worker: drop, re-wait
                conn.close()
                continue
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.conns.append(conn)
        srv.close()
        self._stopping = False
        for idx, conn in enumerate(self.conns):
            t = threading.Thread(target=self._monitor, args=(idx, conn),
                                 daemon=True)
            t.start()

    def _monitor(self, idx: int, conn: socket.socket) -> None:
        """Reverse-direction watcher: each worker heartbeats every
        dead_after/4 seconds; silence past dead_after (or EOF) = lost. The
        deadline is a select on the receive side: the socket keeps no
        timeout, so a long send is never taken for silence."""
        while True:
            try:
                ready, _, _ = select.select([conn], [], [], self.dead_after)
                frame = _recv_frame(conn) if ready else None
            except (OSError, ValueError):
                frame = None
            if frame == _HB:
                continue
            # EOF, timeout, or unexpected frame => worker gone
            if self._stopping:
                return
            self._declare_lost(idx)
            return

    def _declare_lost(self, idx: int) -> None:
        with self._lock:
            if idx in self.lost:
                return
            self.lost.add(idx)
        cb = self.on_worker_lost
        if cb is not None:
            try:
                cb(idx)
            except Exception:  # noqa: BLE001 -- monitor must not die
                pass

    def send(self, method: str, args: tuple, kwargs: dict) -> None:
        if self.lost:
            raise WorkerLost(f"worker(s) {sorted(self.lost)} lost")
        payload = pickle.dumps((method, args, kwargs),
                               protocol=pickle.HIGHEST_PROTOCOL)
        for idx, c in enumerate(self.conns):
            try:
                _send_frame(c, payload)
            except OSError as e:
                self._declare_lost(idx)
                raise WorkerLost(f"worker {idx} send failed: {e}") from e

    def stop(self) -> None:
        self._stopping = True
        try:
            self.send(_STOP, (), {})
        except (OSError, WorkerLost):
            pass
        for c in self.conns:
            try:
                c.close()
            except OSError:
                pass


class MirroredEngine:
    """Engine proxy for process 0: broadcast-then-execute every mirrored
    method atomically (one lock orders concurrent scheduler/HTTP-thread
    calls); everything else forwards to the wrapped Engine. Once a worker
    is lost, every mirrored call raises WorkerLost -- loud and immediate
    instead of a silent hang in the next collective."""

    def __init__(self, engine, tx: CallBroadcaster):
        object.__setattr__(self, "_eng", engine)
        object.__setattr__(self, "_tx", tx)
        object.__setattr__(self, "_lock", threading.Lock())
        for name in MIRRORED:
            if hasattr(engine, name):
                object.__setattr__(self, name, self._make(name))

    def _make(self, name: str):
        fn = getattr(self._eng, name)

        def call(*args, **kwargs):
            with self._lock:
                self._tx.send(name, args, kwargs)
                return fn(*args, **kwargs)
        return call

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_eng"), name)

    def __setattr__(self, name, value):
        setattr(object.__getattribute__(self, "_eng"), name, value)

    def shutdown_workers(self) -> None:
        self._tx.stop()


def connect_worker(host: str, port: int, attempts: int = 120,
                   delay: float = 0.5) -> socket.socket:
    """Worker side: connect to process 0's broadcaster (with retry -- the
    frontend may still be loading weights)."""
    last = None
    for _ in range(attempts):
        try:
            s = socket.create_connection((host, port), timeout=10)
            s.sendall(_MAGIC)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(None)
            return s
        except OSError as e:
            last = e
            time.sleep(delay)
    raise ConnectionError(f"worker could not reach {host}:{port}: {last}")


def worker_loop(engine, sock: socket.socket,
                heartbeat: float = 1.25) -> None:
    """Apply process 0's engine-call stream to the local Engine. Returns
    on a stop frame or when the frontend closes the channel (EOF). A
    daemon thread heartbeats back every `heartbeat` seconds so the
    frontend can detect THIS process dying (kernel closes the socket) or
    wedging (heartbeats stop)."""
    import sys

    hb_stop = threading.Event()
    hb_lock = threading.Lock()       # sendall vs sendall interleaving

    def _beat():
        while not hb_stop.wait(heartbeat):
            try:
                with hb_lock:
                    _send_frame(sock, _HB)
            except OSError:
                return

    threading.Thread(target=_beat, daemon=True).start()
    try:
        while True:
            payload = _recv_frame(sock)
            if payload is None:
                return
            method, args, kwargs = pickle.loads(payload)
            if method == _STOP:
                return
            try:
                getattr(engine, method)(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 -- mirror the frontend's
                # fallback contract: some engine calls raise as part of
                # normal scheduling (e.g. decode_batch_fast's
                # n_ctx-overflow pre-validation, which the scheduler
                # catches and routes to the plain path). Those raise
                # identically on process 0 BEFORE any device step, so
                # state stays in lockstep; the worker must survive them
                # exactly like the frontend does.
                print(f"worker: {method} raised {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
    finally:
        hb_stop.set()
