"""Inference-state checkpoint / resume (counterpart of
tpulamm.runtime.session).

Parity with llama_copy_state_data / llama_save_session_file
(llama.cpp:13518-13845): serializes the full KV cache (k/v/pos), per-slot
decode cursors, self-extend state and the token history, so generation can
resume exactly (`main` uses it as a prompt cache with prefix-matching
reuse, main.cpp:600-620).

The file is the JAX package's format, byte layout and names alike, so a
file either package writes loads in the other: a numpy .npz (its entries
stored where the JAX package deflates them; np.load reads both) with the
per-layer (B, H_kv, S, D) K/V stacked to (L, ...), bf16 stored as its
uint16 bits, k_dtype / v_dtype as numpy-style names ("bfloat16", "int8",
"float32"), ks / vs row scales for a q8_0 cache, pos, seg (the packed
segment plane of lookahead and tree speculation), n_past, cell_pos,
ga_i, tokens and meta. A recurrent (mamba) engine's file has the magic
MAGIC + "-recurrent" and its state's conv and ssm (L, n_slots, ...) f32
arrays with n_past and tokens, as the JAX package writes it.

A meshed engine writes and reads the same file: its per-rank caches are
gathered into the global layout (kv heads over tp, slots over dp) before
the write and cut back into the ranks after the read, as the JAX package
device_gets its sharded arrays; either package, meshed or not, loads the
other's file. Across processes, process 0 alone touches the file: the
other processes send it their ranks' parts for a save (over the dp
exchange, then dp group 0's tp group), and it reads a load and sends each
process its part and the host state, so the file need only be where
process 0 runs.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tpulamm_torch.runtime.kvcache import KVCache, MeshCache

MAGIC = "tpulamm-session-v2"   # v2: KV buffers are head-major (B, H, S, D)


def _np_dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _stack(bufs: list) -> np.ndarray:
    if bufs[0].dtype == torch.bfloat16:
        return np.stack([x.view(torch.int16).cpu().numpy().view(np.uint16)
                         for x in bufs])
    return np.stack([x.cpu().numpy() for x in bufs])


def _fields(c) -> list:
    """The buffers of one cache (a rank's or the global one) as (key,
    tensor, slot dim, kv-head dim or None): a KVCache's K, V and q8_0
    scales layer by layer, its positions and segments (one copy over tp);
    a recurrent state's conv and ssm (slots on dp only)."""
    if not isinstance(c, KVCache):
        return [("conv", c.conv, 1, None), ("ssm", c.ssm, 1, None)]
    return [((n, i), x, 0, 1) for n in ("k", "v", "ks", "vs")
            for i, x in enumerate(getattr(c, n) or ())] + [
        ("pos", c.pos, 0, None), ("seg", c.seg, 0, None)]


def _cache_of(like, vals: dict):
    """A cache of `like`'s type and buffers from _fields' key -> tensor."""
    if not isinstance(like, KVCache):
        return type(like)(conv=vals["conv"], ssm=vals["ssm"])

    def layers(n):
        bufs = getattr(like, n)
        return None if bufs is None else [vals[(n, i)]
                                          for i in range(len(bufs))]
    return KVCache(k=layers("k"), v=layers("v"), pos=vals["pos"],
                   ks=layers("ks"), vs=layers("vs"), seg=vals["seg"])


def _first_rank(engine):
    """A rank's cache (the engine's own unmeshed): its layout."""
    cache = engine.cache
    if not isinstance(cache, MeshCache):
        return cache
    return cache.groups[min(cache.groups)][0]


def _global_shape(engine, x, sdim, hdim) -> tuple:
    """The global shape of a rank's buffer x (slots over dp, heads over
    tp)."""
    if engine.mesh is None:
        return tuple(x.shape)
    s = list(x.shape)
    s[sdim] *= engine.mesh.dp
    if hdim is not None:
        s[hdim] *= engine.mesh.tp
    return tuple(s)


def _global(engine):
    """The engine's cache in the global layout: its own unmeshed; a mesh's
    ranks gathered (kv heads concatenated over tp, slots over dp), across
    processes on process 0 only (None on the others): the dp exchange
    brings dp group 0's processes every group's slots, then dp group 0's
    tp group brings process 0 every head."""
    cache = engine.cache
    if not isinstance(cache, MeshCache):
        return cache
    mesh = engine.mesh
    groups = [cache.groups[d] for d in sorted(cache.groups)]
    vals = {}
    for j, (key, _, sdim, hdim) in enumerate(_fields(groups[0][0])):
        x = torch.cat([
            _fields(g[0])[j][1] if hdim is None else
            torch.cat([_fields(c)[j][1] for c in g], hdim) for g in groups],
            sdim)
        x = _to_first(x, mesh.dp_comm, sdim)
        if x is not None and hdim is not None:
            x = _to_first(x, mesh.comm, hdim)
        vals[key] = x
    return (_cache_of(groups[0][0], vals) if mesh.process_index == 0
            else None)


def _to_first(x, comm, dim):
    """x from every member of comm concatenated on dim in member order, on
    the first member, None on the others (x itself without comm)."""
    if comm is None:
        return x
    parts = comm.gather_first(x)
    return None if parts is None else torch.cat(parts, dim)


def _from_first(x, comm, dim, shape, dtype):
    """The first member's x cut on dim into equal parts, part i to member i
    (dim None: the whole of x to every member); x is None off the first
    member, and the part has `shape` (x itself without comm)."""
    if comm is None:
        return x
    parts = None if x is None else (
        [x] * comm.size if dim is None
        else list(torch.chunk(x, comm.size, dim)))
    return comm.scatter_first(parts, shape, dtype)


def _scatter(engine, new) -> None:
    """Copy a global-layout cache (on process 0; None on the others) into
    a mesh's rank caches, in place: the inverse of _global's gathers."""
    cache, mesh = engine.cache, engine.mesh
    groups = [cache.groups[d] for d in sorted(cache.groups)]
    n = cache.n_per
    dp_first = mesh.dp_comm is None or mesh.dp_comm.rank == 0
    new_fields = None if new is None else _fields(new)
    for j, (_, x0, sdim, hdim) in enumerate(_fields(groups[0][0])):
        x = None if new_fields is None else new_fields[j][1]
        local = list(x0.shape)
        local[sdim] *= len(groups)
        if hdim is not None:
            local[hdim] *= len(mesh.local_tp)
        if dp_first:           # dp group 0's processes: every slot
            slots = list(local)
            if mesh.dp_comm is not None:
                slots[sdim] *= mesh.dp_comm.size
            x = _from_first(x, mesh.comm, hdim, slots, x0.dtype)
        x = _from_first(x, mesh.dp_comm, sdim, local, x0.dtype)
        h = x0.shape[hdim] if hdim is not None else 0
        for gi, g in enumerate(groups):
            rows = x.narrow(sdim, gi * n, n)
            for ti, c in enumerate(g):
                _fields(c)[j][1].copy_(
                    rows if hdim is None else rows.narrow(hdim, ti * h, h))


def save_session(path: str, engine, tokens: list[int] | None = None) -> None:
    """Write the engine's state to `path`. Every process of a mesh calls
    it; process 0 writes, and every process returns once the file is
    written."""
    cache = _global(engine)
    mesh = engine.mesh
    if mesh is None or mesh.process_index == 0:
        _write(path, engine, cache, tokens)
    if mesh is not None and mesh.process_count > 1:
        import torch.distributed as dist
        dist.barrier()


def _write(path: str, engine, cache, tokens) -> None:
    toks = np.asarray(tokens if tokens is not None else [], np.int32)
    if engine.recurrent:
        with open(path, "wb") as fh:
            np.savez(fh, magic=np.array(MAGIC + "-recurrent"),
                     conv=cache.conv.cpu().numpy(),
                     ssm=cache.ssm.cpu().numpy(), n_past=engine.n_past,
                     tokens=toks)
        return
    extra = {}
    if cache.ks is not None:
        extra["ks"] = _stack(cache.ks)
    if cache.vs is not None:
        extra["vs"] = _stack(cache.vs)
    pos = cache.pos.cpu().numpy()
    # write through a handle: np.savez on a bare path appends ".npz",
    # breaking user-chosen session filenames (--prompt-cache foo.bin).
    # The entries are stored, not deflated as the JAX package writes them:
    # deflate is slow on bf16 K/V and shrinks it little
    with open(path, "wb") as fh:
        np.savez(
            fh,
            magic=np.array(MAGIC),
            k=_stack(cache.k),
            k_dtype=np.array(_np_dtype_name(cache.k[0].dtype)),
            v_dtype=np.array(_np_dtype_name(cache.v[0].dtype)),
            v=_stack(cache.v),
            **extra,
            pos=pos,
            seg=cache.seg.cpu().numpy(),
            n_past=engine.n_past,
            cell_pos=engine.cell_pos,
            ga_i=engine.ga_i,
            tokens=toks,
            meta=np.array(json.dumps({
                "n_ctx": engine.n_ctx, "n_slots": engine.n_slots,
                "arch": engine.cfg.arch, "dim": engine.cfg.dim,
                "n_layers": engine.cfg.n_layers,
            })),
        )


def _split(st: np.ndarray, dtype_name: str) -> list:
    """(L, ...) host array -> L host tensors (bf16 from its uint16 bits)."""
    st = np.ascontiguousarray(st)
    if dtype_name == "bfloat16":
        t = torch.from_numpy(st.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(st)
    return list(t.unbind(0))


def load_session(path: str, engine, missing_ok: bool = False
                 ) -> list[int] | None:
    """Restore engine state in place; returns the saved token history, or
    None where missing_ok and there is no file at `path`. Every process of
    a mesh calls it; process 0 alone reads the file (and decides whether
    it is there), every process gets its own ranks' part, and an error
    raises in every process."""
    mesh = engine.mesh
    shared = mesh is not None and mesh.process_count > 1
    new, hdr, err = None, {}, None
    if not shared or mesh.process_index == 0:
        try:
            if missing_ok and not os.path.exists(path):
                hdr = {"missing": True}
            else:
                new, hdr = _read(path, engine)
        except Exception as e:
            if not shared:
                raise
            err, hdr = e, {"error": str(e),
                           "value": isinstance(e, ValueError)}
    if shared:
        import torch.distributed as dist
        box = [hdr]
        dist.broadcast_object_list(box, src=0)
        hdr = box[0]
    if err is not None:
        raise err
    if "error" in hdr:
        raise (ValueError if hdr["value"] else RuntimeError)(hdr["error"])
    if hdr.get("missing"):
        return None
    # copy into the engine's buffers (on engine.device) in place: the
    # captured step graphs read them
    if mesh is not None:
        _scatter(engine, new)
    else:
        for (_, dst, _, _), (_, src, _, _) in zip(_fields(engine.cache),
                                                  _fields(new)):
            dst.copy_(src)
    for k in ("n_past", "cell_pos", "ga_i"):
        if k in hdr:
            setattr(engine, k, hdr[k].copy())
    return hdr["tokens"]


def _read(path: str, engine) -> tuple:
    """The file at `path` checked against the engine's cache layout ->
    (its cache in the global layout on the host, its host state: n_past,
    cell_pos and ga_i arrays and the token list)."""
    z = np.load(path, allow_pickle=False)
    like = _first_rank(engine)
    shapes = [_global_shape(engine, x, sd, hd)
              for _, x, sd, hd in _fields(like)]
    if str(z["magic"]) == MAGIC + "-recurrent":
        if (not engine.recurrent or z["conv"].shape != shapes[0]
                or z["ssm"].shape != shapes[1]):
            raise ValueError(f"{path}: a recurrent state of conv "
                             f"{z['conv'].shape}, ssm {z['ssm'].shape} does "
                             "not fit this engine")
        new = type(like)(conv=torch.from_numpy(z["conv"]),
                         ssm=torch.from_numpy(z["ssm"]))
        return new, {"n_past": z["n_past"].copy(),
                     "tokens": [int(t) for t in z["tokens"]]}
    if engine.recurrent:
        raise ValueError(f"{path}: a KV-cache state does not fit a "
                         "recurrent engine")
    if str(z["magic"]) != MAGIC:
        raise ValueError(f"{path}: not a tpulamm session file")
    meta = json.loads(str(z["meta"]))
    if meta["n_ctx"] != engine.n_ctx or meta["n_slots"] != engine.n_slots or \
            meta["n_layers"] != engine.cfg.n_layers or \
            meta["dim"] != engine.cfg.dim:
        raise ValueError("session/model shape mismatch: "
                         f"{meta} vs engine n_ctx={engine.n_ctx}")
    kd = str(z["k_dtype"])
    vd = str(z["v_dtype"]) if "v_dtype" in z.files else kd
    new = KVCache(
        k=_split(z["k"], kd), v=_split(z["v"], vd),
        pos=torch.from_numpy(np.ascontiguousarray(z["pos"])),
        ks=_split(z["ks"], "float32") if "ks" in z.files else None,
        vs=_split(z["vs"], "float32") if "vs" in z.files else None,
        seg=(torch.from_numpy(np.ascontiguousarray(z["seg"]))
             if "seg" in z.files else None))
    # the step graphs were captured on the engine's cache storage and
    # layout (-ctk / -ctv): a swapped layout is an error
    if ((new.ks is None) != (like.ks is None)
            or (new.vs is None) != (like.vs is None)
            or new.k[0].dtype != like.k[0].dtype
            or new.v[0].dtype != like.v[0].dtype):
        def desc(c):
            return (f"k={'q8_0' if c.ks is not None else _np_dtype_name(c.k[0].dtype)}, "
                    f"v={'q8_0' if c.vs is not None else _np_dtype_name(c.v[0].dtype)}")
        raise ValueError(
            f"{path}: session KV layout ({desc(new)}) does not match the "
            f"engine cache ({desc(like)}); pass matching -ctk/-ctv")
    want_k = _global_shape(engine, like.k[0], 0, 1)
    want_pos = _global_shape(engine, like.pos, 0, None)
    if tuple(new.k[0].shape) != want_k or tuple(new.pos.shape) != want_pos:
        raise ValueError("session/model shape mismatch: "
                         f"K {tuple(new.k[0].shape)} vs engine {want_k}")
    return new, {"n_past": z["n_past"].copy(),
                 "cell_pos": z["cell_pos"].copy(),
                 "ga_i": z["ga_i"].copy(),
                 "tokens": [int(t) for t in z["tokens"]]}
