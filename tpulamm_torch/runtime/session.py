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
other's file.
"""

from __future__ import annotations

import json

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


def _global(engine):
    """The engine's cache in the global layout: its own unmeshed; a mesh's
    ranks gathered (kv heads concatenated over tp -- across processes
    through the mesh's collectives -- and slots over dp)."""
    cache = engine.cache
    if not isinstance(cache, MeshCache):
        return cache
    comm = engine.mesh.comm
    groups = [cache.groups[d] for d in sorted(cache.groups)]
    first = groups[0][0]
    if not isinstance(first, KVCache):       # recurrent: slots on dp only
        return type(first)(conv=torch.cat([g[0].conv for g in groups], 1),
                           ssm=torch.cat([g[0].ssm for g in groups], 1))

    def heads(parts):
        return torch.cat(parts if comm is None else comm.gather_parts(parts),
                         dim=1)

    def layers(name):
        if getattr(first, name) is None:
            return None
        return [torch.cat([heads([getattr(c, name)[i] for c in g])
                           for g in groups])
                for i in range(len(getattr(first, name)))]
    return KVCache(k=layers("k"), v=layers("v"),
                   pos=torch.cat([g[0].pos for g in groups]),
                   ks=layers("ks"), vs=layers("vs"),
                   seg=torch.cat([g[0].seg for g in groups]))


def _scatter(engine, new) -> None:
    """Copy a global-layout cache into a mesh's rank caches, in place."""
    cache, mesh = engine.cache, engine.mesh
    n = cache.n_per
    for d, group in cache.groups.items():
        rows = slice(d * n, (d + 1) * n)
        for c, t in zip(group, mesh.local_tp):
            if not isinstance(c, KVCache):
                c.conv.copy_(new.conv[:, rows])
                c.ssm.copy_(new.ssm[:, rows])
                continue
            h = c.k[0].shape[1]
            hs = slice(t * h, (t + 1) * h)
            for dst, src in ((c.k, new.k), (c.v, new.v), (c.ks, new.ks),
                             (c.vs, new.vs)):
                for a, b in zip(dst or [], src or []):
                    a.copy_(b[rows, hs])
            c.pos.copy_(new.pos[rows])
            c.seg.copy_(new.seg[rows])


def save_session(path: str, engine, tokens: list[int] | None = None) -> None:
    cache = _global(engine)
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


def load_session(path: str, engine) -> list[int]:
    """Restore engine state in place; returns the saved token history."""
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) == MAGIC + "-recurrent":
        st = _global(engine) if engine.recurrent else None
        if (not engine.recurrent or z["conv"].shape != tuple(st.conv.shape)
                or z["ssm"].shape != tuple(st.ssm.shape)):
            raise ValueError(f"{path}: a recurrent state of conv "
                             f"{z['conv'].shape}, ssm {z['ssm'].shape} does "
                             "not fit this engine")
        new = type(st)(conv=torch.from_numpy(z["conv"]),
                       ssm=torch.from_numpy(z["ssm"]))
        # in place: the captured step graphs read these buffers
        if engine.mesh is not None:
            _scatter(engine, new)
        else:
            st.conv.copy_(new.conv)
            st.ssm.copy_(new.ssm)
        engine.n_past = z["n_past"].copy()
        return [int(t) for t in z["tokens"]]
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
    old = _global(engine)
    if ((new.ks is None) != (old.ks is None)
            or (new.vs is None) != (old.vs is None)
            or new.k[0].dtype != old.k[0].dtype
            or new.v[0].dtype != old.v[0].dtype):
        def desc(c):
            return (f"k={'q8_0' if c.ks is not None else _np_dtype_name(c.k[0].dtype)}, "
                    f"v={'q8_0' if c.vs is not None else _np_dtype_name(c.v[0].dtype)}")
        raise ValueError(
            f"{path}: session KV layout ({desc(new)}) does not match the "
            f"engine cache ({desc(old)}); pass matching -ctk/-ctv")
    if new.k[0].shape != old.k[0].shape or new.pos.shape != old.pos.shape:
        raise ValueError("session/model shape mismatch: "
                         f"K {tuple(new.k[0].shape)} vs engine "
                         f"{tuple(old.k[0].shape)}")
    # copy into the engine's buffers (on engine.device) in place: the
    # captured step graphs read them
    if engine.mesh is not None:
        _scatter(engine, new)
    else:
        for dst, src in ((old.k, new.k), (old.v, new.v), (old.ks, new.ks),
                         (old.vs, new.vs)):
            for d, s_ in zip(dst or [], src or []):
                d.copy_(s_)
        old.pos.copy_(new.pos)
        old.seg.copy_(new.seg)
    engine.n_past = z["n_past"].copy()
    engine.cell_pos = z["cell_pos"].copy()
    engine.ga_i = z["ga_i"].copy()
    return [int(t) for t in z["tokens"]]
