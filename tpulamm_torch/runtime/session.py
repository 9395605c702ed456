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
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tpulamm_torch.runtime.kvcache import KVCache

MAGIC = "tpulamm-session-v2"   # v2: KV buffers are head-major (B, H, S, D)


def _np_dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _stack(bufs: list) -> np.ndarray:
    if bufs[0].dtype == torch.bfloat16:
        return np.stack([x.view(torch.int16).cpu().numpy().view(np.uint16)
                         for x in bufs])
    return np.stack([x.cpu().numpy() for x in bufs])


def save_session(path: str, engine, tokens: list[int] | None = None) -> None:
    cache = engine.cache
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
        st = engine.cache
        if (not engine.recurrent or z["conv"].shape != tuple(st.conv.shape)
                or z["ssm"].shape != tuple(st.ssm.shape)):
            raise ValueError(f"{path}: a recurrent state of conv "
                             f"{z['conv'].shape}, ssm {z['ssm'].shape} does "
                             "not fit this engine")
        # in place: the captured step graphs read these buffers
        st.conv.copy_(torch.from_numpy(z["conv"]))
        st.ssm.copy_(torch.from_numpy(z["ssm"]))
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
    old = engine.cache
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
