"""Draft-TREE speculative decoding on the device (counterpart of
tpulamm.runtime.spec_tree; speculative.cpp n_seq_dft / p_split parity).

While drafting, a branch whose draft distribution has a strong runner-up
(p > p_split) SPLITS: the top-1 token continues the branch and each
runner-up (up to n_seq_dft branches in all) forks a new one; the target
scores the whole token TREE in one forward and the verify walk follows
the target's choices down the tree.

As in the JAX package, one engine slot a model: tree tokens go to
node-indexed cells and tree attention is the packed segment ranges of
the cache (models/transformer.py's segment mask). Branch ids form a
laminar family: a node's cell is tagged with its branch pool [lo, hi], a
query carries its pool's lo, and lo <= qid <= hi with the causal test is
exactly ancestor visibility. A fork takes the top id of its parent's
pool.

The JAX package runs the whole cycle in one lax.while_loop and the tree
growth in an inner one. Here a cycle is one captured CUDA graph
(runtime.speculative's CycleBuffers and run_block): the tree grows over a
fixed n_draft iterations, each masked by the JAX loop's condition (an
iteration past it drafts nothing and writes only the trash cell); every
node index is clamped into the node arrays, where a JAX scatter would
drop an update out of bounds (only a masked write can reach there).
After each verify the accepted path's K / V cells are gathered into
positional cells in place, on the buffers the graphs read, and the
window's positions are rewritten so dead branch cells read -1 and its
segments 0 (`_consolidate`).

Greedy tree speculation is output-invariant: the emitted tokens equal
plain greedy decoding of the target.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpulamm_torch.models.llama import forward
from tpulamm_torch.runtime.speculative import (CycleBuffers, SpecStats,
                                               _finish_fast, _max_steps,
                                               _sample_rows, _stage1,
                                               _tokens, run_block)


def _pack(lo, hi):
    return lo | (hi << 16)


def _set(t: torch.Tensor, i: torch.Tensor, cond, val) -> None:
    """t[i] = val where cond, in place; i clamped into t (a masked write
    past the end changes nothing)."""
    ic = torch.clamp(i, max=t.shape[0] - 1).view(1).long()
    old = t.index_select(0, ic)
    t.index_copy_(0, ic, torch.where(cond, val, old).view(1).to(t.dtype))


def _consolidate(cache, startb: torch.Tensor, path_cells: torch.Tensor,
                 n_acc: torch.Tensor, pos0: torch.Tensor, window: int,
                 run: torch.Tensor) -> None:
    """Gather the accepted path's cells of slot 0 into the positional
    cells startb .. startb + window - 1 and kill the rest of the window
    (position -1, segment 0), in place; nothing where `run` is false."""
    S = cache.pos.shape[1]
    j = torch.arange(window, device=startb.device)
    win = torch.clamp(startb.long() + j, max=S - 1)
    path = path_cells.long()
    for bufs in (cache.k, cache.v, cache.ks, cache.vs):
        for buf in bufs or ():
            row = buf[0]                               # (H, S, D) / (H, S)
            sel = row.index_select(1, path)
            row.index_copy_(1, win, torch.where(run, sel,
                                                row.index_select(1, win)))
    newpos = torch.where(j <= n_acc, pos0 + j, -1).to(torch.int32)
    prow, srow = cache.pos[0], cache.seg[0]
    prow.index_copy_(0, win, torch.where(run, newpos,
                                         prow.index_select(0, win)))
    srow.index_copy_(0, win, torch.where(run, 0, srow.index_select(0, win)))


def tree_cycle_body(target, draft, bufs: CycleBuffers, n_draft: int,
                    n_seq: int, p_split: float, span_t, span_d,
                    greedy: bool, top_k: int, gen):
    """The cycle of `_build_tree_scan`: grow the tree with the draft, one
    (1, CAP) segmented target forward, the accept walk, the consolidation
    of both caches, then CycleBuffers.finish."""
    K, B = n_draft, n_seq
    F = min(B, 4)                 # top-1 + up to F-1 forks per node a step
    CAP = 1 + K + B               # root + budget + same-step overshoot
    dev = target.device
    n_ctx = min(target.n_ctx, draft.n_ctx)
    i64 = torch.int64
    nid = torch.arange(CAP, device=dev)
    bid = torch.arange(B, device=dev)

    def draft_tree(run, cur, pos0):
        tok = torch.cat([cur.to(i64), torch.zeros(CAP - 1, dtype=i64,
                                                  device=dev)])
        par = torch.full((CAP,), -1, dtype=i64, device=dev)
        dep = torch.zeros(CAP, dtype=i64, device=dev)
        # (no item set from a host scalar: a capture refuses the copy)
        seg = torch.where(nid == 0, _pack(1, B), 0)
        tips_node = torch.zeros(B, dtype=i64, device=dev)
        tips_lo = torch.where(bid == 0, 1, 0)
        tips_hi = torch.where(bid == 0, B, 0)
        tips_act = torch.cat([run.view(1), torch.zeros(
            B - 1, dtype=torch.bool, device=dev)])
        n_nodes = torch.ones((), dtype=i64, device=dev)
        n_seq_cur = torch.ones((), dtype=i64, device=dev)
        for depth in range(K):
            # the JAX loop's condition; once false it stays false, and
            # every update below is conditioned on a branch being active
            go = tips_act.any() & (n_nodes - 1 < K)
            act_f = tips_act & go
            toks = tok.index_select(0, tips_node)
            poss = torch.where(act_f, pos0 + depth, -1)
            cells = torch.where(act_f, pos0 + tips_node, draft.n_ctx)
            qsegs = torch.where(act_f, seg.index_select(0, tips_node), 0)
            lg, _ = forward(draft.params, draft.cfg, toks[None], poss[None],
                            draft.cache, 0, cells[None], kv_span=span_d,
                            t_bucket=B, segs=qsegs[None])
            probs = torch.softmax(lg[0], dim=-1)                   # (B, Vd)
            pv, pi = torch.topk(probs, F, dim=-1)
            # the tips as the forward saw them: a fork made earlier in
            # this pass was not in it, so it is extended only next pass
            tips0, lo0, hi0 = tips_node.clone(), tips_lo.clone(), \
                tips_hi.clone()
            for b in range(B):
                act = act_f[b]
                lo_b, hi_b = lo0[b], hi0[b]
                # fork decisions first: the continuation's range must
                # already exclude the forked ids
                forks = []
                n_forks = torch.zeros((), dtype=i64, device=dev)
                for f in range(1, F):
                    ok = (act & (n_nodes - 1 + 1 + n_forks < K)
                          & (pv[b, f] > p_split)
                          & (n_seq_cur + n_forks < B)
                          & (hi_b - n_forks > lo_b))
                    forks.append(ok)
                    n_forks = n_forks + ok
                # continuation (the reference's sa[0] = s, token cur_p[0])
                can = act & (n_nodes - 1 < K)
                idx = n_nodes
                _set(tok, idx, can, pi[b, 0])
                _set(par, idx, can, tips0[b])
                _set(dep, idx, can, torch.full((), depth + 1, device=dev))
                _set(seg, idx, can, _pack(lo_b, hi_b - n_forks))
                _set(tips_node, torch.full((), b, device=dev), can, idx)
                _set(tips_act, torch.full((), b, device=dev), act, can)
                n_nodes = n_nodes + can
                # fork nodes take ids from the top of the pool
                taken = torch.zeros((), dtype=i64, device=dev)
                for f in range(1, F):
                    ok = forks[f - 1]
                    fid = hi_b - taken
                    sidx = n_nodes
                    _set(tok, sidx, ok, pi[b, f])
                    _set(par, sidx, ok, tips0[b])
                    _set(dep, sidx, ok, torch.full((), depth + 1,
                                                   device=dev))
                    _set(seg, sidx, ok, _pack(fid, fid))
                    tslot = n_seq_cur
                    _set(tips_node, tslot, ok, sidx)
                    _set(tips_lo, tslot, ok, fid)
                    _set(tips_hi, tslot, ok, fid)
                    _set(tips_act, tslot, ok, ok)
                    n_nodes = n_nodes + ok
                    n_seq_cur = n_seq_cur + ok
                    taken = taken + ok
                _set(tips_hi, torch.full((), b, device=dev), act,
                     hi_b - taken)
        return tok, par, dep, seg, n_nodes

    def body():
        run = bufs.act.bool()[0]
        pos = bufs.pos.to(i64)[0]
        startb = pos                  # consolidated caches: cell == pos
        ntok, npar, ndep, nseg, n_nodes = draft_tree(run, bufs.tok, pos)

        # the target scores the whole tree in one forward
        valid = nid < n_nodes
        live = valid & run
        poss = torch.where(live, pos + ndep, -1)
        cells = torch.where(live, startb + nid, target.n_ctx)
        logits, _ = forward(target.params, target.cfg, ntok[None],
                            poss[None], target.cache, 0, cells[None],
                            kv_span=span_t, t_bucket=CAP,
                            segs=torch.where(live, nseg, 0)[None])
        lg = logits[0]                                        # (CAP, V)
        if greedy:
            tgt = torch.argmax(lg, dim=-1)
        else:
            tgt = _sample_rows(lg, bufs.temp.expand(CAP), top_k, gen)

        # the accept walk: follow the target's choices down the tree
        acc = torch.zeros((), dtype=i64, device=dev)
        n_acc = torch.zeros((), dtype=i64, device=dev)
        walking = torch.ones((), dtype=torch.bool, device=dev)
        path = torch.zeros(CAP, dtype=i64, device=dev)
        row = torch.full((K + 1,), -1, dtype=i64, device=dev)
        for step in range(K):
            want = tgt.index_select(0, acc.view(1))[0]
            match = valid & (npar == acc) & (ntok == want) & walking
            found = match.any()
            child = torch.argmax(match.to(torch.int32))
            path[step + 1] = torch.where(found, child, 0)
            row[step] = torch.where(found, want, row[step])
            acc = torch.where(found, child, acc)
            n_acc = n_acc + found
            walking = walking & found
        correction = tgt.index_select(0, acc.view(1))[0]
        row.index_copy_(0, n_acc.view(1), correction.view(1))
        ridx = torch.arange(K + 1, device=dev)
        hit_eos = ((ridx <= n_acc) & (row == bufs.eos[0])).any()

        # consolidate both caches onto the accepted path
        path_cells = startb + path
        for eng in (target, draft):
            _consolidate(eng.cache, startb, path_cells, n_acc, pos, CAP,
                         run)
        bufs.finish(row[None], n_acc.view(1), correction.view(1),
                    hit_eos.view(1), CAP, n_ctx, drafted=n_nodes - 1)
    return body


def generate_speculative_tree(target, draft, prompt, *,
                              n_predict: int = 128, n_draft: int = 8,
                              n_seq_dft: int = 4, p_split: float = 0.1,
                              temp: float = 0.0, top_k: int = 40,
                              seed: int = 0, stop_on_eos: bool = True):
    """Draft-tree speculative decoding on the device (speculative.cpp
    n_seq_dft / p_split parity). Greedy (temp <= 0) emits exactly the
    tokens plain greedy decoding would. Returns (token_ids, text,
    SpecStats)."""
    for eng, name in ((target, "target"), (draft, "draft")):
        if (eng.mega is not None or eng.n_slots != 1 or eng.recurrent
                or eng.mesh is not None):
            raise ValueError(
                f"{name} engine must be single-slot, unmeshed, "
                "non-recurrent, without the megakernel, for on-device tree "
                "speculation")
    if n_seq_dft < 2:
        raise ValueError("n_seq_dft must be >= 2 (use the chain path "
                         "generate_speculative_fast for single-branch)")
    if n_seq_dft > 0xFFFF - 1:
        raise ValueError("n_seq_dft too large for packed segment ranges")
    tokens = _tokens(target, prompt)
    target.reset_slot(0)
    draft.reset_slot(0)
    logits = target.prefill(0, tokens)
    draft.prefill(0, tokens)
    t0 = time.perf_counter()
    first = int(np.argmax(logits))
    eos = target._eos()
    greedy = temp <= 0.0
    CAP = 1 + n_draft + n_seq_dft
    max_steps = _max_steps(target, n_predict)
    stats = SpecStats()
    out = [first]
    cur = first
    start0 = int(target.n_past[0])
    n_ctx = min(target.n_ctx, draft.n_ctx)
    while len(out) < n_predict and not (stop_on_eos and eos in out):
        startb = int(target.n_past[0])
        budget = n_predict - len(out) + 2 * CAP
        span_t = target._kv_span(budget)
        span_d = draft._kv_span(budget)
        key = ("tree", id(draft), n_draft, n_seq_dft, p_split, max_steps,
               top_k if not greedy else 0, greedy, span_t, span_d)

        def make():
            bufs = CycleBuffers(1, n_draft + 1, max_steps, target.device)
            gen = None if greedy else target._gen
            return bufs, tree_cycle_body(target, draft, bufs, n_draft,
                                         n_seq_dft, p_split, span_t, span_d,
                                         greedy, top_k, gen), gen
        g = target.graphs.get(key, make)
        _stage1(g.bufs, cur, startb, CAP, n_ctx, n_predict - len(out),
                eos if stop_on_eos else -1, max(temp, 0.0))
        if not greedy:
            target._gen.manual_seed(seed + len(out))
        st = run_block(g, n_draft, n_predict - len(out))
        n_steps = st["i"]
        target.timings.n_step += n_steps
        if n_steps == 0:
            break                                      # context full
        pos = int(st["pos"][0])
        stats.n_target_steps += n_steps
        stats.n_drafted += int(st["drafted"][:n_steps].sum())
        stats.n_accepted += int(st["accs"][:n_steps, 0].sum())
        for eng in (target, draft):
            eng.n_past[0] = pos
            eng.cell_pos[0, startb:pos] = np.arange(startb, pos)
        out.extend(int(t) for r in st["rows"][:n_steps, 0] for t in r
                   if t >= 0)
        cur = out[-1]
        if pos + CAP + 1 > n_ctx:
            break                                      # context full
    out, text = _finish_fast(target, 0, out[:n_predict], start0,
                             stop_on_eos, eos, t0, draft)
    return out, text, stats
