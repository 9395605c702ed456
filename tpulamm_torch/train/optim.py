"""The optimizers of the training path: optax 0.2.6's arithmetic on torch
tensors (the port imports no optax).

- AdamW is optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
  weight_decay)): b1 0.9, b2 0.999, eps 1e-8, eps_root 0, decay on every
  tensor; the schedule joins a linear warmup from 0 with a cosine decay
  and is read at the count BEFORE the step's increment, so step 0 runs at
  lr 0. The clip scales by max_norm / norm only when norm >= max_norm, with
  no epsilon (torch.nn.utils.clip_grad_norm_ adds 1e-6, and
  torch.optim.lr_scheduler counts one step later: neither gives these
  numbers).
- L-BFGS is optax.lbfgs(lr): scale_by_lbfgs (memory 10, the scaled
  identity as first preconditioner), scale(-lr), then
  scale_by_zoom_linesearch(max_linesearch_steps=20, initial_guess_strategy
  ="one") with its defaults (slope_rtol 1e-4, curv_rtol 0.9,
  approx_dec_rtol 1e-6, increase_factor 2, stepsize_precision 1e-5).
  torch.optim.LBFGS is another algorithm (history 100, another search).
  The zoom's lax.while_loop is a host loop here: each trial reads the loss
  and the slope back with one device-to-host copy, and its scalars are
  float32, as the JAX state's are.

A tree is a params dict / list nest; its leaves are taken in JAX's order
(dict keys sorted), so sums over leaves add in the JAX order. update()
works in place: it turns the gradients' buffers into the updates (the
state's moments updated in place too), which apply_updates adds to the
params: at TinyLlama-1.1B shape a step holds params, gradients and two
moments and nothing more.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

F32 = np.float32


def tree_leaves(tree) -> list:
    """The tensors of a dict / list nest in JAX's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(tree, leaves: list):
    """A nest of `tree`'s structure holding `leaves` (in JAX's order). Its
    dicts list their keys sorted, as a JAX pytree rebuilt after a step
    does (the order in which save_lora_gguf writes an adapter's
    tensors)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)
    return build(tree)


def tree_vdot(xs: list, ys: list) -> torch.Tensor:
    """Sum over leaves of <x, y> (an f32 scalar on the leaves' device)."""
    out = None
    for x, y in zip(xs, ys):
        d = torch.dot(x.reshape(-1), y.reshape(-1))
        out = d if out is None else out + d
    return out


def apply_updates(params: list, updates: list) -> None:
    """params += updates, in place (optax.apply_updates)."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)


def schedule(tc, count: int) -> float:
    """optax.join_schedules([linear_schedule(0, lr, warmup),
    cosine_decay_schedule(lr, max(n_steps - warmup, 1))], [warmup]) at
    `count`, rounded to float32."""
    warm = tc.warmup_steps
    if count < warm:
        c = min(max(count, 0), warm)
        frac = F32(1) - F32(c) / F32(warm)
        return float(F32(0.0 - tc.lr) * frac + F32(tc.lr))
    decay = float(max(tc.n_steps - warm, 1))
    c = min(float(count - warm), decay)
    cos = F32(0.5) * (F32(1) + F32(math.cos(F32(math.pi) * F32(c)
                                            / F32(decay))))
    return float(F32(tc.lr) * cos)


class AdamW:
    """clip_by_global_norm(grad_clip) -> adamw(schedule, weight_decay)."""

    b1, b2, eps, eps_root = 0.9, 0.999, 1e-8, 0.0

    def __init__(self, tc):
        self.tc = tc

    def init(self, params: list) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params: list, *, vdot=None,
               **_):
        """vdot: the inner product over the whole tree where the leaves are
        one process's part of it (a mesh's or a pipeline's), default the
        local sum."""
        tc = self.tc
        # clip_by_global_norm: t / norm * max_norm when norm >= max_norm
        norm = torch.sqrt(sum((g * g).sum() for g in grads) if vdot is None
                          else vdot(grads, grads))
        if not float(norm) < tc.grad_clip:
            for g in grads:
                g.div_(norm).mul_(tc.grad_clip)
        b1, b2 = self.b1, self.b2
        count_inc = state["count"] + 1
        bc1 = float(F32(1) - F32(b1) ** F32(count_inc))
        bc2 = float(F32(1) - F32(b2) ** F32(count_inc))
        step = -schedule(tc, state["count"])
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (nu / bc2).add_(self.eps_root).sqrt_().add_(self.eps)
            torch.div(mu, bc1, out=g)
            g.div_(denom)
            g.add_(p, alpha=tc.weight_decay)
            g.mul_(step)
        state["count"] = count_inc
        return grads, state


@dataclass
class _Mem:
    dw: list
    du: list
    rho: torch.Tensor


class LBFGS:
    """scale_by_lbfgs(10, True) -> scale(-lr) -> scale_by_zoom_linesearch
    (max_linesearch_steps=20, initial_guess_strategy="one")."""

    memory_size = 10
    max_steps = 20
    slope_rtol, curv_rtol, approx_dec_rtol = 1e-4, 0.9, 1e-6
    increase_factor, interval_threshold, tol = 2.0, 1e-5, 0.0

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params: list) -> dict:
        # the memory holds only the differences set so far: an entry
        # optax keeps at zero adds exactly nothing to the products
        return {"count": 0, "params": None, "updates": None,
                "memory": [None] * self.memory_size, "trials": 0}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params: list, *, value,
               grad: list, value_and_grad_fn, vdot=None):
        """value_and_grad_fn(leaves) -> (loss tensor, gradient leaves);
        vdot as AdamW.update's (default tree_vdot)."""
        dot = vdot or tree_vdot
        m = self.memory_size
        count = state["count"]
        mem = state["memory"]
        idx = count % m
        prev = (count - 1) % m
        if count > 0:
            dw = [p - q for p, q in zip(params, state["params"])]
            du = [g - q for g, q in zip(grads, state["updates"])]
            vdu = dot(du, dw)
            rho = torch.where(vdu == 0.0, torch.zeros_like(vdu), 1.0 / vdu)
            mem[prev] = _Mem(dw, du, rho)
            den = dot(du, du)
            scale = torch.where(den > 0.0, vdu / den, torch.ones_like(den))
        else:
            mem[prev] = None                 # optax writes zeros there
            norm = torch.sqrt(dot(grads, grads))
            scale = torch.clamp(1.0 / norm, max=1.0)
        # the two loops of Algorithm 7.4 over the ring: newest entry
        # first, then back from the oldest
        order = [(idx + j) % m for j in range(m)]
        vec = list(grads)
        alphas = {}
        for i in reversed(order):
            e = mem[i]
            if e is None:
                continue
            a = e.rho * dot(e.dw, vec)
            alphas[i] = a
            vec = [v + (-a) * u for v, u in zip(vec, e.du)]
        vec = [scale * v for v in vec]
        for i in order:
            e = mem[i]
            if e is None:
                continue
            b = e.rho * dot(e.du, vec)
            vec = [v + (alphas[i] - b) * w for v, w in zip(vec, e.dw)]
        state["params"] = [p.clone() for p in params]
        state["updates"] = [g.clone() for g in grads]
        state["count"] = count + 1
        # scale(-lr), then the zoom linesearch along that direction
        upd = [F32(-self.lr).item() * v for v in vec]
        stepsize, trials = self._zoom(params, upd, value, grad,
                                      value_and_grad_fn, dot)
        state["trials"] = trials
        return [stepsize * u for u in upd], state

    # -- optax.zoom_linesearch on the host -------------------------------
    # the JAX constants are weakly typed: each Python float rounds to f32
    def _dec_error(self, s, v, slope, v0, slope0):
        dec = v - v0 - F32(self.slope_rtol) * s * slope0
        approx = slope - F32(2 * self.slope_rtol - 1.0) * slope0
        delta = v - v0 - F32(self.approx_dec_rtol) * abs(v0)
        dec = np.maximum(np.minimum(np.maximum(approx, delta), dec), F32(0))
        return F32(np.inf) if np.isnan(dec) else F32(dec)

    def _curv_error(self, slope, slope0):
        c = np.maximum(abs(slope) - F32(self.curv_rtol) * abs(slope0),
                       F32(0))
        return F32(np.inf) if np.isnan(c) else F32(c)

    @staticmethod
    def _cubicmin(a, fa, fpa, b, fb, c, fc):
        with np.errstate(all="ignore"):
            C = fpa
            db, dc = b - a, c - a
            denom = (db * dc) ** 2 * (db - dc)
            d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]], F32)
            rhs = np.array([fb - fa - C * db, fc - fa - C * dc], F32)
            A, B = (d1 @ rhs) / denom
            radical = B * B - F32(3) * A * C
            return F32(a + (-B + np.sqrt(radical)) / (F32(3) * A))

    @staticmethod
    def _quadmin(a, fa, fpa, b, fb):
        with np.errstate(all="ignore"):
            db = b - a
            B = (fb - fa - fpa * db) / (db ** 2)
            return F32(a - fpa / (F32(2) * B))

    def _zoom(self, params, upd, value, grad, vg_fn, dot):
        """The stepsize the zoom linesearch picks along `upd`, and its
        number of trials."""
        def on_line(s):
            step = [p + float(s) * u for p, u in zip(params, upd)]
            v, g = vg_fn(step)
            slope = dot(g, upd)
            vs = torch.stack([v.detach().float(), slope]).cpu().numpy()
            return F32(vs[0]), g, F32(vs[1])

        v0 = F32(float(value))
        slope0 = F32(float(dot(upd, grad)))
        st = dict(stepsize=F32(0), value=v0, slope=slope0, grad=grad,
                  low=F32(0), v_low=v0, s_low=slope0, high=F32(0),
                  v_high=v0, s_high=slope0, cubic=F32(0), v_cubic=v0,
                  safe=F32(0), v_safe=v0, g_safe=grad, dec=F32(np.inf))
        found = done = failed = False
        it = 0
        with np.errstate(all="ignore"):
            while not (done or failed):
                if not found:
                    new = (F32(1.0) if it == 0
                           else F32(self.increase_factor) * st["stepsize"])
                    v, g, s = on_line(new)
                    dec = self._dec_error(new, v, s, v0, slope0)
                    err = np.maximum(dec, self._curv_error(s, slope0))
                    if dec <= self.tol:
                        st.update(safe=new, v_safe=v, g_safe=g)
                    hi_new = (dec > 0) or (v >= st["value"] and it > 0)
                    lo_new = (s >= 0) and not hi_new
                    if lo_new:
                        st.update(low=new, v_low=v, s_low=s,
                                  high=st["stepsize"], v_high=st["value"],
                                  s_high=st["slope"])
                    else:
                        st.update(low=st["stepsize"], v_low=st["value"],
                                  s_low=st["slope"], high=new, v_high=v,
                                  s_high=s)
                    st.update(cubic=st["low"], v_cubic=st["v_low"])
                    found = hi_new or lo_new or err <= self.tol
                    done = err <= self.tol
                    failed = (it + 1 >= self.max_steps) and not done
                    st.update(stepsize=new, value=v, slope=s, grad=g,
                              dec=dec)
                else:
                    low, high = st["low"], st["high"]
                    delta = abs(high - low)
                    left, right = np.minimum(high, low), np.maximum(high, low)
                    mc = self._cubicmin(low, st["v_low"], st["s_low"], high,
                                        st["v_high"], st["cubic"],
                                        st["v_cubic"])
                    use_cubic = (mc > left + F32(0.2) * delta
                                 and mc < right - F32(0.2) * delta)
                    mq = self._quadmin(low, st["v_low"], st["s_low"], high,
                                       st["v_high"])
                    use_quad = (not use_cubic
                                and mq > left + F32(0.1) * delta
                                and mq < right - F32(0.1) * delta)
                    if use_cubic:
                        mid = mc
                    elif use_quad:
                        mid = mq
                    else:
                        mid = F32((low + high) / F32(2))
                    v, g, s = on_line(mid)
                    dec = self._dec_error(mid, v, s, v0, slope0)
                    err = np.maximum(dec, self._curv_error(s, slope0))
                    if dec <= self.tol and v < st["v_safe"]:
                        st.update(safe=mid, v_safe=v, g_safe=g)
                    done = err <= self.tol
                    hi_mid = (dec > 0) or (v >= st["v_low"])
                    hi_low = (s * (high - low) >= 0) and not hi_mid
                    old = (high, st["v_high"], st["s_high"], low,
                           st["v_low"], st["s_low"])
                    if hi_mid:
                        st.update(high=mid, v_high=v, s_high=s)
                    elif hi_low:
                        st.update(high=low, v_high=st["v_low"],
                                  s_high=st["s_low"])
                    if not hi_mid:
                        st.update(low=mid, v_low=v, s_low=s)
                    if hi_mid or hi_low:
                        st.update(cubic=old[0], v_cubic=old[1])
                    else:
                        st.update(cubic=old[3], v_cubic=old[4])
                    failed = ((it + 1 >= self.max_steps
                               or (delta <= self.interval_threshold
                                   and st["safe"] > 0)) and not done)
                    st.update(stepsize=mid, value=v, slope=s, grad=g,
                              dec=dec)
                it += 1
                if failed and (st["safe"] > 0 or np.isinf(st["dec"])):
                    # _try_safe_step: the best point of sufficient decrease
                    st.update(stepsize=st["safe"], value=st["v_safe"],
                              grad=st["g_safe"])
        return float(st["stepsize"]), it
