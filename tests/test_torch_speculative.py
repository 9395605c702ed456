"""Port parity for speculative decoding (runtime/speculative.py, the
engine's serving hooks and cli/speculative.py) on the CPU against the JAX
package, on the tiny Q4_0 models of _torch_port_models (target seed 5, a
bad draft seed 9 of the same vocabulary), f32 compute and cache.

Greedy tokens of the host loops and of the device blocks equal the JAX
package's and plain greedy decoding's, for a self draft (every draft
accepted), a bad draft (rejections), a block cut into several (max_steps
8) and prompt lookup with and without repeats; SpecStats equal, and
n_past, the host cell positions and the device positions of each engine
equal the JAX engine's after the call. The serving hooks
(spec_lookup_block, spec_lookup_block_multi, spec_draft_block) return the
JAX rows, accepted counts, steps and positions. The n-gram search over a
device history equals find_ngram_draft on hypothesis-drawn histories. The
stochastic rule equals the JAX rule on the JAX draws, and emits the target
distribution (total variation < 0.02 over 20,000 draws). Sampled draws
differ from JAX's by design (the engine's torch.Generator): a sampled run
is held to its seed and its invariants.
"""

import contextlib
import io

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime import speculative as JS
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm.runtime.sampling import SamplingParams as JParams
from tpulamm_torch.runtime import speculative as TS
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.runtime.sampling import SamplingParams

PROMPT = [1, 17, 42, 5, 99]
REPEAT = [7, 8, 9, 10, 7, 8, 9, 10, 7, 8]
N_CTX = 256


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny ops a cycle: one thread under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    return {"target": write_tiny_llama(str(d / "t.gguf"), GGMLType.Q4_0,
                                       seed=5),
            "bad": write_tiny_llama(str(d / "d.gguf"), GGMLType.Q4_0,
                                    seed=9)}


def _pair(path, n_slots=1):
    je = JEngine(path, n_ctx=N_CTX, n_slots=n_slots, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    te = Engine(path, n_ctx=N_CTX, n_slots=n_slots, compute_dtype="float32",
                kv_dtype=torch.float32, device="cpu")
    return je, te


@pytest.fixture(scope="module")
def plain(paths):
    """Plain greedy decoding of the target (the port's generate_fast and
    generate, which test_torch_decode_graph / generate hold to JAX)."""
    _, te = _pair(paths["target"])
    fast = {p: te.generate_fast(p, n_predict=40, stop_on_eos=False)[0]
            for p in (tuple(PROMPT), tuple(REPEAT))}
    te.reset_slot(0)
    host = te.generate(PROMPT, n_predict=20,
                       sampling=SamplingParams(temp=0.0),
                       stop_on_eos=False)[0]
    return fast, host


def _same_state(je, te, slot=0):
    assert list(te.n_past) == list(je.n_past)
    np.testing.assert_array_equal(te.cell_pos, je.cell_pos)
    np.testing.assert_array_equal(te.cache.pos[:, :N_CTX].numpy(),
                                  np.asarray(je.cache.pos)[:, :N_CTX])


def _stats(s):
    return (s.n_drafted, s.n_accepted, s.n_target_steps)


@pytest.mark.parametrize("draft", ["self", "bad"])
def test_spec_fast_matches_jax(paths, plain, draft):
    dpath = paths["target" if draft == "self" else draft]
    (jt, tt), (jd, td) = _pair(paths["target"]), _pair(dpath)
    want, wtext, wst = JS.generate_speculative_fast(
        jt, jd, PROMPT, n_predict=40, n_draft=4, stop_on_eos=False)
    got, text, gst = TS.generate_speculative_fast(
        tt, td, PROMPT, n_predict=40, n_draft=4, stop_on_eos=False)
    assert got == want == plain[0][tuple(PROMPT)]
    assert text == wtext and _stats(gst) == _stats(wst)
    assert (gst.accept_rate == 1.0) if draft == "self" else \
        (gst.accept_rate < 1.0)
    _same_state(jt, tt)
    _same_state(jd, td)


def test_spec_fast_multi_block(paths, plain, monkeypatch):
    """max_steps 8 and k = 2: at least two blocks for 40 tokens."""
    (jt, tt), (jd, td) = _pair(paths["target"]), _pair(paths["bad"])
    monkeypatch.setattr(JEngine, "DECODE_BUCKETS", (8,))
    monkeypatch.setattr(Engine, "DECODE_BUCKETS", (8,))
    want, _, wst = JS.generate_speculative_fast(
        jt, jd, PROMPT, n_predict=40, n_draft=2, stop_on_eos=False)
    got, _, gst = TS.generate_speculative_fast(
        tt, td, PROMPT, n_predict=40, n_draft=2, stop_on_eos=False)
    assert got == want == plain[0][tuple(PROMPT)]
    assert _stats(gst) == _stats(wst)
    _same_state(jt, tt)
    _same_state(jd, td)


@pytest.mark.parametrize("prompt", [PROMPT, REPEAT], ids=["fresh", "repeat"])
def test_lookup_fast_matches_jax(paths, plain, prompt):
    jt, tt = _pair(paths["target"])
    want, _, wst = JS.generate_prompt_lookup_fast(
        jt, prompt, n_predict=40, n_draft=4, stop_on_eos=False)
    got, _, gst = TS.generate_prompt_lookup_fast(
        tt, prompt, n_predict=40, n_draft=4, stop_on_eos=False)
    assert got == want == plain[0][tuple(prompt)]
    assert _stats(gst) == _stats(wst) and gst.n_drafted > 0
    _same_state(jt, tt)


@pytest.mark.parametrize("draft", ["self", "bad"])
def test_host_spec_matches_jax(paths, plain, draft):
    dpath = paths["target" if draft == "self" else draft]
    (jt, tt), (jd, td) = _pair(paths["target"]), _pair(dpath)
    want, _, wst = JS.generate_speculative(
        jt, jd, PROMPT, n_predict=20, n_draft=4,
        sampling=JParams(temp=0.0), stop_on_eos=False)
    got, _, gst = TS.generate_speculative(
        tt, td, PROMPT, n_predict=20, n_draft=4,
        sampling=SamplingParams(temp=0.0), stop_on_eos=False)
    assert got == want == plain[1]
    assert _stats(gst) == _stats(wst)
    _same_state(jt, tt)
    _same_state(jd, td)


def test_host_lookup_matches_jax(paths):
    jt, tt = _pair(paths["target"])
    want, _, wst = JS.generate_prompt_lookup(
        jt, PROMPT, n_predict=40, n_draft=4, sampling=JParams(temp=0.0),
        stop_on_eos=False)
    got, _, gst = TS.generate_prompt_lookup(
        tt, PROMPT, n_predict=40, n_draft=4,
        sampling=SamplingParams(temp=0.0), stop_on_eos=False)
    assert got == want and _stats(gst) == _stats(wst)
    assert gst.n_drafted > 0
    _same_state(jt, tt)


def test_rollback_restores_state(paths):
    """eval_tokens + rollback leave decode as if nothing was speculated
    (tests/test_speculative.py::test_rollback_restores_state)."""
    _, te = _pair(paths["target"])
    te.prefill(0, PROMPT)
    base = int(te.n_past[0])
    ref = te.decode_one(0, 11)
    te.rollback(0, base)
    te.eval_tokens(0, [11, 23, 54, 200])
    te.rollback(0, base)
    np.testing.assert_allclose(te.decode_one(0, 11), ref, rtol=1e-5,
                               atol=1e-5)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 5), min_size=1, max_size=24),
       st.integers(1, 5), st.integers(1, 3), st.integers(0, 2))
def test_find_ngram_draft(hist, n_draft, gmin, extra):
    gmax = gmin + extra
    want = JS.find_ngram_draft(hist, n_draft, gmin, gmax)
    assert TS.find_ngram_draft(hist, n_draft, gmin, gmax) == want
    # the device search over a -1-padded history: the same proposal,
    # padded with -1 past the history's end, zeros where none matches
    H = len(hist) + n_draft + 2
    h = torch.full((1, H), -1, dtype=torch.int32)
    h[0, :len(hist)] = torch.tensor(hist)
    got = TS._propose(h, torch.tensor([len(hist) - 1]), n_draft, gmin,
                      gmax)[0].tolist()
    assert got == ((want + [-1] * n_draft)[:n_draft] if want
                   else [0] * n_draft)


@pytest.mark.parametrize("seed", range(6))
def test_stochastic_rule_on_jax_draws(seed):
    """The port's rule on the uniforms and Gumbel noise the JAX rule draws
    from its key gives the JAX rule's (n_acc, nxt)."""
    V, k = 16, 3
    rng = np.random.default_rng(seed)
    lg_t = rng.normal(size=(k + 1, V)).astype(np.float32) * 1.5
    lg_d = rng.normal(size=(k, V)).astype(np.float32) * 1.5
    jpt = jax.vmap(lambda l: JS._dense_dist(l, jnp.float32(0.8), 5))(
        jnp.asarray(lg_t))
    jqd = jax.vmap(lambda l: JS._dense_dist(l, jnp.float32(0.8), 5))(
        jnp.asarray(lg_d))
    pt = TS._dense_dist(torch.from_numpy(lg_t), 0.8, 5)
    qd = TS._dense_dist(torch.from_numpy(lg_d), 0.8, 5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jpt), rtol=1e-5,
                               atol=1e-6)
    toks = np.asarray([int(np.argmax(np.asarray(jqd)[i]))
                       if i != seed % k else int(rng.integers(V))
                       for i in range(k)], np.int32)
    key = jax.random.PRNGKey(seed)
    n_acc, nxt, _ = JS._stochastic_accept(jpt, jqd, jnp.asarray(toks), key)
    _, ku, kr = jax.random.split(key, 3)
    u = np.asarray(jax.random.uniform(ku, (k,)))
    g = np.asarray(jax.random.gumbel(kr, (V,)))
    t_acc, t_nxt = TS._stochastic_accept(
        torch.from_numpy(np.asarray(jpt)), torch.from_numpy(np.asarray(jqd)),
        torch.from_numpy(toks), torch.from_numpy(u), torch.from_numpy(g))
    assert (int(t_acc), int(t_nxt)) == (int(n_acc), int(nxt))


def _rule_trials(pt, qd, N, seed, draft_toks=None):
    """N independent trials of the rule with the port's own draws: the
    draft tokens from q (unless given), then (n_acc, nxt) each."""
    gen = torch.Generator().manual_seed(seed)
    k, V = qd.shape
    out = []
    for _ in range(N):
        d = (draft_toks if draft_toks is not None else
             TS._dist_sample(qd, TS._gumbel((k, V), gen, "cpu")))
        u = torch.rand((k,), generator=gen)
        n_acc, nxt = TS._stochastic_accept(pt, qd, d, u,
                                           TS._gumbel((V,), gen, "cpu"))
        out.append((int(n_acc), int(nxt), int(d[0])))
    return np.asarray(out)


def test_stochastic_rule_distribution():
    """The first emitted token is distributed as p for a mismatched q."""
    V, k = 16, 3
    rng = np.random.default_rng(0)
    pt = TS._dense_dist(torch.from_numpy(
        rng.normal(size=(k + 1, V)).astype(np.float32) * 1.5), 1.0, 0)
    qd = TS._dense_dist(torch.from_numpy(
        rng.normal(size=(k, V)).astype(np.float32) * 1.5), 1.0, 0)
    r = _rule_trials(pt, qd, 20000, 1)
    first = np.where(r[:, 0] == 0, r[:, 1], r[:, 2])
    emp = np.bincount(first, minlength=V) / len(first)
    assert 0.5 * np.abs(emp - pt[0].numpy()).sum() < 0.02
    assert (r[:, 0] == 0).any() and (r[:, 0] > 0).any()


def test_stochastic_rule_identical_and_point_mass():
    """p == q accepts every draft; a point-mass q accepts at p(d) and
    resamples p without d on rejection."""
    V, k = 8, 4
    rng = np.random.default_rng(1)
    pt = TS._dense_dist(torch.from_numpy(
        rng.normal(size=(k + 1, V)).astype(np.float32)), 0.8, 0)
    assert (_rule_trials(pt, pt[:k], 500, 2)[:, 0] == k).all()
    p = torch.tensor([.3, .2, .15, .1, .1, .08, .05, .02])
    q = torch.zeros((1, V))
    q[0, 1] = 1.0
    r = _rule_trials(torch.stack([p, p]), q, 20000, 3, torch.tensor([1]))
    assert abs((r[:, 0] == 1).mean() - 0.2) < 0.01
    rej = r[r[:, 0] == 0, 1]
    res = p.numpy().copy()
    res[1] = 0.0
    res /= res.sum()
    emp = np.bincount(rej, minlength=V) / len(rej)
    assert 0.5 * np.abs(emp - res).sum() < 0.02 and (rej != 1).all()


def test_stochastic_self_draft(paths):
    """Self draft at temp 0.9: stochastic acceptance takes ~every draft
    (p == q); the same seed repeats the tokens; the cells stay
    contiguous."""
    runs = []
    for _ in range(2):
        (_, tt), (_, td) = _pair(paths["target"]), _pair(paths["target"])
        out, _, s = TS.generate_speculative_fast(
            tt, td, PROMPT, n_predict=32, n_draft=4, temp=0.9, top_k=0,
            seed=7, stop_on_eos=False)
        assert len(out) == 32 and s.accept_rate > 0.9
        n = int(tt.n_past[0])
        np.testing.assert_array_equal(tt.cell_pos[0, :n], np.arange(n))
        runs.append(out)
    assert runs[0] == runs[1]


def _hist(eng, slot, toks):
    eng.reset_slot(slot)
    eng.prefill(slot, toks)
    return list(toks)


def test_spec_lookup_block_matches_jax(paths):
    jt, tt = _pair(paths["target"], n_slots=2)
    res = []
    for eng in (jt, tt):
        h = _hist(eng, 1, REPEAT)
        res.append(eng.spec_lookup_block(1, 7, h, 4, 16, 30, -1))
    (jr, ja, jn, jp), (tr, ta, tn, tp) = res
    assert (tn, tp) == (jn, jp) and tn > 0
    np.testing.assert_array_equal(tr[:tn], np.asarray(jr)[:jn])
    np.testing.assert_array_equal(ta[:tn], np.asarray(ja)[:jn])
    _same_state(jt, tt)


def test_spec_lookup_block_multi_matches_jax(paths):
    """Greedy: two slots verified together, one with a short budget that
    freezes first."""
    jt, tt = _pair(paths["target"], n_slots=2)
    res = []
    for eng in (jt, tt):
        hists = {0: _hist(eng, 0, REPEAT), 1: _hist(eng, 1, PROMPT)}
        res.append(eng.spec_lookup_block_multi(
            {0: 7, 1: 3}, hists, {0: 30, 1: 9}, {0: -1, 1: -1},
            {0: 0.0, 1: 0.0}, 0, 4, 16, True, 0))
    (jr, ja, jn, jp, je_), (tr, ta, tn, tp, te_) = res
    assert tn == jn > 0
    np.testing.assert_array_equal(tr[:tn], np.asarray(jr)[:jn])
    np.testing.assert_array_equal(ta[:tn], np.asarray(ja)[:jn])
    np.testing.assert_array_equal(tp, np.asarray(jp))
    np.testing.assert_array_equal(te_, np.asarray(je_))
    _same_state(jt, tt)


def test_spec_lookup_block_multi_sampled(paths):
    """Temperature verify: each slot emits within its budget, the host
    mirrors follow the device positions, and a seed repeats."""
    outs = []
    for _ in range(2):
        _, tt = _pair(paths["target"], n_slots=2)
        hists = {0: _hist(tt, 0, REPEAT), 1: _hist(tt, 1, PROMPT)}
        rows, accs, n, posv, emitted = tt.spec_lookup_block_multi(
            {0: 7, 1: 3}, hists, {0: 12, 1: 9}, {0: -1, 1: -1},
            {0: 0.8, 1: 0.0}, 11, 4, 16, False, 40)
        assert list(emitted) == [12, 9]
        assert list(tt.n_past) == [len(REPEAT) + 12, len(PROMPT) + 9]
        assert list(posv) == list(tt.n_past)
        outs.append(rows[:n].tolist())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("draft", ["self", "bad"])
def test_spec_draft_block_matches_jax(paths, draft):
    dpath = paths["target" if draft == "self" else draft]
    (jt, tt), (jd, td) = _pair(paths["target"], 2), _pair(dpath)
    res = []
    for eng, d in ((jt, jd), (tt, td)):
        eng.attach_draft(d)
        h = _hist(eng, 1, PROMPT)
        a = eng.spec_draft_block(1, 3, h, 4, 8, 0.0, 40, 0, -1, 25)
        # a second block continues the draft's KV (no resync)
        n = a[2]
        block = [int(t) for r in a[0][:n] for t in r if t >= 0]
        h2 = h + [3] + block[:-1]
        b = eng.spec_draft_block(1, block[-1], h2, 4, 8, 0.0, 40, 0, -1, 10)
        res.append((a, b))
    for (j, t) in zip(*res):
        assert (t[2], t[3]) == (j[2], j[3]) and t[2] > 0
        np.testing.assert_array_equal(t[0][:t[2]], np.asarray(j[0])[:j[2]])
        np.testing.assert_array_equal(t[1][:t[2]], np.asarray(j[1])[:j[2]])
    _same_state(jt, tt)
    _same_state(jd, td)


def test_spec_hooks_refuse(paths):
    _, tt = _pair(paths["target"], n_slots=2)
    with pytest.raises(ValueError, match="no draft engine"):
        tt.spec_draft_block(0, 1, [], 4, 8, 0.0, 40, 0, -1, 10)
    tt.prefill(0, PROMPT)
    with pytest.raises(ValueError, match="hist has"):
        tt.spec_lookup_block(0, 1, [], 4, 8, 10, -1)
    _, two = _pair(paths["target"], n_slots=2)
    with pytest.raises(ValueError, match="single-slot"):
        tt.attach_draft(two)


CLI_MODES = {
    "lookup": [],
    "lookup-ondevice": ["--ondevice"],
    "draft": ["-md", "{bad}"],
    "draft-ondevice": ["-md", "{bad}", "--ondevice"],
    "tree": ["-md", "{bad}", "-np", "2", "--p-split", "0.02"],
    "lookahead": ["--lookahead", "-lw", "4", "-ln", "3", "-lg", "4"],
}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_speculative_matches_jax(paths, mode):
    """cli.speculative in every mode on the CPU prints the JAX CLI's text
    (greedy) and its draft statistics line."""
    from tpulamm.cli import speculative as jcli
    from tpulamm_torch.cli import speculative as tcli
    argv = ["-m", paths["target"], "-p", "the cat sat on the mat", "-n",
            "16", "--draft", "3", "-c", str(N_CTX), "--ignore-eos"] + [
        a.format(bad=paths["bad"]) for a in CLI_MODES[mode]]
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert main(argv + extra) == 0
        stats = [ln for ln in err.getvalue().splitlines()
                 if ln.startswith("n_drafted")]
        outs.append((out.getvalue(), stats))
    assert outs[1] == outs[0]
    assert len(outs[1][0]) > len("the cat sat on the mat")


def test_cli_gritlm_matches_jax(paths):
    """cli.gritlm on the CPU: the JAX CLI's cosine matrix (within 1e-3,
    printed to 3 decimals) and generation sample."""
    import re

    from tpulamm.cli import gritlm as jcli
    from tpulamm_torch.cli import gritlm as tcli
    argv = ["-m", paths["target"], "-c", str(N_CTX), "-n", "12"]
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue())
    sims = [[float(x) for x in re.findall(r"is: (-?[0-9.]+)", o)]
            for o in outs]
    assert len(sims[1]) == 4
    np.testing.assert_allclose(sims[1], sims[0], atol=1.5e-3)
    gen = [o.split("generation sample:")[1] for o in outs]
    assert gen[1] == gen[0]
