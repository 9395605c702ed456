"""Port parity: tpulamm_torch.ops.device_sampling on the CPU against the
JAX package's on-device sampler chain (and, at temp 0, the host Sampler).

The same seeded numpy logits and token histories go to both. Counts and
the token ring must be equal exactly; penalized logits within rtol 1e-6;
the filter's candidate ids and keep-sets (kv > -1e29) equal for the six
parameter rows of tests/test_device_sampling.py; greedy tokens equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpulamm.ops import device_sampling as jds
from tpulamm.runtime.sampling import Sampler as JSampler
from tpulamm.runtime.sampling import SamplingParams as JSamplingParams
from tpulamm_torch.ops import device_sampling as ds
from tpulamm_torch.runtime.sampling import Sampler, SamplingParams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pools spinning across processes slow the many small ops
    of a decode loop by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V = 400


def _sp(n, **kw):
    """Neutral numpy SampParams for n slots, with overrides."""
    base = dict(temp=np.zeros(n, np.float32),
                top_k=np.full(n, ds.K_CHAIN, np.int32),
                top_p=np.ones(n, np.float32),
                min_p=np.zeros(n, np.float32),
                tfs_z=np.ones(n, np.float32),
                typical_p=np.ones(n, np.float32),
                pen_repeat=np.ones(n, np.float32),
                pen_freq=np.zeros(n, np.float32),
                pen_present=np.zeros(n, np.float32),
                last_n=np.full(n, ds.W_RING, np.int32),
                penalize_nl=np.ones(n, bool),
                ignore_eos=np.zeros(n, bool))
    for k, v in kw.items():
        base[k] = np.full(n, v, base[k].dtype)
    return base


def _both(base):
    """(torch SampParams, JAX SampParams) of the same numpy vectors."""
    return (ds.params_to(ds.SampParams(**base), "cpu"),
            jds.SampParams(**{k: jnp.asarray(v) for k, v in base.items()}))


def _ring(rng, n):
    prevs = {i: rng.integers(0, 30, rng.integers(0, 90)).tolist()
             for i in range(n)}
    ring, wr = ds.ring_from_prev(prevs, n)
    jring, jwr = jds.ring_from_prev(prevs, n)
    np.testing.assert_array_equal(ring, jring)
    assert wr == jwr
    return ring, wr


def test_build_counts_and_push_token_equal_jax():
    rng = np.random.default_rng(0)
    n = 4
    ring, wr = _ring(rng, n)
    last_n = np.array([0, 3, 17, 64], np.int32)
    counts = ds.build_counts(torch.from_numpy(ring), wr,
                             torch.from_numpy(last_n), 32)
    jcounts = jds.build_counts(jnp.asarray(ring), jnp.int32(wr),
                               jnp.asarray(last_n), 32)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    t_ring, t_wr, j_ring, j_wr = torch.from_numpy(ring), wr, \
        jnp.asarray(ring), jnp.int32(wr)
    for step in range(70):                     # wraps the 64-entry ring
        tok = rng.integers(0, 32, n).astype(np.int32)
        act = np.array([True, step % 3 != 0, True, step % 2 == 0])
        t_ring, t_wr, counts = ds.push_token(
            t_ring, t_wr, counts, torch.from_numpy(last_n),
            torch.from_numpy(tok), torch.from_numpy(act))
        j_ring, j_wr, jcounts = jds.push_token(
            j_ring, j_wr, jcounts, jnp.asarray(last_n), jnp.asarray(tok),
            jnp.asarray(act))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(t_ring.numpy(), np.asarray(j_ring))
        assert t_wr == int(j_wr)


def test_apply_penalties_match_jax():
    rng = np.random.default_rng(1)
    n = 3
    lg = rng.normal(0, 2, (n, V)).astype(np.float32)
    counts = rng.integers(0, 3, (n, V)).astype(np.int32)
    base = _sp(n)
    base.update(pen_repeat=np.array([1.0, 1.3, 1.1], np.float32),
                pen_freq=np.array([0.0, 0.2, 0.5], np.float32),
                pen_present=np.array([0.3, 0.0, 0.1], np.float32),
                penalize_nl=np.array([True, False, True]),
                ignore_eos=np.array([False, True, False]))
    sp, jsp = _both(base)
    got = ds.apply_penalties(torch.from_numpy(lg), torch.from_numpy(counts),
                             sp, 13, 2).numpy()
    want = np.asarray(jds.apply_penalties(jnp.asarray(lg),
                                          jnp.asarray(counts), jsp, 13, 2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[1, 2] == -np.inf and got[1, 13] == lg[1, 13]


@pytest.mark.parametrize("kw", [
    {"top_k": 40}, {"top_k": 40, "top_p": 0.9}, {"top_k": 64, "min_p": 0.05},
    {"top_k": 80, "tfs_z": 0.95}, {"top_k": 80, "typical_p": 0.9},
    {"top_k": 40, "top_p": 0.8, "min_p": 0.02, "tfs_z": 0.97,
     "typical_p": 0.95}])
def test_filter_candidates_match_jax(kw):
    rng = np.random.default_rng(0)
    lg = rng.normal(0, 3, (3, V)).astype(np.float32)
    sp, jsp = _both(_sp(3, **kw))
    kv, ki = ds.filter_candidates(torch.from_numpy(lg), sp)
    jkv, jki = jax.jit(jds.filter_candidates)(jnp.asarray(lg), jsp)
    np.testing.assert_array_equal(ki.numpy(), np.asarray(jki))
    np.testing.assert_array_equal(kv.numpy() > -1e29, np.asarray(jkv) > -1e29)


def test_sample_chain_greedy_matches_jax_and_host_sampler():
    rng = np.random.default_rng(2)
    lg = rng.normal(0, 2, (2, V)).astype(np.float32)
    prevs = {0: [5, 5, 5, 9, 13, 13], 1: [7] * 10 + [2]}
    kws = [dict(temp=0.0, penalty_repeat=1.4, penalty_freq=0.2,
                penalty_present=0.3, penalty_last_n=4),
           dict(temp=0.0, penalty_repeat=1.1, penalty_last_n=64,
                penalize_nl=False, ignore_eos=True)]
    smp, jsmp = {}, {}
    for i, kw in enumerate(kws):
        smp[i] = Sampler(SamplingParams(**kw), V, eos_id=2, nl_id=13)
        jsmp[i] = JSampler(JSamplingParams(**kw), V, eos_id=2, nl_id=13)
        for t in prevs[i]:
            smp[i].accept(t)
            jsmp[i].accept(t)
    sp = ds.params_to(ds.params_from_samplers(smp, 2), "cpu")
    ring, wr = ds.ring_from_prev({i: s.prev for i, s in smp.items()}, 2)
    counts = ds.build_counts(torch.from_numpy(ring), wr, sp.last_n, V)
    gen = torch.Generator().manual_seed(0)
    got = ds.sample_chain(torch.from_numpy(lg), gen, sp, counts, 13, 2)
    jsp = jax.tree_util.tree_map(jnp.asarray, jds.params_from_samplers(jsmp, 2))
    jcounts = jds.build_counts(jnp.asarray(ring), jnp.int32(wr), jsp.last_n, V)
    _, want = jds.sample_chain(jnp.asarray(lg), jax.random.PRNGKey(0), jsp,
                               jcounts, 13, 2, jnp.ones(2, bool))
    for b in (0, 1):
        assert int(got[b]) == int(want[b]) == smp[b].sample(lg[b]), b


def test_sample_chain_draws_within_the_keep_set():
    """temp > 0: every draw is a candidate the filters kept, and the same
    generator seed gives the same draws."""
    rng = np.random.default_rng(3)
    lg = torch.from_numpy(rng.normal(0, 3, (4, V)).astype(np.float32))
    sp = ds.params_to(ds.SampParams(**_sp(4, temp=0.8, top_k=20, top_p=0.9)),
                      "cpu")
    counts = torch.zeros((4, V), dtype=torch.int32)
    kv, ki = ds.filter_candidates(lg, sp)
    keep = [set(ki[b][kv[b] > -1e29].tolist()) for b in range(4)]
    draws = []
    for seed in (5, 5):
        gen = torch.Generator().manual_seed(seed)
        draws.append([ds.sample_chain(lg, gen, sp, counts, 13, 2).tolist()
                      for _ in range(20)])
    assert draws[0] == draws[1]
    assert all(t in keep[b] for row in draws[0] for b, t in enumerate(row))


@pytest.mark.parametrize("kw", [
    {}, {"temp": 0.0}, {"mirostat": 2}, {"logit_bias": {5: 1.0}},
    {"n_probs": 3}, {"samplers_sequence": "kt"}, {"dynatemp_range": 0.5},
    {"penalty_last_n": 65}, {"penalty_last_n": -1, "n_prev": 64},
    {"penalty_last_n": -1, "n_prev": 65}, {"temp": 0.7, "top_k": 0},
    {"temp": 0.7, "top_k": 129}, {"temp": 0.0, "top_k": 0}])
def test_fast_chain_eligible_matches_jax(kw):
    assert ds.fast_chain_eligible(SamplingParams(**kw)) == \
        jds.fast_chain_eligible(JSamplingParams(**kw))
