"""Port parity: tpulamm_torch.ops.{layers,rope} against tpulamm.ops.*.

Same seeded numpy inputs through both; f32 throughout, rel <= 1e-6 of
max|out| (the two frameworks' rsqrt/exp/cos/sin may differ in the last
bit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulamm.ops import layers as jl
from tpulamm.ops import rope as jr
from tpulamm_torch.ops import layers as tl
from tpulamm_torch.ops import rope as tr

TOL = 1e-6


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, err


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm(with_bias):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 5, 64)) + 2.0).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32) if with_bias else None
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b), 1e-5)
    want = jl.layer_norm(jnp.asarray(x), jnp.asarray(w),
                         None if b is None else jnp.asarray(b), 1e-5)
    _close(got.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(kind="norm"),
    dict(kind="neox"),
    dict(kind="norm", freq_scale=0.25),
    dict(kind="neox", n_rot=32),                        # partial rotation
    dict(kind="neox", freq_scale=0.25, ext_factor=1.0, n_orig_ctx=512,
         freq_base=500000.0),                           # YaRN
])
def test_apply_rope(kw):
    kw = {"n_rot": 64, **kw}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    want = jr.apply_rope(jnp.asarray(x), jnp.asarray(pos), jr.RopeParams(**kw))
    got = tr.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        tr.RopeParams(**kw))
    _close(got.numpy(), want)


def test_masked_softmax_with_fully_masked_rows():
    rng = np.random.default_rng(2)
    s = (rng.normal(size=(2, 4, 9)) * 5).astype(np.float32)
    mask = rng.random(size=(2, 4, 9)) > 0.4
    mask[1, 2] = False                                  # fully masked row
    got = tl.masked_softmax(torch.from_numpy(s), torch.from_numpy(mask))
    want = jl.masked_softmax(jnp.asarray(s), jnp.asarray(mask))
    assert not got[1, 2].any() and np.isfinite(got.numpy()).all()
    _close(got.numpy(), want)


def test_silu_gelu():
    x = np.random.default_rng(3).normal(size=(100,)).astype(np.float32) * 4
    _close(tl.silu(torch.from_numpy(x)).numpy(), jl.silu(jnp.asarray(x)))
    _close(tl.gelu(torch.from_numpy(x)).numpy(), jl.gelu(jnp.asarray(x)))
