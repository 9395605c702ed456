"""Port parity: tpulamm_torch.models.transformer.forward against the JAX
forward, on the JAX loader's params carried across by params_from_numpy.

Tolerance: logits within 1e-4 * max|logit| in f32 compute (the products
and sums run in another order; weights dequantize identically), 2e-2 in
bf16 compute (activations round to bf16 at different points).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.models import loader as jloader
from tpulamm.models.transformer import forward as jforward
from tpulamm.runtime.kvcache import KVCache as JKVCache
from tpulamm_torch.gguf.reader import GGUFReader
from tpulamm_torch.models.config import config_from_metadata
from tpulamm_torch.models.loader import params_from_numpy
from tpulamm_torch.models.transformer import forward as tforward
from tpulamm_torch.runtime.kvcache import KVCache


@pytest.fixture(scope="module")
def q4_path(tmp_path_factory):
    return write_tiny_llama(str(tmp_path_factory.mktemp("m") / "q4.gguf"),
                            GGMLType.Q4_0, seed=3)


@pytest.mark.parametrize("cdt,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_forward_matches_jax(q4_path, cdt, tol):
    jcfg, jparams, _ = jloader.load_model(q4_path, compute_dtype=cdt)
    with GGUFReader(q4_path) as r:
        cfg = config_from_metadata(r.metadata)
    cfg.compute_dtype = cdt
    params = params_from_numpy(jparams, cfg, "cpu")

    T, n_ctx = 12, 32
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(1, T)).astype(np.int32)
    pos = np.arange(T, dtype=np.int32)[None]
    kv_dt = jnp.float32 if cdt == "float32" else jnp.bfloat16
    jc = JKVCache.create(jcfg.n_layers, 1, n_ctx + 1, jcfg.n_kv_heads,
                         jcfg.head_dim, dtype=kv_dt)
    want, _ = jforward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc,
                       None, jnp.asarray(pos))
    tc = KVCache.create(cfg.n_layers, 1, n_ctx + 1, cfg.n_kv_heads,
                        cfg.head_dim, dtype=getattr(torch, str(kv_dt.dtype)))
    got, tc = tforward(params, cfg, torch.from_numpy(toks),
                       torch.from_numpy(pos), tc, None, torch.from_numpy(pos))
    want = np.asarray(want)
    assert got.shape == want.shape == (1, T, cfg.vocab_size)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err
    # the KV write landed in place: positions 0..T-1 live, the rest empty
    assert (tc.pos[0, :T].numpy() == np.arange(T)).all()
    assert (tc.pos[0, T:] == -1).all()


@pytest.mark.parametrize("T,span,on_cuda,want", [
    (512, 512, True, None),                 # the slice's prefill ubatch
    (1, 1024, True, None),                  # the slice's decode span
    (64, 1024, True, "flash_attention"),    # T >= 64 at a span >= 1024
    (1, 8192, True, "flash_decode"),        # long-span decode
    (4, 6144, True, "flash_decode"),        # T * group = 8 at >= 6144
    (64, 1024, False, None),                # off the card: the einsum path
    (1, 8192, False, None),
])
def test_flash_choice_mirrors_jax_predicate(q4_path, T, span, on_cuda, want):
    """The JAX dispatch's flash predicates (transformer.py:169-187,
    :249-259) with "on CUDA" for "on TPU"; where they name a kernel the
    port's attention raises until that kernel is ported."""
    from tpulamm_torch.models.transformer import flash_choice
    with GGUFReader(q4_path) as r:
        cfg = config_from_metadata(r.metadata)
    assert cfg.n_heads // cfg.n_kv_heads == 2
    assert flash_choice(cfg, T, span, on_cuda) == want
