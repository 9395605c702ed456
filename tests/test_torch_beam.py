"""Port parity for beam search (runtime/beam.py) against the JAX
beam_search: one beam equals greedy generate; 4 beams give the JAX
sequence with the length-normalised score within 1e-6; a beam retiring at
EOS frees its slot (the case of tests/test_beam_infill.py).

Tiny Q4_0 GGUF, f32 compute and KV.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime.beam import beam_search as jbeam
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm_torch.runtime.beam import beam_search
from tpulamm_torch.runtime.engine import Engine
from tpulamm_torch.runtime.sampling import SamplingParams

PROMPT = [1, 300, 301, 302, 260]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(
        str(tmp_path_factory.mktemp("beam") / "q4.gguf"), GGMLType.Q4_0,
        seed=5)


def _pair(path, n_slots):
    je = JEngine(path, n_ctx=64, n_slots=n_slots, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    te = Engine(path, n_ctx=64, n_slots=n_slots, compute_dtype="float32",
                kv_dtype=torch.float32, device="cpu")
    return je, te


def test_beam1_equals_greedy(path):
    _, te = _pair(path, 1)
    greedy, _ = te.generate(PROMPT, n_predict=8,
                            sampling=SamplingParams(temp=0.0,
                                                    penalty_repeat=1.0),
                            stop_on_eos=False)
    te.reset_slot(0)
    beam, _ = beam_search(te, PROMPT, n_beams=1, n_predict=8)
    assert beam == greedy


@pytest.mark.parametrize("n_beams,n_predict", [(2, 10), (4, 12)])
def test_beams_match_jax(path, n_beams, n_predict):
    je, te = _pair(path, n_beams)
    want, wscore = jbeam(je, PROMPT, n_beams=n_beams, n_predict=n_predict)
    got, score = beam_search(te, PROMPT, n_beams=n_beams,
                             n_predict=n_predict)
    assert got == want and len(got) == n_predict
    assert abs(score - wscore) <= 1e-6
    np.testing.assert_array_equal(te.n_past, je.n_past)


def test_beam_retirement_frees_slots(tmp_path):
    """A beam ending in EOS frees its slot for later forks; both packages
    finish with the same sequence."""
    from tpulamm.models.config import ModelConfig
    from tpulamm.ops.rope import RopeParams
    from tpulamm.train.model import init_params, save_params_gguf
    cfg = ModelConfig(arch="llama", vocab_size=16, dim=64, n_layers=1,
                      n_heads=2, n_kv_heads=2, ffn_dim=128, n_ctx_train=64,
                      norm_eps=1e-5, rope=RopeParams(n_rot=32),
                      compute_dtype="float32")
    path = str(tmp_path / "v16.gguf")
    save_params_gguf(init_params(cfg, seed=7), cfg, path)
    je, te = _pair(path, 8)
    # with vocab 16 and 8 beams, EOS (id 2) lands in the beam set quickly;
    # generation must complete without slot exhaustion
    want, wscore = jbeam(je, [1, 5, 9], n_beams=8, n_predict=12)
    toks, score = beam_search(te, [1, 5, 9], n_beams=8, n_predict=12)
    assert len(toks) <= 12 and np.isfinite(score)
    assert toks == want and abs(score - wscore) <= 1e-6
