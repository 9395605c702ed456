"""Port parity: the streaming probe's reduce (tpulamm_torch.tools.
stream_ceiling) on the CPU against the JAX make_reduce, whose Pallas
kernel runs in interpret mode (pl.pallas_call patched with interpret=True
for the test only; the JAX package is not changed).

The buffers have row tails that the kernel must skip at every block size.
Tolerance: max |port - JAX| <= 1e-5 * max_col sum|x| (f32 sums in another
order); the 8 output rows identical.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from tpulamm.tools import stream_ceiling as jsc
from tpulamm_torch.tools import stream_ceiling as SC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pools spinning across processes slow the many small ops
    of a decode loop by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS, COLS = 2 * 2048 + 300, 256


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("block_rows", [512, 1024, 2048])
def test_reduce_matches_jax_kernel(interpret, block_rows):
    rng = np.random.default_rng(block_rows)
    x = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    b = np.full((1, 1), 0.5, np.float32)
    want = np.asarray(jsc.make_reduce(ROWS, COLS, block_rows)(
        jnp.asarray(b), jnp.asarray(x)))
    SC.reset_launches()
    got = SC.make_reduce(ROWS, COLS, block_rows)(torch.from_numpy(b),
                                                 torch.from_numpy(x)).numpy()
    ref = SC.reduce_ref(torch.from_numpy(x), torch.from_numpy(b),
                        block_rows).numpy()
    tol = 1e-5 * np.abs(x).sum(0).max()
    assert got.shape == ref.shape == want.shape == (8, COLS)
    assert (got == got[:1]).all()
    assert np.abs(got - want).max() <= tol
    assert np.abs(ref - want).max() <= tol
    # the tail rows are not read: a sum over every row is far off
    n = ROWS // block_rows * block_rows
    np.testing.assert_allclose(got[0], x[:n].astype(np.float64).sum(0) + 0.5,
                               rtol=0, atol=tol)
    assert SC.LAUNCHES == {"stream_reduce": 0}       # the CPU runs no kernel


def test_make_reduce_refuses():
    with pytest.raises(ValueError, match="multiple of 4"):
        SC.make_reduce(64, 6, 512)
    with pytest.raises(ValueError, match="positive"):
        SC.make_reduce(64, 8, 0)
    run = SC.make_reduce(64, 8, 16)
    with pytest.raises(ValueError, match=r"\(64, 8\) float32"):
        run(torch.zeros((1, 1)), torch.zeros((64, 12)))
    with pytest.raises(ValueError, match="one value"):
        run(torch.zeros((2,)), torch.zeros((64, 8)))


def test_probe_entry_point_on_cpu(capsys):
    """main() allocates the buffer from a seeded generator and prints one
    row per block size and the best rate, beside the device it ran on."""
    assert SC.main(["0.01", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("buffer ") and "cpu" in out[0]
    assert [line.split()[0] for line in out[1:4]] == [
        "block_rows=512", "block_rows=1024", "block_rows=2048"]
    assert out[-1].startswith("streaming ceiling: ")
    assert SC.read_bytes(ROWS, COLS, 2048) == 2 * 2048 * COLS * 4
