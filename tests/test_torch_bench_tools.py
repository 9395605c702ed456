"""The port's measurement tools on the CPU (tpulamm_torch.bench,
cli.bench, tools.perf_report, tools.decode_roofline) against the JAX
package's, on the tiny Q4_0 GGUF of tests/_torch_port_models.py.

- cli.bench prints the JAX CLI's output line for line: both run with the
  same stand-in rates, so only the formatting is compared; then the port's
  CLI runs for real in both modes.
- perf_report's bench_matmul and tpulamm_torch.bench pass their gate at a
  small shape (on the CPU the product is the plain version: rel and nmse
  0); bench_batched / bench_ctx_scaling run.
- decode_roofline's per-op MB equal the JAX qbytes of the same tensors.
"""

import json

import numpy as np
import pytest
import torch

from _torch_port_models import write_tiny_llama
from tpulamm.cli import bench as jbench
from tpulamm.gguf.constants import GGMLType
from tpulamm.runtime.engine import Engine as JEngine
from tpulamm.tools import decode_roofline as jroof
from tpulamm_torch import bench
from tpulamm_torch.cli import bench as tbench
from tpulamm_torch.tools import decode_roofline, perf_report


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pools spinning across processes slow the many small ops
    of a decode loop by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_tiny_llama(str(tmp_path_factory.mktemp("m") / "q4.gguf"),
                            GGMLType.Q4_0, seed=5)


def _stand_in_rates(monkeypatch, mod):
    monkeypatch.setattr(mod, "_pp_bench", lambda eng, n, reps: [100.0 + n,
                                                                 110.5])
    monkeypatch.setattr(mod, "_tg_bench",
                        lambda eng, n, reps, fast=True: [10.25, 12.0 + n])
    monkeypatch.setattr(mod, "_batched_bench", lambda eng, pp, tg, pl: {
        "pp": pp, "tg": tg, "pl": pl, "pp_ts": 1000.0 / pl,
        "tg_ts": 20.5 * pl, "total_ts": 33.125})


@pytest.mark.parametrize("fmt", ["md", "csv", "json", "sql"])
@pytest.mark.parametrize("batched", [False, True], ids=["pp_tg", "batched"])
def test_cli_bench_prints_the_jax_cli_lines(model, monkeypatch, capsys, fmt,
                                            batched):
    args = ["-m", model, "-p", "16", "-p", "32", "-n", "8", "-c", "64",
            "-o", fmt, "-r", "1"]
    if batched:
        args += ["--batched", "-pl", "1", "-pl", "2"]
    _stand_in_rates(monkeypatch, jbench)
    assert jbench.main(args) == 0
    want = capsys.readouterr().out
    _stand_in_rates(monkeypatch, tbench)
    assert tbench.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines() and len(want.splitlines()) >= 1


@pytest.mark.parametrize("batched", [False, True], ids=["pp_tg", "batched"])
def test_cli_bench_runs_on_cpu(model, capsys, tmp_path, batched):
    args = ["-m", model, "-p", "16", "-n", "4", "-r", "1", "-c", "64",
            "-o", "json", "--device", "cpu"]
    if batched:
        args += ["--batched", "-pl", "1", "-pl", "3"]
    else:
        args += ["--profile", str(tmp_path / "prof")]
    assert tbench.main(args) == 0
    rows = json.loads(capsys.readouterr().out)
    if batched:
        assert [(r["pp"], r["tg"], r["pl"]) for r in rows] == [(16, 4, 1),
                                                               (16, 4, 3)]
        assert all(r["tg_ts"] > 0 and r["total_ts"] > 0 for r in rows)
    else:
        assert [r["test"] for r in rows] == ["pp16", "tg4"]
        assert (tmp_path / "prof" / "trace.json").is_file()


@pytest.mark.parametrize("qname", perf_report.FORMATS)
def test_bench_matmul_gate_at_a_small_shape(qname):
    r = perf_report.bench_matmul(qname, shape=(256, 512, 32), device="cpu",
                                 reps=2)
    assert r["ok"] and r["gflops"] > 0
    assert r["nmse"] <= 1e-4 and r["rel"] <= 1e-2


def test_bench_gate_at_a_small_shape():
    r = bench.run(shape=(256, 512, 32), device="cpu", reps=2)
    assert r["ok"] and r["rel"] == 0.0 and r["nmse"] == 0.0
    assert r["gflops"] > 0 and r["device"].startswith("cpu")


def test_bench_batched_and_ctx_scaling_run(model):
    rows = perf_report.bench_batched(model, pls=(1, 2), n_pp=8, n_tg=4,
                                     n_ctx=64, device="cpu")
    assert [r["pl"] for r in rows] == [1, 2]
    assert all(r["agg_ts"] > 0 for r in rows)
    rows = perf_report.bench_ctx_scaling(model, ctxs=(48,), device="cpu")
    assert [r["n_ctx"] for r in rows] == [48] and rows[0]["tg256"] > 0


def test_decode_roofline_bytes_equal_jax_qbytes(model, tmp_path, capsys):
    out = tmp_path / "roof.json"
    assert decode_roofline.main(["-m", model, "--device", "cpu", "--span",
                                 "64", "--n-predict", "4", "--json",
                                 str(out)]) == 0
    assert "| op | xN | MB/call |" in capsys.readouterr().out
    rows = {r["op"].split()[1]: r for r in json.loads(out.read_text())["rows"]
            if r["op"].startswith("qmm ")}
    je = JEngine(model, n_ctx=64)
    lyr = je.params["layers"][0]
    want = {k: jroof.qbytes(lyr[k]) for k in ("wqkv_fused", "wo",
                                              "wgateup_fused", "w_down")}
    want["lm_head"] = jroof.qbytes(je.params["output"])
    assert set(rows) == set(want)
    for k, nbytes in want.items():
        assert rows[k]["mb"] == pytest.approx(nbytes / 1e6, rel=1e-12), k
        assert rows[k]["count"] == (1 if k == "lm_head" else 2)
    assert np.isfinite([r["us"] for r in rows.values()]).all()
