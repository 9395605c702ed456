"""Port parity for the harness tools: tools/make_bench_model.py,
longctx_bench.py, collect_results.py and preset.py, against the JAX
package's, on the CPU (`--device cpu`).

- make_bench_model: the padtest and mmproj targets write the same bytes
  as the JAX tool's.
- collect_results: the same tables, with and without --compare.
- preset: the argv it builds equals the JAX tool's; running `main` from a
  YAML file prints what cli.main prints with that argv.
- longctx_bench: the four {einsum, flash} x {bf16, q8_0} rows in process
  on a tiny model, with the greedy parity of flash against einsum.
- the new entry points default to CUDA and raise without it.
"""

import contextlib
import filecmp
import io
import json
import os

import numpy as np
import pytest
import torch
import yaml

from _torch_port_models import write_tiny_llama
from tpulamm.tools import collect_results as JCR
from tpulamm.tools import make_bench_model as JMB
from tpulamm.tools import preset as JPR
from tpulamm_torch.cli import llava
from tpulamm_torch.cli import main as gen_main
from tpulamm_torch.tools import collect_results as CR
from tpulamm_torch.tools import longctx_bench as LB
from tpulamm_torch.tools import make_bench_model as MB
from tpulamm_torch.tools import preset as PR


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_tiny_llama(str(tmp_path_factory.mktemp("tools") / "q4.gguf"))


def _stdout(fn, *a) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a)
    return rc, buf.getvalue()


@pytest.mark.parametrize("target", ["padtest", "mmproj"])
def test_make_bench_model_bytes_equal(tmp_path, target):
    pytest.importorskip("transformers")
    a, b = tmp_path / "jax", tmp_path / "port"
    assert JMB.main(["--out", str(a), "--targets", target]) == 0
    assert MB.main(["--out", str(b), "--targets", target]) == 0
    name = {"padtest": "padtest_q4.gguf", "mmproj": "mmproj_test.gguf"}[target]
    assert filecmp.cmp(a / name, b / name, shallow=False)


def test_collect_results_tables_equal(tmp_path):
    rows = [{"test": "matmult", "dtype": "q4_0", "gflops": 1234.5,
             "device": "NVIDIA H100"},
            {"test": "inference", "dtype": "q8_0", "prompt_tps": 5000.25,
             "gen_tps": 110.5, "device": "NVIDIA H100"}]
    old = [dict(r, gflops=1000.0) if "gflops" in r else dict(r, gen_tps=100.0)
           for r in rows]
    log, cmp = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    log.write_text("".join(json.dumps(r) + "\n" for r in rows))
    cmp.write_text("".join(json.dumps(r) + "\n" for r in old))
    for argv in ([str(log)], [str(log), "--compare", str(cmp)]):
        got, ref = _stdout(CR.main, argv), _stdout(JCR.main, argv)
        assert got == ref and got[0] == 0 and "1234.50" in got[1]


PRESET = """# a generation preset
model: {model}
prompt: "the cat: sat"   # quoted, with a colon
n-predict: 4
temp: 0
ignore_eos: true
device: cpu
"""


def test_preset_runs_main(model, tmp_path):
    path = tmp_path / "gen.yaml"
    path.write_text(PRESET.format(model=model))
    props = yaml.safe_load(path.read_text())
    props.pop("device")
    assert PR.props_to_argv(props) == JPR.props_to_argv(props)
    argv = PR.props_to_argv({k.replace("_", "-"): v
                             for k, v in props.items()}) + ["--device", "cpu"]
    rc, want = _stdout(gen_main.main, argv)
    assert rc == 0
    rc, got = _stdout(PR.main, [str(path), "--n-predict", "4"])
    assert rc == 0 and got == want and want.strip()
    assert PR.TOOLS == {k: v.replace("tpulamm.", "tpulamm_torch.", 1)
                        for k, v in JPR.TOOLS.items()}


def test_longctx_bench_in_process(tmp_path):
    """On make_bench_model's padtest model (the tool's prompt draws ids
    below 1000; vocab 4608)."""
    MB.build_padtest(str(tmp_path))
    model = str(tmp_path / "padtest_q4.gguf")
    out = tmp_path / "rows.json"
    rc, text = _stdout(LB.main, ["-m", model, "--ctxs", "256", "--n-gen",
                                 "16", "--device", "cpu",
                                 "--json", str(out)])
    assert rc == 0 and "| n_ctx |" in text
    rows = json.loads(out.read_text())
    assert [(r["attn"], r["kv"]) for r in rows] == [
        ("einsum", "bfloat16"), ("einsum", "q8_0"), ("flash", "bfloat16"),
        ("flash", "q8_0")]
    assert all(r["pp"] > 0 and r["tg"] > 0 for r in rows)
    assert [r.get("parity_vs_einsum") for r in rows[2:]] == [True, True]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only host")
def test_entry_points_default_to_cuda(model, tmp_path):
    img = tmp_path / "i.npy"
    np.save(img, np.zeros((8, 8, 3), np.uint8))
    mm = tmp_path / "mm.gguf"
    MB.build_padtest(str(tmp_path))       # any file: the CLIP load raises
    os.rename(tmp_path / "padtest_q4.gguf", mm)
    with pytest.raises(RuntimeError, match="CUDA"):
        llava.main(["-m", model, "--mmproj", str(mm), "--image", str(img)])
    with pytest.raises(RuntimeError, match="CUDA"):
        LB.main(["-m", model, "--ctxs", "256", "--n-gen", "16"])
    # the mesh runs on the card too: --tp 2 without CUDA raises before any
    # rank is placed or a port is bound
    from tpulamm_torch.cli import bench as tbench
    from tpulamm_torch.server import server as tserver
    for fn, argv in ((gen_main.main, ["-p", "hi", "-n", "2"]),
                     (tbench.main, ["-p", "8", "-n", "2"]),
                     (tserver.main, ["--port", "0"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(["-m", model, "--tp", "2", *argv])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only host")
def test_training_mesh_entry_points_default_to_cuda(model, tmp_path):
    """The training mesh, the pipeline's mesh, the params train(mesh=)
    trains and the int8 audit run on the card unless asked for the CPU:
    each default raises without CUDA (the audit before it quantizes)."""
    from tpulamm_torch.models.config import ModelConfig
    from tpulamm_torch.parallel.mesh import make_mesh
    from tpulamm_torch.parallel.pipeline import make_pp_mesh
    from tpulamm_torch.tools import int8_kl_audit
    from tpulamm_torch.train.model import init_params
    cfg = ModelConfig(arch="llama", vocab_size=64, dim=64, n_layers=2,
                      n_heads=4, n_kv_heads=2, ffn_dim=128)
    for call in (lambda: make_mesh(2, 2), lambda: make_pp_mesh(2),
                 lambda: init_params(cfg),
                 lambda: int8_kl_audit.main(
                     ["--f32-model", model, "--formats", "Q4_0",
                      "--out-dir", str(tmp_path / "out")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not (tmp_path / "out").exists()
