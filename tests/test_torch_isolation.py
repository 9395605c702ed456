"""The port stands alone: importing every tpulamm_torch module and
chip_smoke.py loads no jax and nothing of the tpulamm package, and no
source file of theirs imports either."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "tpulamm_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _modules():
    mods = []
    for p in SOURCES:
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "tpulamm"


def test_imports_load_no_jax_or_tpulamm():
    code = ("import importlib, json, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tpulamm_torch.runtime.engine" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_sources_import_no_jax_or_tpulamm():
    bad = []
    for p in SOURCES:
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{p.relative_to(ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_smoke_without_cuda_prints_no_result(tmp_path):
    """Without a GPU chip_smoke exits non-zero and prints no result line;
    alone in a directory (no package beside it) it cannot run at all."""
    import torch
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and '"ok"' not in out.stdout
