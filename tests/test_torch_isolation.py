"""The port stands alone: importing every tpulamm_torch module and
chip_smoke.py loads no jax, no optax, nothing of the tpulamm package and
no `regex` (the JAX BPE tokenizer's dependency, absent on the GPU machine),
and no source file of theirs imports any of them; nor do they load
`transformers` or `PIL`, which the GPU machine lacks too: no source
imports either at module level (a function may, where it skips without
them: make_bench_model's mmproj target, clip.load_image). The worker
script the port's multi-process tests start (tests/_torch_mesh_worker.py)
imports none of them either."""

import ast
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "tpulamm_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# the worker scripts the port's multi-process tests start: port code too
SCRIPTS = [ROOT / "tests" / "_torch_mesh_worker.py"]


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
    return top in ("jax", "jaxlib", "optax", "regex") or top == "tpulamm"


def _absent_on_card(name: str) -> bool:
    return name.split(".")[0] in ("transformers", "PIL")


def _import_names(node) -> list[str]:
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom):
        return [node.module or ""]
    return []


def _module_level(tree):
    """The statements run at import: the module body and what its
    top-level if / try / with blocks hold."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                for sub in getattr(node, field, []):
                    todo.extend(sub.body if isinstance(
                        sub, ast.ExceptHandler) else [sub])


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
    assert "tpulamm_torch.parallel.distributed" in loaded
    assert "tpulamm_torch.server.multihost" in loaded
    bad = [m for m in loaded if _forbidden(m) or _absent_on_card(m)]
    assert not bad, bad


def test_sources_import_no_jax_or_tpulamm():
    bad = []
    assert ROOT / "tpulamm_torch" / "parallel" / "mesh.py" in SOURCES
    for p in SOURCES + SCRIPTS:
        tree = ast.parse(p.read_text(), str(p))
        for node in ast.walk(tree):
            bad += [f"{p.relative_to(ROOT)}: {n}" for n in _import_names(node)
                    if _forbidden(n)]
        for node in _module_level(tree):
            bad += [f"{p.relative_to(ROOT)}: {n} at module level"
                    for n in _import_names(node) if _absent_on_card(n)]
    assert not bad, bad


def test_csrc_includes_nothing_of_native():
    """The CUDA and C++ sources of the port include system headers and
    their own csrc headers only: the host codec is the port's copy, not
    the JAX package's native/ library."""
    bad = []
    csrc = ROOT / "tpulamm_torch" / "csrc"
    for p in sorted(csrc.glob("*.c*")):
        for inc in re.findall(r'^\s*#\s*include\s+([<"][^>"]+[>"])',
                              p.read_text(), re.M):
            name = inc[1:-1]
            if inc[0] == '"' and not (csrc / name).is_file():
                bad.append(f"{p.name}: {inc}")
            if "native" in name or "tl_tokenizer" in name:
                bad.append(f"{p.name}: {inc}")
    assert (csrc / "tl_codec.cpp").is_file()
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
