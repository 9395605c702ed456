"""Port parity for the generation CLIs: tpulamm_torch.cli.main (--device
cpu) against tpulamm.cli.main at --temp 0 on a tiny Q4_0 GGUF, f32 compute
and cache, standard output equal for every case; then infill, beam_search,
parallel, passkey, save_load_state and embedding against the JAX CLIs
(default compute; embedding cosine >= 0.9999), and batched against the JAX
engine's decode_batch_fast tokens (the JAX batched CLI raises NameError
before it prints: it reads an undefined name, `first`).
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest

from _torch_port_models import write_tiny_llama
from tpulamm.cli import beam_search as jbeam_cli
from tpulamm.cli import batched as jbatched
from tpulamm.cli import embedding as jembedding
from tpulamm.cli import infill as jinfill
from tpulamm.cli import main as jmain
from tpulamm.cli import parallel as jparallel
from tpulamm.cli import passkey as jpasskey
from tpulamm.cli import save_load_state as jsave_load
from tpulamm.gguf.constants import GGMLType
from tpulamm.gguf.reader import GGUFReader
from tpulamm.gguf.writer import GGUFWriter
from tpulamm_torch.cli import batched, beam_search, embedding, infill, main
from tpulamm_torch.cli import parallel, passkey, save_load_state

PROMPT = "the cat sat on the mat"
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(
        str(tmp_path_factory.mktemp("cli") / "q4.gguf"), GGMLType.Q4_0,
        seed=5)


@pytest.fixture(scope="module")
def fim_path(path, tmp_path_factory):
    """The tiny model with fill-in-the-middle token ids."""
    src = GGUFReader(path)
    out = str(tmp_path_factory.mktemp("fim") / "fim.gguf")
    w = GGUFWriter(out)
    for k, v in src.metadata.items():
        w.add_kv(k, v)
    for i, role in enumerate(("prefix", "suffix", "middle", "eot")):
        w.add_kv(f"tokenizer.ggml.{role}_token_id", 300 + i)
    for name, info in src.tensors.items():
        w.add_tensor(name, np.asarray(info.data), shape=info.shape,
                     ggml_type=info.ggml_type)
    w.write()
    src.close()
    return out


def run(mod, argv, stdin=None, monkeypatch=None):
    """mod.main(argv) -> (return code, stdout, stderr)."""
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def main_argv(path, *extra):
    return ["-m", path, "-p", PROMPT, "-n", "12", "--temp", "0", "-c", "128",
            "--compute-dtype", "float32", "-ctk", "float32", *extra]


MAIN_CASES = {
    "plain": [],
    "escape": ["-e", "-p", "the cat\\nsat\\t\\x41 \\\"on\\\""],
    "grammar": ["--grammar", 'root ::= [a-z]+ " " [0-9]+'],
    "cfg": ["--cfg-negative-prompt", "a b c", "--cfg-scale", "1.5"],
    "override_kv": ["--override-kv", "llama.rope.freq_base=float:1000000",
                    "--override-kv", "llama.attention.layer_norm_rms_epsilon"
                                     "=float:0.001"],
    "q8_0_cache": ["-ctk", "q8_0", "--keep", "-1", "--verbose-prompt"],
    "sampled": ["--temp", "0.8", "-s", "42", "--repeat-penalty", "1.2"],
    "no_display": ["--no-display-prompt", "-t", "4", "--mlock"],
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_matches_jax(path, case):
    argv = main_argv(path, *MAIN_CASES[case])
    want = run(jmain, argv)
    got = run(main, argv + CPU)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    if case == "q8_0_cache":                  # --verbose-prompt's table
        def table(err):
            return [ln for ln in err.splitlines() if "->" in ln]
        assert table(got[2]) == table(want[2]) and table(got[2])
    assert "eval time" in got[2]              # Timings.report on stderr


def test_main_reverse_prompt(path):
    """-r stops the output right after the first occurrence of the string,
    as in the JAX CLI."""
    _, plain, _ = run(main, main_argv(path, "--no-display-prompt") + CPU)
    gen = plain[:-1]
    rp = gen[3:5]
    argv = main_argv(path, "--no-display-prompt", "-r", rp)
    want = run(jmain, argv)
    got = run(main, argv + CPU)
    assert got[1] == want[1]
    text = got[1][:-1]
    stop = gen.index(rp) + len(rp)
    # the output is the plain run's, cut at the end of the piece that
    # completes the first occurrence (a piece is at most "<extra_NNN>")
    assert gen.startswith(text) and stop <= len(text) < stop + 11
    assert len(text) < len(gen)


@pytest.mark.parametrize("second", ["same", "longer"])
def test_main_prompt_cache(path, tmp_path, second):
    """--prompt-cache twice: the second run reuses the matching prefix
    (reported on stderr) and prints what the JAX CLI prints; the port also
    reads the cache file the JAX CLI wrote, and the reverse."""
    p2 = PROMPT if second == "same" else PROMPT + " and slept"
    outs = {}
    for name, mod, extra in (("jax", jmain, []), ("port", main, CPU)):
        cache = str(tmp_path / f"{name}.bin")
        first = run(mod, main_argv(path, "--prompt-cache", cache) + extra)
        again = run(mod, main_argv(path, "-p", p2, "--prompt-cache", cache)
                    + extra)
        assert "prompt cache: reusing" in again[2]
        outs[name] = (first, again)
    assert outs["port"][0][1] == outs["jax"][0][1]
    assert outs["port"][1][1] == outs["jax"][1][1]
    reuse = [ln for ln in outs["port"][1][2].splitlines() if "reusing" in ln]
    assert reuse == [ln for ln in outs["jax"][1][2].splitlines()
                     if "reusing" in ln]
    # cross: each package continues from the other's file, read-only
    for mod, cache, extra in ((main, "jax.bin", CPU), (jmain, "port.bin", [])):
        cross = run(mod, main_argv(path, "-p", p2, "--prompt-cache",
                                   str(tmp_path / cache),
                                   "--prompt-cache-ro") + extra)
        assert cross[1] == outs["jax"][1][1]


def test_main_interactive(path, monkeypatch):
    """-i reads lines from stdin until an empty line; --in-prefix and
    --in-suffix wrap each."""
    argv = main_argv(path, "-i", "--in-prefix", "Q: ", "--in-suffix", " A:",
                     "-n", "6")
    lines = "the cat\nsat on\n\nnever read\n"
    want = run(jmain, argv, lines, monkeypatch)
    got = run(main, argv + CPU, lines, monkeypatch)
    assert got[1] == want[1]
    assert got[1].count("Q: ") == 2 and "never" not in got[1]


@pytest.mark.parametrize("flag", [["--tp", "2"],
                                  ["--dp", "2"], ["--coordinator", "h:1"],
                                  ["--num-processes", "2"],
                                  ["--process-id", "0"]])
def test_main_refuses_unported(flag, capsys):
    """The mesh and multi-process flags parse; the model file is checked
    before the process joins a process group or loads anything."""
    with pytest.raises(SystemExit):
        main.main(["-m", "no-such-model.gguf", *flag])
    assert "model not found" in capsys.readouterr().err


def test_main_lora(path, tmp_path, monkeypatch):
    """--lora: the JAX CLI's output with an adapter on wq, wv and w_down
    (the JAX side on its numpy quantizers, which the port's codec equals),
    and not the output without it."""
    from tpulamm.quant import native as j_native
    from tpulamm.train.lora import save_lora_gguf
    monkeypatch.setattr(j_native, "get_lib", lambda: None)
    rng = np.random.default_rng(9)
    shapes = {"wq": (256, 256), "wv": (128, 256), "w_down": (256, 512)}
    save_lora_gguf({"r": 4, "alpha": 8, "layers": [
        {k: {"a": rng.normal(0, 0.25, (4, kk)).astype(np.float32),
             "b": rng.normal(0, 0.05, (n, 4)).astype(np.float32)}
         for k, (n, kk) in shapes.items()} for _ in range(2)]},
        str(tmp_path / "ad.gguf"))
    argv = main_argv(path, "--lora", str(tmp_path / "ad.gguf"))
    want = run(jmain, argv)
    got = run(main, argv + CPU)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert got[1] != run(main, main_argv(path) + CPU)[1]


def test_infill(fim_path):
    argv = ["-m", fim_path, "--in-prefix", "the cat ", "--in-suffix",
            " the mat", "-n", "10", "--temp", "0"]
    want = run(jinfill, argv)
    got = run(infill, argv + CPU)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]


def test_beam_search_cli(path):
    argv = ["-m", path, "-p", PROMPT, "-b", "3", "-n", "8", "-c", "64"]
    want = run(jbeam_cli, argv)
    got = run(beam_search, argv + CPU)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]


def _no_rates(text):
    return re.sub(r"\|\s*[0-9.]+ t/s", "| t/s", text)


def test_parallel(path):
    argv = ["-m", path, "-np", "2", "-ns", "3", "-n", "6", "-c", "256",
            "--temp", "0"]
    want = run(jparallel, argv)
    got = run(parallel, argv + CPU)
    assert got[0] == want[0] == 0
    assert _no_rates(got[1]) == _no_rates(want[1])
    assert got[1].count("seq ") == 3


def test_passkey(path):
    """A 2-layer random model misses the key (exit 1, as the JAX CLI); the
    text matches through self-extend (grp_attn_n 4, window 128)."""
    argv = ["-m", path, "--n-junk", "2", "--passkey", "4242", "--pos", "1",
            "-c", "512", "--grp-attn-n", "4", "--grp-attn-w", "128",
            "-n", "8"]
    want = run(jpasskey, argv)
    got = run(passkey, argv + CPU)
    assert got[0] == want[0]
    assert got[1] == want[1]
    head = [ln for ln in got[2].splitlines() if ln.startswith("passkey =")]
    assert head == [ln for ln in want[2].splitlines()
                    if ln.startswith("passkey =")]


def test_save_load_state(path, tmp_path):
    argv = ["-m", path, "-p", PROMPT, "-n", "8"]
    want = run(jsave_load, argv + ["--session", str(tmp_path / "j.bin")])
    got = run(save_load_state, argv + CPU + ["--session",
                                             str(tmp_path / "t.bin")])
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert "OK: continuations match" in got[2]


@pytest.mark.parametrize("pooling", [None, "mean"])
def test_embedding_json(path, pooling):
    argv = ["-m", path, "-p", PROMPT, "-p", "a b c", "--json"]
    if pooling:
        argv += ["--pooling", pooling]
    want = json.loads(run(jembedding, argv)[1])["embeddings"]
    got = json.loads(run(embedding, argv + CPU)[1])["embeddings"]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape == (256,)
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999


def test_batched_against_jax_engine(path):
    """The port's batched prints cur[s] and the block's tokens for each
    sequence; held to the JAX engine's decode_batch_fast at temp 0."""
    from tpulamm.runtime.engine import Engine as JEngine
    np_, n = 3, 8
    rc, out, _ = run(batched, ["-m", path, "-p", "the cat", "-np", str(np_),
                               "-n", str(n), "--temp", "0", "-c", "128"]
                     + CPU)
    assert rc == 0
    je = JEngine(path, n_ctx=128, n_slots=np_)
    toks = je.tokenizer.encode("the cat", add_bos=True)
    logits = je.prefill(0, toks)
    for s in range(1, np_):
        je.seq_cp(0, s)
    cur = {s: int(np.argmax(logits)) for s in range(np_)}
    outs = je.decode_batch_fast(cur, n - 1, temp=0.0, seed=42)
    want = "".join(f"sequence {s}: the cat"
                   f"{je.tokenizer.decode([cur[s]] + outs[s])}\n\n"
                   for s in range(np_))
    assert out == want
    # the JAX CLI itself stops at its undefined name before printing
    with pytest.raises(NameError, match="first"):
        run(jbatched, ["-m", path, "-p", "the cat", "-np", "2", "-n", "4",
                       "--temp", "0", "-c", "128"])
