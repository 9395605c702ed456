"""Port parity: tpulamm_torch's HTTP server (device="cpu") against the JAX
server, both serving one tiny Q4_0 model with 2 slots at n_ctx 128, f32
compute and cache, driven over loopback HTTP with the same requests in the
same order.

Greedy requests send temperature 0 and repeat_penalty 1.0 (the server's
defaults are 0.8 and 1.1). Tolerances: equal text, usage and counters;
n_probs top ids equal, probabilities within 1e-4; embeddings cosine >=
0.9999 and max |diff| <= 1e-3 of max |v|. Sampled tokens cannot equal the
JAX server's (the draws come from the engine's torch.Generator): a
sampled request is held to its tier and to its seed.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_port_models import write_tiny_llama
from tpulamm.gguf.constants import GGMLType
from tpulamm.server import server as jserver
from tpulamm_torch.server import server as tserver

PROMPTS = ["the cat", "the cat sat on the mat", "a b c"]


def _boot(serve, path, **kw):
    started = threading.Event()
    t = threading.Thread(target=serve, args=(path,), daemon=True,
                         kwargs=dict(host="127.0.0.1", port=0, n_slots=2,
                                     n_ctx=128, started=started,
                                     compute_dtype="float32",
                                     cache_type_k="float32", **kw))
    t.start()
    assert started.wait(timeout=300), "server failed to start"
    return started, f"http://127.0.0.1:{started.httpd.server_port}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX base URL, port base URL, port scheduler, JAX scheduler)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # parallel test workers share the cores
    path = write_tiny_llama(
        str(tmp_path_factory.mktemp("srv") / "q4.gguf"), GGMLType.Q4_0,
        seed=5)
    js, jbase = _boot(jserver.serve, path)
    ts, tbase = _boot(tserver.serve, path, device="cpu")
    yield jbase, tbase, ts.sched, js.sched
    for s in (js, ts):
        s.sched.running = False
        s.httpd.shutdown()
    torch.set_num_threads(n)


def _post(base, path, body, timeout=120):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.read()


def _both(servers, path, body):
    """The same request to the JAX and the port's server -> both bodies
    (each must answer 200)."""
    out = []
    for base in servers[:2]:
        st, raw = _post(base, path, body)
        assert st == 200, raw
        out.append(json.loads(raw))
    return out


def _metrics(base) -> dict:
    text = _get(base, "/metrics").decode()
    return {ln.split()[0].split(":")[1]: float(ln.split()[1])
            for ln in text.splitlines() if ln and not ln.startswith("#")}


def _greedy(**kw):
    return {"temperature": 0.0, "repeat_penalty": 1.0, **kw}


def _stream_text(base, path, body) -> str:
    req = urllib.request.Request(
        base + path, data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        payload = r.read().decode()
    events = [ln[6:] for ln in payload.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    text = ""
    for ev in events[:-1]:
        obj = json.loads(ev)
        if "choices" in obj:
            ch = obj["choices"][0]
            text += ch.get("delta", {}).get("content", ch.get("text", ""))
        else:
            text += obj["content"]
    return text


def test_endpoints_answer_alike(servers):
    jbase, tbase, *_ = servers
    for path in ("/health", "/props", "/slots"):
        assert json.loads(_get(jbase, path)) == json.loads(_get(tbase, path))
    j, t = (json.loads(_get(b, "/v1/models")) for b in (jbase, tbase))
    assert j == t
    for base in (jbase, tbase):
        st, _ = _post(base, "/nowhere", {})
        assert st == 404


@pytest.mark.parametrize("prompt", PROMPTS)
def test_greedy_completion(servers, prompt):
    j, t = _both(servers, "/completion",
                 _greedy(prompt=prompt, n_predict=12))
    assert t == j
    assert t["tokens_predicted"] == 12


def test_greedy_completion_fast_tier(servers):
    """A greedy request decodes in device blocks on both servers."""
    jbase, tbase, *_ = servers
    before = [_metrics(b) for b in (jbase, tbase)]
    j, t = _both(servers, "/completion",
                 _greedy(prompt="the cat", n_predict=20))
    assert t == j
    after = [_metrics(b) for b in (jbase, tbase)]
    for b, a in zip(before, after):
        assert a["decode_fast_blocks_total"] > b["decode_fast_blocks_total"]
        assert a["decode_slow_steps_total"] == b["decode_slow_steps_total"]


def test_openai_completion_and_chat(servers):
    j, t = _both(servers, "/v1/completions",
                 _greedy(prompt="the cat", max_tokens=10))
    assert t == j and t["usage"]["completion_tokens"] == 10
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}]
    j, t = _both(servers, "/v1/chat/completions",
                 _greedy(messages=msgs, max_tokens=10))
    assert t == j
    assert t["choices"][0]["message"]["role"] == "assistant"
    assert t["usage"]["completion_tokens"] == 10


@pytest.mark.parametrize("path,body", [
    ("/completion", _greedy(prompt="the cat", n_predict=10)),
    ("/v1/completions", _greedy(prompt="a b c", max_tokens=10)),
    ("/v1/chat/completions",
     _greedy(messages=[{"role": "user", "content": "hi"}], max_tokens=10)),
])
def test_streamed_chunks_equal_unstreamed(servers, path, body):
    jbase, tbase, *_ = servers
    j, t = _both(servers, path, body)
    assert t == j
    if "choices" in t:
        ch = t["choices"][0]
        want = ch["message"]["content"] if "message" in ch else ch["text"]
    else:
        want = t["content"]
    assert _stream_text(tbase, path, body) == want
    assert _stream_text(jbase, path, body) == want


@pytest.mark.parametrize("body", [
    _greedy(prompt="the cat", n_predict=6, grammar='root ::= [a-z ]+\n'),
    _greedy(prompt="x", n_predict=16,
            grammar='root ::= ("yes" | "no") " " [0-9]+\n'),
    _greedy(prompt="j", n_predict=24, json_schema={
        "type": "object", "properties": {"ok": {"type": "boolean"}},
        "required": ["ok"]}),
])
def test_grammar_and_json_schema(servers, body):
    j, t = _both(servers, "/completion", body)
    assert t == j
    assert t["tokens_predicted"] > 0


def test_response_format_json_schema_chat(servers):
    schema = {"type": "object",
              "properties": {"n": {"type": "integer"}}, "required": ["n"]}
    j, t = _both(servers, "/v1/chat/completions", _greedy(
        messages=[{"role": "user", "content": "j"}], max_tokens=24,
        response_format={"type": "json_schema",
                         "json_schema": {"schema": schema}}))
    assert t == j
    assert t["choices"][0]["message"]["content"].startswith("{")


def test_bad_requests_fail_alone(servers):
    """A malformed grammar or schema fails its request with 400 on both
    servers; /infill on a model without FIM tokens too; the servers go
    on serving."""
    for base in servers[:2]:
        for path, body in (
                ("/completion", {"prompt": "hi", "n_predict": 2,
                                 "grammar": "root = "}),
                ("/completion", {"prompt": "x", "n_predict": 2,
                                 "json_schema": {"type": "frobnicate"}}),
                ("/infill", {"input_prefix": "a", "input_suffix": "b"})):
            st, raw = _post(base, path, body)
            assert st == 400 and "error" in json.loads(raw)
    j, t = _both(servers, "/completion", _greedy(prompt="the", n_predict=4))
    assert t == j


def test_infill(servers):
    """/infill builds <PRE> prefix <SUF> suffix <MID> from the model's FIM
    tokens (injected here into both servers' metadata) and stops at its
    EOT token, as on the JAX server."""
    mds = [s.engine.metadata for s in servers[2:]]
    fim = {"tokenizer.ggml.prefix_token_id": 5,
           "tokenizer.ggml.suffix_token_id": 6,
           "tokenizer.ggml.middle_token_id": 7}
    body = _greedy(input_prefix="the quick", input_suffix="fox", n_predict=6)
    try:
        for md in mds:
            md.update(fim)
        j, t = _both(servers, "/infill", body)
        assert t == j and t["tokens_predicted"] == 6
        j, t = _both(servers, "/infill", dict(body, n_probs=1))
        first = t["completion_probabilities"][0]["probs"][0]["id"]
        for md in mds:
            md["tokenizer.ggml.eot_token_id"] = first
        j, t = _both(servers, "/infill", body)
        assert t == j and t["tokens_predicted"] == 0
    finally:
        for md in mds:
            for k in (*fim, "tokenizer.ggml.eot_token_id"):
                md.pop(k, None)


def test_n_probs(servers):
    j, t = _both(servers, "/completion",
                 _greedy(prompt="the cat", n_predict=5, n_probs=3))
    assert t["content"] == j["content"]
    jp, tp = j["completion_probabilities"], t["completion_probabilities"]
    assert len(tp) == len(jp) == 5
    for a, b in zip(jp, tp):
        assert [q["id"] for q in b["probs"]] == [q["id"] for q in a["probs"]]
        np.testing.assert_allclose([q["prob"] for q in b["probs"]],
                                   [q["prob"] for q in a["probs"]], atol=1e-4)
        assert abs(b["sampled_prob"] - a["sampled_prob"]) <= 1e-4
    j, t = _both(servers, "/v1/completions",
                 _greedy(prompt="the cat", max_tokens=3, logprobs=2))
    jl, tl = j["choices"][0]["logprobs"], t["choices"][0]["logprobs"]
    assert tl["tokens"] == jl["tokens"]
    assert [list(d) for d in tl["top_logprobs"]] == \
        [list(d) for d in jl["top_logprobs"]]


def test_stop_strings(servers):
    jbase, *_ = servers
    full = json.loads(_post(jbase, "/completion", _greedy(
        prompt="the cat", n_predict=10))[1])["content"]
    assert len(full) >= 6
    stop = full[2:6]                   # spans token pieces, held back
    j, t = _both(servers, "/completion",
                 _greedy(prompt="the cat", n_predict=10, stop=[stop]))
    assert t == j and stop not in t["content"]
    assert full.startswith(t["content"]) and len(t["content"]) <= 2
    j, t = _both(servers, "/completion",
                 _greedy(prompt="the cat", n_predict=10, stop=["\x00never"]))
    assert t == j and t["content"] == full


def test_tokenize_detokenize(servers):
    j, t = _both(servers, "/tokenize", {"content": "the cat sat"})
    assert t == j
    j, t = _both(servers, "/detokenize", {"tokens": t["tokens"]})
    assert t == j and "the cat sat" in t["content"]


@pytest.mark.parametrize("path,body", [
    ("/embedding", {"content": "the cat sat on the mat"}),
    ("/v1/embeddings", {"input": ["the cat", "a b c d e f"]}),
])
def test_embeddings(servers, path, body):
    j, t = _both(servers, path, body)
    jv = [j["embedding"]] if "embedding" in j else \
        [d["embedding"] for d in j["data"]]
    tv = [t["embedding"]] if "embedding" in t else \
        [d["embedding"] for d in t["data"]]
    assert len(tv) == len(jv)
    for a, b in zip(jv, tv):
        a, b = np.asarray(a), np.asarray(b)
        assert b.shape == a.shape == (256,)
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos >= 0.9999
        assert np.abs(a - b).max() <= 1e-3 * np.abs(a).max()


def test_cache_prompt(servers):
    jbase, tbase, *_ = servers
    body = _greedy(prompt="the cat sat on the mat and", n_predict=6,
                   cache_prompt=True)
    _both(servers, "/completion", body)
    before = [_metrics(b) for b in (jbase, tbase)]
    j, t = _both(servers, "/completion", body)
    assert t == j
    after = [_metrics(b) for b in (jbase, tbase)]
    d = [{k: a[k] - b[k] for k in ("prompt_cached_tokens_total",
                                    "prompt_tokens_total")}
         for a, b in zip(after, before)]
    assert d[1] == d[0]
    assert d[1]["prompt_cached_tokens_total"] > 0


def test_system_prompt(servers):
    jbase, tbase, *_ = servers
    for base in (jbase, tbase):
        _post(base, "/system_prompt", {"prompt": "the mat was "})
    for base in (jbase, tbase):
        for _ in range(300):
            if json.loads(_get(base, "/props"))["system_prompt"]:
                break
            time.sleep(0.05)
    before = [_metrics(b) for b in (jbase, tbase)]
    j, t = _both(servers, "/completion", _greedy(prompt="red", n_predict=6))
    assert t == j
    after = [_metrics(b) for b in (jbase, tbase)]
    d = [a["prompt_cached_tokens_total"] - b["prompt_cached_tokens_total"]
         for a, b in zip(after, before)]
    assert d[1] == d[0] > 0
    for base in (jbase, tbase):
        _post(base, "/system_prompt", {"prompt": ""})
    for base in (jbase, tbase):
        for _ in range(300):
            if not json.loads(_get(base, "/props"))["system_prompt"]:
                break
            time.sleep(0.05)
        assert json.loads(_get(base, "/props"))["system_prompt"] == ""


def test_concurrent_greedy_requests(servers):
    """Two slots decoding together give each request's text served
    alone."""
    jbase, tbase, *_ = servers
    bodies = [_greedy(prompt=p, n_predict=10) for p in PROMPTS[:2]]
    alone = [_both(servers, "/completion", b)[1] for b in bodies]
    with ThreadPoolExecutor(2) as ex:
        got = list(ex.map(lambda b: json.loads(
            _post(tbase, "/completion", b)[1]), bodies))
    assert got == alone


def test_penalized_greedy_takes_the_sampled_tier(servers):
    """temperature 0 with a repeat penalty runs the device sampler chain
    on both servers and gives the same tokens (no draw is involved); the
    host Sampler (n_probs forces the per-token tier) agrees."""
    jbase, tbase, *_ = servers
    body = {"prompt": "the cat", "n_predict": 16, "temperature": 0.0,
            "repeat_penalty": 1.3, "top_p": 0.9}
    before = [_metrics(b) for b in (jbase, tbase)]
    j, t = _both(servers, "/completion", body)
    assert t == j
    after = [_metrics(b) for b in (jbase, tbase)]
    for b, a in zip(before, after):
        assert a["decode_sampled_blocks_total"] > \
            b["decode_sampled_blocks_total"]
    _, host = _both(servers, "/completion", dict(body, n_probs=1))
    assert host["content"] == t["content"]


def test_sampled_request_repeats_its_seed(servers):
    """A sampled request (temp 0.8, penalties, top_p) takes the sampled
    tier; on the port the same seed gives the same text twice."""
    _, tbase, *_ = servers
    body = {"prompt": "the cat", "n_predict": 16, "temperature": 0.8,
            "repeat_penalty": 1.1, "top_p": 0.9, "seed": 7}
    before = _metrics(tbase)
    a = json.loads(_post(tbase, "/completion", body)[1])
    b = json.loads(_post(tbase, "/completion", body)[1])
    c = json.loads(_post(tbase, "/completion", dict(body, seed=8))[1])
    assert a == b and a["tokens_predicted"] == 16
    assert c["content"] != a["content"]
    after = _metrics(tbase)
    assert after["decode_sampled_blocks_total"] >= \
        before["decode_sampled_blocks_total"] + 3


def test_cancel(servers):
    for base in servers[:2]:
        st, raw = _post(base, "/cancel", {"rid": "nobody"})
        assert st == 404 and json.loads(raw) == {"cancelled": False}
        rid = f"cancel-{base[-5:]}"
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_post, base, "/completion", _greedy(
                prompt="the cat", n_predict=100_000, ignore_eos=True,
                rid=rid), 300)
            ok = False
            for _ in range(600):
                st, raw = _post(base, "/cancel", {"rid": rid})
                if st == 200 and json.loads(raw)["cancelled"]:
                    ok = True
                    break
                time.sleep(0.05)
            assert ok, "request never became cancellable"
            st, raw = fut.result(timeout=120)
        assert st == 200 and json.loads(raw)["stopped_eos"] is False
        assert json.loads(_get(base, "/health"))["slots_idle"] == 2


def test_metrics_tiers(servers):
    """Every decode tier that ran on the JAX server ran on the port's."""
    jbase, tbase, *_ = servers
    j, t = _metrics(jbase), _metrics(tbase)
    for k in ("decode_fast_blocks_total", "decode_sampled_blocks_total",
              "decode_slow_steps_total"):
        assert (t[k] > 0) >= (j[k] > 0), (k, j[k], t[k])
    assert set(t) <= set(j)


@pytest.mark.parametrize("kw", [dict(tp=2), dict(dp=2),
                                dict(broadcast=("127.0.0.1", 9000))])
def test_serve_refuses_unported_tiers(kw):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 14"):
        tserver.serve("no-such-model.gguf", **kw)


@pytest.mark.parametrize("argv", [
    ["--tp", "2"], ["--coordinator", "h:1"], ["--num-processes", "2"],
    ["--broadcast-port", "9"],
])
def test_main_refuses_unported_flags(argv):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 14"):
        tserver.main(["-m", "no-such-model.gguf", *argv])


# -- the speculative tiers (--lookup-decoding, --model-draft) ------------------

SPEC_KEYS = ("spec_blocks_total", "spec_drafted_total", "spec_accepted_total",
             "spec_draft_blocks_total")


@pytest.fixture(scope="module")
def spec_servers(tmp_path_factory):
    """Both servers with --lookup-decoding and a draft model (seed 9) of
    the target's vocabulary: (JAX base, port base, JAX scheduler, port
    scheduler, {"jax": JAX draft engine, "port": port draft engine})."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("spec_srv")
    path = write_tiny_llama(str(d / "q4.gguf"), GGMLType.Q4_0, seed=5)
    draft = write_tiny_llama(str(d / "draft.gguf"), GGMLType.Q4_0, seed=9)
    js, jbase = _boot(jserver.serve, path, lookup_decoding=True,
                      model_draft=draft)
    ts, tbase = _boot(tserver.serve, path, lookup_decoding=True,
                      model_draft=draft, device="cpu")
    drafts = {"jax": js.sched.engine.draft, "port": ts.sched.engine.draft}
    yield jbase, tbase, js.sched, ts.sched, drafts
    for s in (js, ts):
        s.sched.running = False
        s.httpd.shutdown()
    torch.set_num_threads(n)


def _use_draft(spec_servers, on: bool):
    """Attach (on) or detach the draft of both servers while they idle."""
    *_, jsched, tsched, drafts = spec_servers
    for sched, key in ((jsched, "jax"), (tsched, "port")):
        if on:
            sched.engine.attach_draft(drafts[key])
        else:
            sched.engine.draft = None


def _spec_delta(base, body):
    before = _metrics(base)
    st, raw = _post(base, "/completion", body)
    assert st == 200, raw
    after = _metrics(base)
    return json.loads(raw), {k: after[k] - before[k] for k in SPEC_KEYS}


@pytest.mark.parametrize("tier", ["draft", "lookup"])
@pytest.mark.parametrize("prompt", ["the cat sat on the mat", "a b c a b c"])
def test_spec_tier_greedy_matches_jax(spec_servers, tier, prompt):
    """A greedy request alone takes the draft-model tier (draft attached)
    or the single-slot lookup tier: the JAX server's text, and the same
    growth of every llamacpp:spec_* counter."""
    jbase, tbase, *_ = spec_servers
    _use_draft(spec_servers, tier == "draft")
    body = _greedy(prompt=prompt, n_predict=24, ignore_eos=True)
    (j, jd), (t, td) = (_spec_delta(b, body) for b in (jbase, tbase))
    assert t["content"] == j["content"]
    assert t["tokens_predicted"] == j["tokens_predicted"] == 24
    assert td == jd
    assert td["spec_blocks_total"] > 0 and td["spec_drafted_total"] > 0
    assert (td["spec_draft_blocks_total"] > 0) == (tier == "draft")


@pytest.mark.parametrize("tier", ["draft", "lookup"])
def test_spec_tier_sampled(spec_servers, tier):
    """A sampled request alone takes stochastic draft-model speculation or
    the compound lookup verify at temperature: its seed repeats its text,
    and the block counters grow as the JAX server's do (accepted drafts
    depend on the draws)."""
    jbase, tbase, *_ = spec_servers
    _use_draft(spec_servers, tier == "draft")
    body = {"prompt": "the cat", "n_predict": 16, "temperature": 0.8,
            "top_k": 20, "top_p": 1.0, "min_p": 0.0, "repeat_penalty": 1.0,
            "seed": 3, "ignore_eos": True}
    (j, jd), (t, td) = (_spec_delta(b, body) for b in (jbase, tbase))
    t2, _ = _spec_delta(tbase, body)
    assert t2["content"] == t["content"]
    assert t["tokens_predicted"] == j["tokens_predicted"] == 16
    for k in SPEC_KEYS[:2] + SPEC_KEYS[3:]:
        assert (td[k] > 0) == (jd[k] > 0), (k, jd, td)
    assert td["spec_blocks_total"] > 0
