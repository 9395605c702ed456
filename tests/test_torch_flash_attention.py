"""Port parity for ops/flash_attention and the flash dispatch.

- The port's flash_attention_ref against the JAX flash_attention_ref
  within 1e-5 relative (both f32).
- The port's wrappers on CPU tensors (their plain version) against the JAX
  Pallas kernels in interpret mode within 2e-2, the JAX tests' own
  tolerance for bf16 operands (tests/test_flash_attention.py).
- flash_choice against the JAX predicates (transformer.py:169-187,
  :249-259), and the engine handing it the bucketed ubatch length.
- flash_decode's chunk rule (decode_chunking), and a plain torch mirror of
  the decode kernel's two-level split (warps inside a chunk, then chunks)
  against flash_attention_ref and the JAX flash_decode in interpret mode
  on chip_smoke's FLASH_CASES (and FLASH_CASES_256's hd-256 cases, at
  each body's residency), within 2e-2. The kernels themselves are
  checked on the card (tests/test_torch_cuda.py, chip_smoke.py phase 3b).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_models import write_tiny_llama
from chip_smoke import FLASH_CASES, FLASH_CASES_256, flash_case, flash_kw
from tpulamm.ops import flash_attention as JFA
from tpulamm_torch.models import transformer as TT
from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.ops import flash_attention as FA
from tpulamm_torch.runtime.engine import PREFILL_BUCKETS, Engine


def _mk(B=2, Hkv=2, T=8, G=4, S=160, hd=64, seed=0, shift=False, q8=False):
    """tests/test_flash_attention.py::_mk, with optional q8 codes + scales."""
    rng = np.random.default_rng(seed)
    TG = T * G
    a = {"q": rng.normal(size=(B, Hkv, TG, hd)).astype(np.float32),
         "k": rng.normal(size=(B, Hkv, S, hd)).astype(np.float32),
         "v": rng.normal(size=(B, Hkv, S, hd)).astype(np.float32)}
    kpos = np.full((B, S), -1, np.int32)
    for b in range(B):
        used = 24 + 8 * b
        kpos[b, :used] = np.arange(used)
        if shift:
            kpos[b, 5:9] = -1                      # seq_rm hole
            kpos[b, 12:used] -= 3                  # seq_add shift
    a["kpos"] = kpos
    a["qbase"] = np.asarray([24 + 8 * b for b in range(B)], np.int32)
    a["qlen"] = np.full((B,), T, np.int32)
    a["ks"] = a["vs"] = None
    if q8:
        a["k"] = rng.integers(-127, 128, size=(B, Hkv, S, hd)).astype(np.int8)
        a["v"] = rng.integers(-127, 128, size=(B, Hkv, S, hd)).astype(np.int8)
        a["ks"] = rng.uniform(0.005, 0.02, (B, Hkv, S)).astype(np.float32)
        a["vs"] = rng.uniform(0.005, 0.02, (B, Hkv, S)).astype(np.float32)
    return a


_ORDER = ("q", "k", "v", "kpos", "qbase", "qlen", "ks", "vs")


def _jax(a):
    return [None if a[n] is None else jnp.asarray(a[n]) for n in _ORDER]


def _torch(a):
    return [None if a[n] is None else torch.from_numpy(a[n]) for n in _ORDER]


@pytest.mark.parametrize("causal,shift,q8", [
    (True, False, False), (False, False, False), (True, True, False),
    (False, True, False), (True, True, True)])
def test_ref_matches_jax_ref(causal, shift, q8):
    a = _mk(shift=shift, q8=q8)
    kw = dict(scale=0.125, g=4, causal=causal)
    want = np.asarray(JFA.flash_attention_ref(*_jax(a), **kw))
    got = FA.flash_attention_ref(*_torch(a), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# (kwargs of _mk, causal, empty row): the JAX tests' cases
CASES = {
    "causal": (dict(), True, False),
    "noncausal": (dict(), False, False),
    "shift": (dict(shift=True), True, False),
    "noncausal_shift": (dict(shift=True), False, False),
    "q8": (dict(q8=True), True, False),
    "q8_shift": (dict(q8=True, shift=True), True, False),
    "decode_gqa8_q8": (dict(T=1, G=8, S=384, q8=True), True, False),
    "odd_tail": (dict(S=161), True, False),
    "empty_row": (dict(T=1, G=8, S=96), True, True),
    # head dim 256 (Gemma): a prefill, a Gemma-2B-like decode, a ragged tail
    "hd256": (dict(hd=256), True, False),
    "hd256_decode_gqa8_q8": (dict(hd=256, T=1, G=8, S=384, q8=True), True,
                             False),
    "hd256_odd_tail": (dict(hd=256, S=161, shift=True), True, False),
}


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_decode"])
@pytest.mark.parametrize("name", list(CASES))
def test_wrappers_match_jax_kernels(kernel, name):
    mk, causal, empty = CASES[name]
    a = _mk(**mk)
    if empty:
        a["qlen"] = np.asarray([1, 0], np.int32)
    g = a["q"].shape[2] // mk.get("T", 8)
    kw = dict(scale=0.125, g=g, causal=causal)
    jfn = getattr(JFA, kernel)
    # s_chunk 128 gives the JAX kernel several chunks (and a combine) here
    extra = {"s_chunk": 128} if kernel == "flash_decode" else {}
    want = np.asarray(jfn(*_jax(a), interpret=True, **extra, **kw))
    got = getattr(FA, kernel)(*_torch(a), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    if empty:
        assert np.all(got[1] == 0.0)
    assert FA.LAUNCHES == {"flash_attention": 0, "flash_decode": 0}


def test_wrappers_refuse_head_dim():
    a = _mk(hd=96)
    with pytest.raises(ValueError, match="head_dim 96"):
        FA.flash_attention(*_torch(a), scale=0.1, g=4)


def _cfg(n_heads=32, n_kv=32, hd=128, **kw):
    return ModelConfig(dim=n_heads * hd, n_layers=1, n_heads=n_heads,
                       n_kv_heads=n_kv, ffn_dim=4 * n_heads * hd,
                       vocab_size=32000, **kw)


def _jax_choice(cfg, T, S, on_tpu=True):
    """transformer.py:169-187 and :249-259 as written, with no segment
    mask and no TPULAMM_FLASH_DECODE override."""
    group = cfg.n_heads // cfg.n_kv_heads
    hd = cfg.head_dim
    small_q = T * group < 64
    fd_auto = on_tpu and small_q and (S >= 8192 or (S >= 6144 and T * group >= 8))
    fd_on = (small_q and cfg.max_alibi_bias == 0.0 and hd in (64, 128, 256)
             and (cfg.flash_attn if cfg.flash_attn is not None else fd_auto))
    auto = fd_on or (on_tpu and ((T >= 64 and S >= 1024)
                                 or (S >= 6144 and T * group >= 8)))
    use_flash = (cfg.max_alibi_bias == 0.0 and hd in (64, 128, 256)
                 and (cfg.flash_attn if cfg.flash_attn is not None else auto))
    if not use_flash:
        return None
    return "flash_decode" if (fd_on or small_q) else "flash_attention"


# (config kwargs, T, span, expected on the accelerator)
TABLE = [
    (dict(), 1, 2048, None), (dict(), 1, 6144, None),
    (dict(), 1, 8192, "flash_decode"), (dict(), 1, 16385, "flash_decode"),
    (dict(), 8, 6144, "flash_decode"), (dict(), 8, 4096, None),
    (dict(), 64, 512, None), (dict(), 64, 1024, "flash_attention"),
    (dict(), 40, 2048, None), (dict(), 40, 8192, "flash_decode"),
    (dict(), 512, 16385, "flash_attention"), (dict(), 32, 6144, "flash_decode"),
    (dict(n_kv=4), 1, 6144, "flash_decode"), (dict(n_kv=4), 8, 6144,
                                               "flash_attention"),
    (dict(n_kv=4), 1, 1024, None), (dict(n_kv=4), 16, 1024, None),
    (dict(n_kv=4), 64, 1024, "flash_attention"),
    (dict(flash_attn=True), 1, 256, "flash_decode"),
    (dict(flash_attn=True), 64, 256, "flash_attention"),
    (dict(flash_attn=False), 512, 16385, None),
    (dict(flash_attn=False), 1, 16385, None),
    (dict(max_alibi_bias=8.0), 512, 16385, None),
    (dict(hd=96, n_heads=32), 512, 16385, None),
    (dict(hd=96, n_heads=32, flash_attn=True), 1, 256, None),
]


@pytest.mark.parametrize("kw,T,span,want", TABLE)
def test_flash_choice_table(kw, T, span, want):
    kw = dict(kw)
    n_kv = kw.pop("n_kv", 32)
    hd = kw.pop("hd", 128)
    n_heads = kw.pop("n_heads", 32)
    cfg = _cfg(n_heads=n_heads, n_kv=n_kv, hd=hd, **kw)
    assert TT.flash_choice(cfg, T, span, on_cuda=True) == want
    assert _jax_choice(cfg, T, span) == want
    off = TT.flash_choice(cfg, T, span, on_cuda=False)
    assert off == _jax_choice(cfg, T, span, on_tpu=False)


def test_prefill_hands_flash_choice_the_bucket(tmp_path, monkeypatch):
    """A 40-token ubatch runs at its exact length but the flash predicate
    sees the bucket the JAX engine pads it to (64): at span 2048 that picks
    flash_attention, not the einsum, and at span 8192 flash_attention, not
    flash_decode (G = 1)."""
    path = write_tiny_llama(str(tmp_path / "m.gguf"))
    eng = Engine(path, n_ctx=64, compute_dtype="float32",
                 kv_dtype=torch.float32, device="cpu")
    seen = []
    real = TT.flash_choice

    def recorder(cfg, T, span, on_cuda):
        seen.append(T)
        return real(cfg, T, span, on_cuda)
    monkeypatch.setattr(TT, "flash_choice", recorder)
    eng.prefill(0, list(range(3, 43)))
    assert seen == [64] * eng.cfg.n_layers
    assert 64 in PREFILL_BUCKETS
    mha = _cfg()
    assert TT.flash_choice(mha, 64, 2048, True) == "flash_attention"
    assert TT.flash_choice(mha, 40, 2048, True) is None
    assert TT.flash_choice(mha, 64, 8192, True) == "flash_attention"
    assert TT.flash_choice(mha, 40, 8192, True) == "flash_decode"
    seen.clear()
    eng.decode_one(0, 5)
    assert seen == [1] * eng.cfg.n_layers


def test_n_ubatch_past_largest_bucket_raises(tmp_path):
    path = write_tiny_llama(str(tmp_path / "m.gguf"))
    with pytest.raises(ValueError, match="largest prefill bucket"):
        Engine(path, n_ctx=64, n_ubatch=PREFILL_BUCKETS[-1] + 1,
               device="cpu")


def test_one_slot_step_reads_cache_views(tmp_path, monkeypatch):
    """With several slots, a one-slot prefill or decode hands the flash
    wrapper views of that slot's cache rows (no copy of the buffer), and
    gives the logits of a one-slot engine."""
    path = write_tiny_llama(str(tmp_path / "m.gguf"))
    toks = list(range(3, 43))
    shared = []
    real = FA.flash_attention_ref

    def recorder(q, k, v, kpos, qbase, qlen, ks=None, vs=None, **kw):
        bufs = (eng.cache.k, eng.cache.v, eng.cache.ks, eng.cache.vs)
        shared.append(all(
            t.untyped_storage().data_ptr()
            in {b.untyped_storage().data_ptr() for b in buf}
            for t, buf in zip((k, v, ks, vs), bufs))
            and kpos.untyped_storage().data_ptr()
            == eng.cache.pos.untyped_storage().data_ptr())
        return real(q, k, v, kpos, qbase, qlen, ks, vs, **kw)
    monkeypatch.setattr(FA, "flash_attention_ref", recorder)
    outs = []
    for n_slots, slot in ((1, 0), (3, 2)):
        eng = Engine(path, n_ctx=64, n_slots=n_slots, n_ubatch=16,
                     compute_dtype="float32", kv_dtype="q8_0",
                     flash_attn=True, device="cpu")
        lg = eng.prefill(slot, toks)
        outs.append(np.concatenate([lg[None], eng.decode_one(slot, 7)[None]]))
        assert int((eng.cache.pos[slot] >= 0).sum()) == 41
    # 2 engines x (3 ubatches + 1 decode step) x 2 layers
    assert shared == [True] * 16
    np.testing.assert_array_equal(outs[1], outs[0])


def test_forward_flash_matches_einsum_cpu(tmp_path, monkeypatch):
    """Engine(flash_attn=True) on the CPU runs the plain flash version
    through the transformer (reshapes, qbase/qlen, span views, q8 scales)
    for every prefill ubatch and decode step, and agrees with the einsum
    path (flash_attn=None on the CPU) to f32 rounding."""
    path = write_tiny_llama(str(tmp_path / "m.gguf"))
    toks = list(range(3, 43))
    calls = []
    real = FA.flash_attention_ref

    def counting(*a, **kw):
        calls.append(a[0].shape[2])
        return real(*a, **kw)
    monkeypatch.setattr(FA, "flash_attention_ref", counting)
    outs, n_calls = [], []
    for fa in (None, True):
        eng = Engine(path, n_ctx=64, n_ubatch=16, compute_dtype="float32",
                     kv_dtype="q8_0", flash_attn=fa, device="cpu")
        assert eng.cfg.flash_attn is fa
        lg = eng.prefill(0, toks, logits_all=True)
        outs.append(np.concatenate([lg, eng.decode_one(0, 7)[None]]))
        n_calls.append(len(calls))
    # 3 ubatches + 1 decode step, 2 layers; query rows T * G (G = 2)
    assert n_calls == [0, 8]
    assert calls == [32, 32, 32, 32, 16, 16, 2, 2]
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4,
                               atol=1e-4 * np.abs(outs[0]).max())


# -- flash_decode's split: the chunk rule and a mirror of the kernel -------

@pytest.mark.parametrize("S,B,Hkv,TG", [
    (161, 1, 32, 1), (8193, 1, 32, 1), (16385, 1, 32, 1), (16385, 1, 32, 8),
    (8193, 2, 4, 56), (16385, 4, 32, 1), (161, 2, 2, 280), (1, 1, 1, 1)])
def test_decode_chunking(S, B, Hkv, TG):
    """At each decode body's residency (DESIGN_RESIDENCY): chunks are whole
    key tiles, cover every key once, none but the last is shorter than its
    head dim's DECODE_MIN_CHUNK, and the grid is at most one wave of
    resident blocks (where the (b, h, rows) groups fit one) and at least
    one block an SM (where there are chunks of DECODE_MIN_CHUNK keys to
    split; at one block an SM, more than half of that)."""
    sms = 132
    groups = B * Hkv * -(-TG // FA.DECODE_ROWS)
    for (hd, _), res in FA.DESIGN_RESIDENCY.items():
        least = FA.DECODE_MIN_CHUNK[hd]
        chunk, ns = FA.decode_chunking(S, B, Hkv, TG, sms, res, hd)
        assert chunk % FA.DECODE_KEY_TILE == 0 and chunk > 0
        assert (ns - 1) * chunk < S <= ns * chunk
        grid = groups * ns
        if groups <= res * sms:
            assert grid <= res * sms
        floor = min(sms, groups * -(-S // least))
        if res > 1:
            assert grid >= floor
        else:
            assert 2 * grid > floor
        assert ns == 1 or chunk >= least


def test_decode_min_chunk_is_one_key_tile_below_hd_256():
    """Below head dim 256 a chunk may be one key tile, so the grid is the
    same as with no least chunk: the S-8193 decode of G 8 over 8 KV heads
    in 49 chunks of 176 keys, one KV head in 257 of 32 (int8 at hd 128,
    three blocks an SM)."""
    assert FA.DECODE_MIN_CHUNK[64] == FA.DECODE_MIN_CHUNK[128] \
        == FA.DECODE_KEY_TILE
    assert FA.decode_chunking(8193, 1, 8, 8, 132, 3, 128) == (176, 47)
    assert FA.decode_chunking(8193, 1, 1, 8, 132, 3, 128) == (32, 257)


@pytest.mark.parametrize("hd,q8", list(FA.DESIGN_RESIDENCY))
@pytest.mark.parametrize("S,B,Hkv,TG", [(8193, 1, 16, 1), (8193, 1, 1, 8),
                                        (16385, 1, 32, 1), (8193, 4, 16, 1)])
def test_decode_chunking_per_head_dim(hd, q8, S, B, Hkv, TG):
    """At each decode body's residency (one block an SM for bf16 at hd 256,
    two for int8; two for bf16 at hd 128, three elsewhere) the grid is at
    most one wave of resident blocks and more than half of one (or of the
    chunks of DECODE_MIN_CHUNK keys), and covers every key once;
    Gemma-7B's decode at hd 256 in bf16 (16 KV heads) is 8 chunks of 1,040
    keys, 128 blocks, and Gemma-2B's (one KV head) 33 of 256."""
    sms, res = 132, FA.DESIGN_RESIDENCY[hd, q8]
    chunk, ns = FA.decode_chunking(S, B, Hkv, TG, sms, res, hd)
    assert chunk % FA.DECODE_KEY_TILE == 0
    assert (ns - 1) * chunk < S <= ns * chunk
    groups = B * Hkv * -(-TG // FA.DECODE_ROWS)
    assert groups * ns <= max(res * sms, groups)
    assert 2 * groups * ns > min(res * sms,
                                 groups * -(-S // FA.DECODE_MIN_CHUNK[hd]))
    if (hd, q8, S, B, Hkv, TG) == (256, False, 8193, 1, 16, 1):
        assert (chunk, ns) == (1040, 8)
    if (hd, S, B, Hkv, TG) == (256, 8193, 1, 1, 8):
        assert (chunk, ns) == (256, 33)


@pytest.mark.parametrize("S,B,Hkv,TG,want", [
    (8193, 1, 16, 512, 2), (8193, 1, 1, 4096, 4), (16385, 1, 32, 512, 1),
    (16385, 2, 2, 100, 16), (1024, 1, 2, 512, 1), (8193, 1, 32, 64, 4)])
def test_prefill_parts(S, B, Hkv, TG, want):
    """flash_attention's parts: Gemma-7B's 512-token ubatch (64 row blocks)
    in 2, Gemma-2B's (one KV head, G 8: 32 row blocks) in 4; the hd-128
    16k ubatch (128 row blocks) whole; never more blocks than SMs, never a
    part of fewer than PREFILL_MIN_PART keys of the span."""
    parts = FA.prefill_parts(S, B, Hkv, TG, 132)
    assert parts == want
    assert parts == 1 or (B * Hkv * -(-TG // FA.PREFILL_ROWS) * parts <= 132
                          and S // parts >= FA.PREFILL_MIN_PART)


def test_decode_chunking_trash_cell_chunk():
    """S = n_ctx + 1 may leave the trash cell alone in the last chunk."""
    chunk, ns = FA.decode_chunking(16385, 1, 12, 1, 132,
                                   FA.DESIGN_RESIDENCY[128, True], 128)
    assert (chunk, ns) == (512, 33)
    assert 16385 - (ns - 1) * chunk == 1


LOG2E = 1.4426950408889634


def _decode_mirror(q, k, v, kpos, qbase, qlen, ks, vs, *, scale, g,
                   causal=True, sms=132):
    """decode_kernel's arithmetic in plain torch: base-2 scores on bf16 q
    and K (int8 codes as they are), chunks from decode_chunking at the
    body's residency (DESIGN_RESIDENCY: at hd 256 one block an SM for bf16
    K/V, two for int8, so fewer and longer chunks than at hd 128); inside a
    chunk, the m16 row tile of each row and the warps that split its keys
    (16-key sub-tile u of every 64-key tile goes to split u % nsplit: the
    same at every head dim, hd 256 reading its q fragments and K / V runs
    piecewise for the same products), each warp's (acc, m, l) with p
    rounded to bf16 after the vs fold; then the warps folded in split
    order, then the chunks in chunk order."""
    B, H, TG, hd = q.shape
    S = k.shape[2]
    chunk, ns = FA.decode_chunking(
        S, B, H, TG, sms, FA.DESIGN_RESIDENCY[hd, k.dtype == torch.int8], hd)
    bf = lambda x: x.to(torch.bfloat16).to(torch.float32)     # noqa: E731
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("bhrd,bhsd->bhrs", bf(q), kf) * (scale * LOG2E)
    if ks is not None:
        s = s * ks[:, :, None, :]
    live = (kpos >= 0)[:, None, None, :]
    if causal:
        t = torch.arange(TG) // g
        qpos = qbase[:, None].to(torch.int64) + t[None, :]
        live = live & (kpos[:, None, None, :] <= qpos[:, None, :, None])
        live = live & (t[None, None, :, None]
                       < qlen.to(torch.int64)[:, None, None, None])
    s = torch.where(live, s, -torch.inf)
    row = torch.arange(TG)
    nrows = torch.clamp(TG - (row // 64) * 64, max=64)
    n_rt = (nrows + 15) // 16
    nsplit = (3 - (row % 64) // 16) // n_rt + 1
    sub = (torch.arange(S) % chunk % 64) // 16
    m_c = torch.full((B, H, ns, TG), -torch.inf)
    l_c = torch.zeros((B, H, ns, TG))
    acc_c = torch.zeros((B, H, ns, TG, hd))
    for c in range(ns):
        keys = torch.arange(c * chunk, min(S, (c + 1) * chunk))
        for nsp in sorted(set(nsplit.tolist())):
            rows = torch.nonzero(nsplit == nsp)[:, 0]
            mx = torch.full((B, H, len(rows)), -torch.inf)
            parts = []
            for sp in range(nsp):
                kk = keys[sub[keys] % nsp == sp]
                ss = s[:, :, rows][..., kk]
                m = (ss.amax(-1) if len(kk) else
                     torch.full((B, H, len(rows)), -torch.inf))
                p = torch.exp2(ss - torch.where(m == -torch.inf, 0.0,
                                                m)[..., None])
                pv = p * vs[:, :, None, kk] if vs is not None else p
                parts.append((m, p.sum(-1), torch.einsum(
                    "bhrs,bhsd->bhrd", bf(pv), vf[:, :, kk])))
                mx = torch.maximum(mx, m)
            acc = torch.zeros((B, H, len(rows), hd))
            lsum = torch.zeros((B, H, len(rows)))
            for m, l, a in parts:                       # split order
                w = torch.where(mx == -torch.inf, 0.0, torch.exp2(m - mx))
                acc = acc + w[..., None] * a
                lsum = lsum + w * l
            m_c[:, :, c, rows] = mx
            l_c[:, :, c, rows] = lsum
            acc_c[:, :, c, rows] = acc
    m_c = torch.where(m_c == -torch.inf, FA.NEG_INF, m_c)   # dead chunks
    w = torch.exp2(m_c - m_c.amax(2, keepdim=True))
    lg = (w * l_c).sum(2)
    o = (w[..., None] * acc_c).sum(2)
    return torch.where(lg[..., None] > 0, o / lg[..., None], 0.0)


# FLASH_CASES_256's hd-256 cases that run here in seconds (S <= 2049, or
# one KV head): a first ubatch, the sharp one, 28 rows at odd S,
# non-causal, the Gemma-2B decode
_MIRROR_256 = [0, 4, 7, 8, 9]


@pytest.mark.parametrize("i", list(range(len(FLASH_CASES)))
                         + [f"256-{j}" for j in _MIRROR_256])
def test_decode_mirror_matches_ref_and_jax(i):
    """The mirror of the kernel's two-level split against the port's
    flash_attention_ref and the JAX flash_decode (interpret mode) on the
    chip_smoke FLASH_CASES and hd-256 cases of FLASH_CASES_256, within
    2e-2 as the wrapper tests; rows with qlen 0 are exactly 0."""
    if isinstance(i, str):
        j = int(i.split("-")[1])
        case, seed = FLASH_CASES_256[j], 300 + j
    else:
        case, seed = FLASH_CASES[i], 100 + i
    c = flash_case(np.random.default_rng(seed), torch.device("cpu"), **case)
    args = [c[n] for n in _ORDER]
    kw = flash_kw(case)
    got = _decode_mirror(*args, **kw)
    want = FA.flash_attention_ref(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)
    jargs = [None if t is None else jnp.asarray(
        t.to(torch.float32).numpy() if t.dtype == torch.bfloat16
        else t.numpy()) for t in args]
    jwant = np.asarray(JFA.flash_decode(*jargs, interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), jwant, rtol=2e-2, atol=2e-2)
    for b in range(got.shape[0]):
        if int(c["qlen"][b]) == 0:
            assert bool((got[b] == 0).all())


def test_flash_cases_hold_a_dead_chunk():
    """Some FLASH_CASES chunk of decode_chunking has no live key, so the
    mirror test runs the combine's dead-chunk weight."""
    dead = False
    for i, case in enumerate(FLASH_CASES):
        c = flash_case(np.random.default_rng(100 + i), torch.device("cpu"),
                       **case)
        B, Hkv, TG, hd = c["q"].shape
        S = c["k"].shape[2]
        chunk, ns = FA.decode_chunking(
            S, B, Hkv, TG, 132,
            FA.DESIGN_RESIDENCY[hd, c["k"].dtype == torch.int8], hd)
        kp = c["kpos"].numpy()
        dead |= any((kp[b, j * chunk:(j + 1) * chunk] < 0).all()
                    for b in range(B) for j in range(ns))
    assert dead


def test_sharp_case_miss_is_the_reference_rounding():
    """chip_smoke's sharp bf16 case (hd 128, T 64, S 2049, q scaled by 4)
    misses TOL_FLASH against the f32 reference on some draws: q's rounding
    to bf16 alone does (the plain version on bf16 q, seeds 0-19), and so
    do the JAX kernels, which round q to bf16 by design
    (tpulamm/ops/flash_attention.py:64), on the first such draw; they stay
    within TOL_FLASH_REL of the plain version on bf16 q, the check the
    card's kernels are held to as well."""
    from chip_smoke import TOL_FLASH, TOL_FLASH_REL, flash_refs
    case = FLASH_CASES[7]
    assert case.get("sharp") and case["kind"] == "bf16" and case["hd"] == 128
    kw = flash_kw(case)

    def misses(got, ref):
        return bool(((got - ref).abs() > TOL_FLASH * (1 + ref.abs())).any())
    for seed in range(20):
        c = flash_case(np.random.default_rng(seed), torch.device("cpu"),
                       **case)
        ref, ref_q = flash_refs(c, kw)
        if misses(ref_q, ref):
            break
    else:
        pytest.fail("no draw of the sharp case misses TOL_FLASH")
    jargs = [None if c[n] is None else jnp.asarray(
        c[n].to(torch.float32).numpy() if c[n].dtype == torch.bfloat16
        else c[n].numpy()) for n in _ORDER]
    for fn in (JFA.flash_attention, JFA.flash_decode):
        got = torch.from_numpy(np.asarray(fn(*jargs, interpret=True, **kw)))
        assert misses(got, ref)
        assert float((got - ref_q).abs().max()) <= (
            TOL_FLASH_REL * float(ref_q.abs().max()))
