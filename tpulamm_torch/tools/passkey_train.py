"""Train a small model ON the passkey task, then measure retrieval at 8k
under self-extend (counterpart of tpulamm.tools.passkey_train).

The reference's examples/passkey/passkey.cpp demonstrates retrieval with
big pretrained weights, which are unavailable offline. This tool trains a
~27M byte-level llama from scratch on synthetic passkey documents (exactly
cli/passkey's prompt format, SPM-byte encoded so train and eval tokenize
identically) at n_ctx ~3k, learning the induction behaviour "find 'The
pass key is NNNNN' earlier in context and copy NNNNN after the quiz
question". Evaluation then runs the engine's passkey pipeline — 8k-token
prompts, grouped-attention self-extend compressing effective positions
back inside the trained window (main.cpp:575-598 semantics) — and reports
retrieval accuracy N/M.

    python -m tpulamm_torch.tools.passkey_train --steps 1200
    python -m tpulamm_torch.tools.passkey_train --eval-only \
        -c 8192 --grp-attn-n 4 --grp-attn-w 1024 --trials 10

The control matters: at 8k WITHOUT self-extend the model sees positions
4x past anything it was trained on — `--grp-attn-n 1` gives the broken
baseline that self-extend must beat.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

MODEL = "tmp_bench/passkey30m.gguf"

JUNK = ("The grass is green. The sky is blue. The sun is yellow. "
        "Here we go. There and back again. ")
PREAMBLE = ("There is an important info hidden inside a lot of irrelevant "
            "text. Find it and memorize them. I will quiz you about the "
            "important information there.\n")


def passkey_prompt(n_junk: int, pos: int, passkey: int) -> str:
    """EXACT cli/passkey prompt construction (same strings, same order)."""
    prompt = PREAMBLE
    for i in range(n_junk):
        if i == pos:
            prompt += (f" The pass key is {passkey}. Remember it. "
                       f"{passkey} is the pass key.")
        prompt += JUNK
    prompt += "\n What is the pass key? The pass key is"
    return prompt


def _tokenizer():
    from tpulamm_torch.tokenizer.spm import SPMTokenizer, Vocab
    from tpulamm_torch.tools.quality_table import byte_vocab
    bv = byte_vocab()
    return SPMTokenizer(Vocab(tokens=bv["tokens"], scores=bv["scores"],
                              token_types=bv["token_type"]))


def gen_docs(n_docs: int, seq_len: int, tok, seed: int = 0,
             log=print) -> tuple[np.ndarray, np.ndarray]:
    """(docs, weights): (n_docs, seq_len+1) int32 windows + f32 loss
    weights.

    Each document is a full passkey episode INCLUDING the answer (the
    model must learn to emit the key after 'The pass key is'); short
    documents are front-padded with newlines so the episode's tail
    (question + answer) always sits at the window end. The ANSWER tokens
    carry a 50x loss weight: they are ~10 of ~3000 tokens per window, so
    under uniform weighting the junk-modelling loss drowns the retrieval
    gradient."""
    rng = np.random.default_rng(seed)
    nl = tok.encode("\n", add_bos=False)[-1:]        # newline byte token
    docs = np.zeros((n_docs, seq_len + 1), np.int32)
    wts = np.ones((n_docs, seq_len + 1), np.float32)
    docs[:] = nl[0]
    for d in range(n_docs):
        for _ in range(8):                           # fit attempts
            # one junk sentence ~ 145 byte tokens; 18 junk ~ 2.9k tokens
            n_junk = int(rng.integers(3, 19))
            pos = int(rng.integers(0, n_junk))
            key = int(rng.integers(1, 50000))
            # a SECOND quiz+answer doubles the long-range copy
            # supervision per window (the eval prompt still has one
            # quiz — the trigger string is identical)
            body = passkey_prompt(n_junk, pos, key)
            quiz2 = "\n What is the pass key? The pass key is"
            ans = f" {key}."
            text = body + ans + quiz2 + ans
            ids = tok.encode(text, add_bos=True)
            if len(ids) <= seq_len + 1:
                break
        # answer token spans (byte-fallback SPM is prefix-stable at the
        # space boundary before the answer)
        n0 = len(tok.encode(body, add_bos=True))
        n1 = len(tok.encode(body + ans, add_bos=True))
        n2 = len(tok.encode(body + ans + quiz2, add_bos=True))
        n3 = len(ids)
        w = np.ones(len(ids), np.float32)
        w[n0:n1] = 50.0
        w[n2:n3] = 50.0
        ids = ids[-(seq_len + 1):]
        w = w[-(seq_len + 1):]
        docs[d, seq_len + 1 - len(ids):] = ids
        wts[d, seq_len + 1 - len(ids):] = w
        if d and d % 200 == 0:
            log(f"  gen {d}/{n_docs} docs")
    return docs, wts


def train_passkey(out_path: str = MODEL, *, dim=512, n_layers=8, n_heads=8,
                  n_kv_heads=4, ffn=1408, seq_len=3072, n_steps=3000,
                  batch_size=8, lr=3e-4, n_docs=3200, log=print,
                  device=None) -> str:
    """Train on gen_docs' episodes with the answer-weighted loss and
    gradient checkpointing (remat), AdamW; write the F32 GGUF. device: the
    training's (default "cuda")."""
    from tpulamm_torch.models.config import ModelConfig
    from tpulamm_torch.ops.rope import RopeParams
    from tpulamm_torch.tools.quality_table import byte_vocab
    from tpulamm_torch.train.model import (forward_train, init_params,
                                           save_params_gguf, token_nll)
    from tpulamm_torch.train.train import TrainConfig, optimize

    tok = _tokenizer()
    log(f"generating {n_docs} passkey docs at seq_len {seq_len}...")
    docs, wts = gen_docs(n_docs, seq_len, tok, log=log)

    cfg = ModelConfig(vocab_size=259, dim=dim, n_layers=n_layers,
                      n_heads=n_heads, n_kv_heads=n_kv_heads, ffn_dim=ffn,
                      n_ctx_train=seq_len,
                      rope=RopeParams(n_rot=dim // n_heads))
    params = init_params(cfg, seed=0, device=device)
    tc = TrainConfig(lr=lr, batch_size=batch_size, seq_len=seq_len,
                     n_steps=n_steps, warmup_steps=50, seed=0, remat=True)

    def batches():
        rng = np.random.default_rng(1)
        while True:
            idx = rng.integers(0, len(docs), size=batch_size)
            yield docs[idx], wts[idx]

    def loss_fn(p, batch_w):
        batch, w = batch_w
        nll = token_nll(forward_train(p, cfg, batch, remat=True), batch)
        ww = w[:, 1:]
        return (nll * ww).sum() / ww.sum()

    params, losses = optimize(params, loss_fn, tc, batches(), log_every=50,
                              log=log)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_params_gguf(params, cfg, out_path, vocab=byte_vocab())
    log(f"saved {out_path} (final weighted loss {losses[-1]:.3f})")
    return out_path


def evaluate(model_path: str, *, n_ctx: int, ga_n: int, ga_w: int,
             trials: int, n_junk: int, seed: int = 0,
             pos_frac: float = 1.0, log=print, device=None) -> dict:
    """Retrieval accuracy through the engine (cli/passkey semantics:
    grouped-attention self-extend position surgery during prefill, greedy
    decode of the answer). device: the Engine's (default "cuda")."""
    from tpulamm_torch.runtime.engine import Engine
    from tpulamm_torch.runtime.sampling import SamplingParams

    engine = Engine(model_path, n_ctx=n_ctx, grp_attn_n=ga_n,
                    grp_attn_w=ga_w, device=device)
    rng = np.random.default_rng(seed)
    hits = 0
    for t in range(trials):
        key = int(rng.integers(1, 50000))
        # pos_frac < 1 pins the plant to the EARLY fraction of the junk:
        # late plants sit within the trained relative distance where
        # plain RoPE extrapolation still retrieves — only long-distance
        # plants discriminate self-extend from the broken baseline
        pos = int(rng.integers(0, max(1, int(n_junk * pos_frac))))
        prompt = passkey_prompt(n_junk, pos, key)
        n_tok = len(engine.tokenizer.encode(prompt, special=True))
        engine.reset_slot(0)
        _, text = engine.generate(prompt, n_predict=16, slot=0,
                                  sampling=SamplingParams(temp=0.0),
                                  stop_on_eos=False)
        ok = str(key) in text
        hits += ok
        log(f"  trial {t}: key={key} pos={pos} prompt={n_tok} tok "
            f"-> {'OK' if ok else 'MISS'} ({text[:28]!r})")
    acc = hits / trials
    log(f"retrieval: {hits}/{trials} at n_ctx {n_ctx} "
        f"grp_attn_n {ga_n} grp_attn_w {ga_w}")
    return {"hits": hits, "trials": trials, "acc": acc, "n_ctx": n_ctx,
            "ga_n": ga_n, "ga_w": ga_w, "n_junk": n_junk}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpulamm-torch-passkey-train")
    p.add_argument("-o", "--out", default=MODEL)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--seq-len", type=int, default=3072)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("-c", "--ctx-size", type=int, default=8192)
    p.add_argument("--grp-attn-n", type=int, default=4)
    p.add_argument("--grp-attn-w", type=int, default=1024)
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--n-junk", type=int, default=50,
                   help="junk sentences per eval prompt (50 ~ 7.5k byte "
                        "tokens, the 8k regime; one sentence ~ 145 toks)")
    p.add_argument("--pos-frac", type=float, default=1.0,
                   help="plant the key only in the first FRAC of the "
                        "junk (0.3 = long-distance retrieval only)")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path)")
    args = p.parse_args(argv)

    if not args.eval_only:
        train_passkey(args.out, seq_len=args.seq_len, n_steps=args.steps,
                      batch_size=args.batch_size, device=args.device)
    if args.no_eval:
        return 0
    res = evaluate(args.out, n_ctx=args.ctx_size, ga_n=args.grp_attn_n,
                   ga_w=args.grp_attn_w, trials=args.trials,
                   n_junk=args.n_junk, pos_frac=args.pos_frac,
                   device=args.device)
    if args.json:
        import json
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0 if res["hits"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
