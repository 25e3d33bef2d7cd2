"""Train, then evaluate, on the port: the chain of the repo's
``run/quant_quality.py`` (numpy and the port only).

A small model is trained through the port's train step on a synthetic
POPE-style yes/no corpus whose rule (object identity -> yes/no)
generalizes; it is then generated from through the port's ``Generator``
with full-precision and quantized weights and KV caches, and scored by
the POPE scorer. Per mode: teacher-forced answer PPL through prefill +
decode, POPE accuracy / F1 of greedy generations (training and held-out
pairs), the answer margin, and greedy agreement with the bf16-cache run.

    python -m dynamic_llava_tpu_torch.run.quant_quality --device cpu --steps 150
    python -m dynamic_llava_tpu_torch.run.quant_quality --device cuda --hidden 256

``run_gate`` is the train-then-evaluate gate of
``tests/test_train_eval_gate.py`` (``tests/test_torch_quality_gates.py``).
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import sys

import numpy as np
import torch

from ..config import ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig
from ..eval.eval_pope import score_pope
from ..generation.generate import GenerationConfig, Generator
from ..models import dynamic
from ..multimodal.fusion import plan_batch
from ..ops.quant import quantize_llm_params
from ..train.optimizer import label_params, make_optimizer
from ..train.step import batch_from_plan, make_train_step
from ..weights import init_llava_params, resolve_device
from .sparse_quality import Noise, noise_source, plan_tensors

VOCAB = ("<pad> <s> </s> Q A yes no is there a dog cat tree car red blue big "
         "small on under one two ? .").split()
YES, NO = VOCAB.index("yes"), VOCAB.index("no")


def build_corpus(n_pairs: int, seed: int = 0):
    """POPE-style: 'Q is there a <ctx> <obj> ?' -> yes iff the OBJECT is in
    the yes class; the context word varies, so held-out (context, object)
    pairs test the rule. Deterministic (``seed`` is unused, as in JAX)."""
    objs = [VOCAB.index(w) for w in ("dog", "cat", "tree", "car", "red", "blue", "big", "small")]
    ctxs = [VOCAB.index(w) for w in ("one", "two", "on", "under")]
    prompts, answers, labels_txt = [], [], []
    for i in range(n_pairs):
        obj = objs[i % len(objs)]
        ctx = ctxs[(i // len(objs)) % len(ctxs)]
        q = [1, VOCAB.index("Q"), VOCAB.index("is"), VOCAB.index("there"), VOCAB.index("a"),
             ctx, obj, VOCAB.index("?"), VOCAB.index("A")]
        ans = YES if (i % len(objs)) % 2 == 0 else NO
        prompts.append(np.asarray(q, np.int64))
        answers.append(np.asarray([ans, 2], np.int64))  # answer + </s>
        labels_txt.append("yes" if ans == YES else "no")
    return prompts, answers, labels_txt


def make_cfg(hidden: int = 64, layers: int = 2, heads: int = 4, vision_hidden: int = 32,
             vision_heads: int = 2) -> LlavaConfig:
    """The gate's config (``tests/test_train_eval_gate.py``; the defaults
    are its values): text only, every predictor off."""
    return LlavaConfig(
        text=LlamaConfig(vocab_size=len(VOCAB), hidden_size=hidden,
                         intermediate_size=hidden * 2, num_hidden_layers=layers,
                         num_attention_heads=heads, num_key_value_heads=heads),
        vision=ClipVisionConfig(hidden_size=vision_hidden, intermediate_size=vision_hidden * 2,
                                num_hidden_layers=2, num_attention_heads=vision_heads,
                                image_size=70, patch_size=14),
        sparse=SparseConfig(d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
                            use_vision_predictor=False, use_text_predictor=False,
                            use_output_text_predictor=False, use_instruct_predictor=False),
    )


def train_tiny(cfg: LlavaConfig, prompts, answers, steps: int, seed: int = 0, device=None,
               noise: Noise = None, params=None):
    """``steps`` full-batch steps at lr 3e-3, tau 0.5, no remat. Returns
    ``(params, last lm_loss)``."""
    device = resolve_device(device)
    if params is None:
        params = init_llava_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                   device, torch.float32)
    ids, labels = [], []
    for p, a in zip(prompts, answers):
        row = np.concatenate([p, a])
        lab = row.copy()
        lab[: len(p)] = -100
        ids.append(row)
        labels.append(lab)
    batch = batch_from_plan(plan_batch(ids, 0, labels_list=labels), None, device)
    opt = make_optimizer(base_lr=3e-3, predictor_lr=3e-3)
    step = make_train_step(cfg, opt, remat=False, labels=label_params(params))
    opt_state = opt.init(params)
    noise_at = noise_source(seed, device, noise)
    loss = None
    for i in range(steps):
        params, opt_state, m = step(params, opt_state, batch, noise_at(i), 0.5)
        loss = float(m["lm_loss"])
    return params, loss


def quantize_mode(params, mode: str):
    """A copy of ``params`` with int8 / int4 decoder weights (``mode``
    ``int8`` / ``int4``), or a plain copy."""
    p = copy.deepcopy(params)
    if mode in ("int8", "int4"):
        return quantize_llm_params(p, bits=8 if mode == "int8" else 4)
    return p


@torch.no_grad()
def teacher_forced_ppl(params, cfg: LlavaConfig, prompts, answers, cache_dtype, device=None):
    """Answer-token PPL and the mean answer margin through prefill + decode
    steps, one prompt at a time (the cache dtype is on the measured path)."""
    device = resolve_device(device)
    dtype = getattr(torch, cache_dtype)
    nll, count, margins = 0.0, 0, []
    for p, a in zip(prompts, answers):
        plan = plan_batch([p], 0)
        cache = dynamic.make_gen_cache(cfg, 1, plan.seq_len, len(a) + 2, dtype,
                                       all_have_image=False, device=device)
        state, _ = dynamic.prefill(params, cfg, *plan_tensors(plan, device), None, cache)
        for j, tok in enumerate(a):
            logits = state.last_logits[0].float().cpu().numpy()
            logp = logits - logits.max()
            logp = logp - np.log(np.exp(logp).sum())
            nll -= float(logp[int(tok)])
            count += 1
            if j == 0:
                top2 = np.partition(logits, -2)[-2:]
                margins.append(float(top2[1] - top2[0]))
            state = dynamic.decode_step(
                params, cfg, torch.full((1,), int(tok), dtype=torch.int64, device=device), state)
    return math.exp(nll / max(count, 1)), float(np.mean(margins))


def generate_answers(params, cfg: LlavaConfig, prompts, cache_dtype: str, max_new: int = 3):
    """Greedy answers through the port's ``Generator`` (on the params'
    device), as text."""
    gen = Generator(params, cfg, GenerationConfig(
        max_new_tokens=max_new, eos_token_id=2, cache_dtype=str(cache_dtype),
        decode_chunk=max_new))
    texts = []
    for o in gen.generate(list(prompts)):
        texts.append(" ".join(VOCAB[t] for t in o if 0 <= t < len(VOCAB) and t != 2))
    return texts


def run_gate(steps: int = 40, hidden: int = 64, layers: int = 2, heads: int = 4,
             vision_hidden: int = 32, vision_heads: int = 2, device=None):
    """The chain of ``tests/test_train_eval_gate.py``: train on 16 pairs,
    then POPE of greedy answers with fp32 and with int8 weights (bf16
    cache). Returns ``{"lm_loss", "pope", "pope_int8"}``."""
    cfg = make_cfg(hidden, layers, heads, vision_hidden, vision_heads)
    prompts, answers, labels = build_corpus(16)
    params, loss = train_tiny(cfg, prompts, answers, steps, device=device)
    texts = generate_answers(params, cfg, prompts, "bfloat16")
    pope = score_pope([t or "none" for t in texts], labels)
    texts8 = generate_answers(quantize_mode(params, "int8"), cfg, prompts, "bfloat16")
    pope8 = score_pope([t or "none" for t in texts8], labels)
    return {"lm_loss": loss, "pope": pope, "pope_int8": pope8}


def gate_failures(result):
    """The thresholds of ``tests/test_train_eval_gate.py``; empty when they
    hold."""
    checks = [
        (result["lm_loss"] < 0.1, "lm_loss < 0.1"),
        (result["pope"]["accuracy"] == 1.0 and result["pope"]["f1"] == 1.0,
         "accuracy and f1 == 1.0"),
        (result["pope_int8"]["accuracy"] == 1.0, "int8 accuracy == 1.0"),
    ]
    return [what for ok, what in checks if not ok]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--pairs", type=int, default=16, help="training pairs (contexts 0-1)")
    ap.add_argument("--holdout", type=int, default=16,
                    help="held-out pairs with unseen context words")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    cfg = make_cfg(args.hidden, args.layers, args.heads)
    total = args.pairs + args.holdout
    prompts, answers, labels = build_corpus(total)
    tr, ho = slice(0, args.pairs), slice(args.pairs, total)
    params, loss = train_tiny(cfg, prompts[tr], answers[tr], args.steps, device=args.device)
    print(f"# trained {args.steps} steps on {args.pairs} pairs ({args.holdout} held out), "
          f"final lm_loss {loss:.4f}", file=sys.stderr)
    modes = [("bf16", "bf16", "bfloat16"), ("int8", "int8", "bfloat16"),
             ("int4", "int4", "bfloat16"), ("fp8kv", "bf16", "float8_e4m3fn"),
             ("int8kv", "bf16", "int8")]
    rows, base = {}, None
    for name, wmode, cache_dtype in modes:
        qp = quantize_mode(params, wmode)
        ppl, margin = teacher_forced_ppl(qp, cfg, prompts[ho], answers[ho], cache_dtype,
                                         args.device)
        texts = generate_answers(qp, cfg, prompts, cache_dtype)
        pope_tr = score_pope([t or "none" for t in texts[tr]], labels[tr])
        pope_ho = score_pope([t or "none" for t in texts[ho]], labels[ho])
        base = texts if base is None else base
        rows[name] = {
            "holdout_answer_ppl": round(ppl, 4),
            "holdout_answer_margin": round(margin, 4),
            "pope_accuracy_train": round(pope_tr["accuracy"], 4),
            "pope_accuracy_holdout": round(pope_ho["accuracy"], 4),
            "pope_f1_holdout": round(pope_ho["f1"], 4),
            "greedy_agreement_vs_bf16": round(
                sum(t == b for t, b in zip(texts, base)) / len(texts), 4),
        }
        print(json.dumps({"mode": name, **rows[name]}), flush=True)
    print(json.dumps({"summary": rows}))


if __name__ == "__main__":
    main()
