"""Learned-vs-random OUTPUT-TEXT (decode-KV) pruning on the port: the second
quality gate, ported from the repo's ``run/text_sparse_quality.py`` (numpy
and the port only).

At decode time the output-text predictor decides, per generated token,
whether its K/V persists in the sparse tier. Task (generate-then-restate):
the answer is M filler tokens (M random per sample), then K payload tokens,
a separator, and the K payload tokens RESTATED in order:

    prompt:  <s> Q copy A
    answer:  F1 F6 F2 F4 F1 P3 P0 ; P3 P0 </s>

The restatement is predictable only from the payload tokens' KV. A learned
predictor that keeps payload KV and drops filler KV preserves recall;
random dropping at the same rate loses payload KV and recall collapses.

Training (the port's train step: the T2 Gumbel policy and the mask-ratio
loss) trains the LM dense first, then adds the predictor (prune-in init)
and finetunes, on fresh random batches every step. Evaluation is
teacher-forced through the port's ``prefill`` and one ``decode_step`` per
answer token (``output_text_keep_override`` for the random arm), with
per-sample freezing through ``active``.

Arms: ``dense``, ``learned``, ``random@<learned keep rate>``,
``untrained``. Metrics: recall PPL and greedy accuracy, and payload /
filler KV survival from the post tier's length advances.

    python -m dynamic_llava_tpu_torch.run.text_sparse_quality --device cpu
    python -m dynamic_llava_tpu_torch.run.text_sparse_quality --device cuda --hidden 256

``tests/test_torch_quality_gates.py`` holds the gate's thresholds.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional

import numpy as np
import torch

from ..config import ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig
from ..models import dynamic
from ..multimodal.fusion import plan_batch
from ..train.optimizer import gumbel_tau_schedule, label_params, make_optimizer
from ..train.step import batch_from_plan, make_train_step
from ..weights import init_llava_params, init_predictors, resolve_device
from .sparse_quality import Noise, log_softmax, noise_source, plan_tensors

SPECIALS = "<pad> <s> </s> Q copy A ;".split()
N_PAYLOAD = 8
N_FILLER = 8
PAY0 = len(SPECIALS)
FIL0 = PAY0 + N_PAYLOAD
VOCAB_SIZE = FIL0 + N_FILLER
EOS = 2
SEP = SPECIALS.index(";")
PROMPT = [1, SPECIALS.index("Q"), SPECIALS.index("copy"), SPECIALS.index("A")]


class Corpus:
    """Padded answers plus per-sample category masks. ``answers[i]`` =
    [F b1..bm_i, P a1..ak, SEP, a1..ak, EOS, pad...]; logits[j] predicts
    answers[:, j], and the masks are in those answer coordinates."""

    def __init__(self, answers, lengths, payload_mask, filler_mask, recall_mask, eos_mask):
        self.answers = answers  # [n, T] int64, 0-padded past EOS
        self.lengths = lengths  # [n] true answer length (incl EOS)
        self.payload_mask = payload_mask  # [n, T] original-payload positions
        self.filler_mask = filler_mask  # [n, T] filler positions
        self.recall_mask = recall_mask  # [n, T] restatement positions
        self.eos_mask = eos_mask  # [n, T] the final EOS position


def build_corpus(n: int, k: int, seed: int = 0, m_lo: int = 2, m_hi: int = 8) -> Corpus:
    """n samples of the generate-then-restate task with K payload tokens,
    m ~ U[m_lo, m_hi] fillers BEFORE a contiguous payload block (so the
    fillers carry no information about the restatement), payload values
    distinct within a sample. The same arrays as the JAX harness for a
    seed."""
    rng = np.random.default_rng(seed)
    t_max = m_hi + 2 * k + 2
    answers = np.zeros((n, t_max), np.int64)
    lengths = np.zeros((n,), np.int64)
    payload_mask = np.zeros((n, t_max), bool)
    filler_mask = np.zeros((n, t_max), bool)
    recall_mask = np.zeros((n, t_max), bool)
    eos_mask = np.zeros((n, t_max), bool)
    for i in range(n):
        m = int(rng.integers(m_lo, m_hi + 1))
        pay = rng.permutation(N_PAYLOAD)[:k] + PAY0
        fil = rng.integers(0, N_FILLER, size=m) + FIL0
        row = np.concatenate([fil, pay, [SEP], pay, [EOS]])
        answers[i, : len(row)] = row
        lengths[i] = len(row)
        filler_mask[i, :m] = True
        payload_mask[i, m: m + k] = True
        recall_mask[i, m + k + 1: m + 2 * k + 1] = True
        eos_mask[i, m + 2 * k + 1] = True
    return Corpus(answers, lengths, payload_mask, filler_mask, recall_mask, eos_mask)


def make_cfg(hidden: int, layers: int, sparse_layer: int,
             use_output_text_predictor: bool = True, keep_rate: float = 0.5,
             mask_loss_weight: float = 100.0, heads: int = 4, vision_hidden: int = 16,
             vision_heads: int = 2) -> LlavaConfig:
    """The JAX harness's config; ``heads`` / ``vision_hidden`` /
    ``vision_heads`` set the widths (defaults: the JAX values). The tower
    is made but never run (a text-only task)."""
    return LlavaConfig(
        text=LlamaConfig(
            vocab_size=VOCAB_SIZE, hidden_size=hidden, intermediate_size=hidden * 2,
            num_hidden_layers=layers, num_attention_heads=heads, num_key_value_heads=heads,
        ),
        vision=ClipVisionConfig(
            hidden_size=vision_hidden, intermediate_size=vision_hidden * 2,
            num_hidden_layers=1, num_attention_heads=vision_heads, image_size=28,
            patch_size=14,
        ),
        sparse=SparseConfig(
            d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
            use_vision_predictor=False, use_text_predictor=False,
            use_output_text_predictor=use_output_text_predictor,
            output_text_keep_rate=keep_rate,
            # answers are ~3k+2 tokens: lower the length threshold so T2 applies
            output_text_len_for_training=4,
            use_instruct_predictor=False, sparse_layer=sparse_layer,
            mask_loss_weight=mask_loss_weight,
        ),
    )


def train_lm(cfg: LlavaConfig, k: int, steps: int, batch_size: int = 64, seed: int = 0,
             params=None, log_every: int = 0, lr: float = 3e-3, predictor_lr: float = 3e-3,
             device=None, noise: Noise = None):
    """Train through the port's train step on a FRESH random batch every
    step (with a fixed set this scale memorizes it, and then every token's
    KV predicts the continuation), tau annealed 1.0 -> 0.1. ``params``
    continues from a checkpoint. Returns ``(params, last lm_loss)``."""
    device = resolve_device(device)
    if params is None:
        params = init_llava_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                   device, torch.float32)
    corpus = build_corpus(steps * batch_size, k, seed=seed + 12345)
    prompt = np.asarray(PROMPT, np.int64)
    pad_to = len(PROMPT) + corpus.answers.shape[1]

    def make_plan(lo, hi):
        ids, labs = [], []
        for j in range(lo, hi):
            row = np.concatenate([prompt, corpus.answers[j, : corpus.lengths[j]]])
            lab = row.copy()
            lab[: len(prompt)] = -100
            ids.append(row)
            labs.append(lab)
        return plan_batch(ids, cfg.num_image_tokens, labels_list=labs, pad_to=pad_to)

    opt = make_optimizer(base_lr=lr, predictor_lr=predictor_lr)
    step = make_train_step(cfg, opt, remat=False, labels=label_params(params))
    opt_state = opt.init(params)
    tau_fn = gumbel_tau_schedule(1.0, 0.1, max(steps, 1))
    noise_at = noise_source(seed, device, noise)
    loss = None
    for i in range(steps):
        batch = batch_from_plan(make_plan(i * batch_size, (i + 1) * batch_size), None, device)
        params, opt_state, m = step(params, opt_state, batch, noise_at(i), tau_fn(i))
        if log_every and (i + 1) % log_every == 0:
            extra = ""
            if "output_text_mask_loss" in m:
                extra = f" mask_loss {float(m['output_text_mask_loss']):.4f}"
            print(f"# step {i + 1}: lm_loss {float(m['lm_loss']):.4f} "
                  f"loss {float(m['loss']):.4f}{extra}", file=sys.stderr)
        loss = float(m["lm_loss"])
    return params, loss


@torch.no_grad()
def eval_arm(params, cfg: LlavaConfig, corpus: Corpus, keep_override=None, device=None):
    """Teacher-forced evaluation through ``prefill`` + one ``decode_step`` an
    answer token. ``keep_override``: None (predictor or dense per cfg) or
    a ``[T-1, B]`` 0/1 matrix of per-step keep decisions (the random arm).
    Samples past their answer length are frozen (``active``)."""
    device = resolve_device(device)
    answers = corpus.answers
    b, t = answers.shape
    plan = plan_batch([np.asarray(PROMPT, np.int64)] * b, cfg.num_image_tokens)
    # unbounded post tier: the ablation compares keep DECISIONS, so the
    # capacity force-drop must not differ between arms
    cache = dynamic.make_gen_cache(cfg, b, plan.seq_len, t + 2, torch.float32,
                                   bound_output_budget=False, all_have_image=False,
                                   device=device)
    state, _ = dynamic.prefill(params, cfg, *plan_tensors(plan, device), None, cache)
    ans = torch.from_numpy(answers).to(device)
    post = state.cache.post.num_layers > 0

    def tier_length(st):
        return (st.cache.post if post else st.cache.pre).length[0].cpu().numpy()

    logits = [state.last_logits.float().cpu().numpy()]
    lengths = [tier_length(state)]
    for step_i in range(t - 1):  # each sample's final EOS is never fed
        active = torch.from_numpy(step_i < corpus.lengths - 1).to(device)
        ov = None
        if keep_override is not None:
            ov = torch.as_tensor(np.asarray(keep_override[step_i], np.int32), device=device)
        state = dynamic.decode_step(params, cfg, ans[:, step_i], state, active=active,
                                    output_text_keep_override=ov)
        logits.append(state.last_logits.float().cpu().numpy())
        lengths.append(tier_length(state))
    logits = np.stack(logits)  # [T, B, V]: logits[j] predicts answers[:, j]
    keeps = np.diff(np.stack(lengths), axis=0).T  # [B, T-1] 0/1 persists

    lp = np.transpose(log_softmax(logits), (1, 0, 2))  # [B, T, V]
    nll_all = -np.take_along_axis(lp, answers[..., None], axis=-1)[..., 0]
    rec_and_eos = corpus.recall_mask | corpus.eos_mask
    ppl = math.exp(float(nll_all[rec_and_eos].mean()))
    greedy = np.transpose(logits, (1, 0, 2)).argmax(axis=-1)  # [B, T]
    acc = float((greedy[corpus.recall_mask] == answers[corpus.recall_mask]).mean())
    fed = np.arange(t - 1)[None, :] < (corpus.lengths - 1)[:, None]
    return {
        "recall_ppl": round(ppl, 4),
        "recall_acc": round(acc, 4),
        "payload_kv_kept": round(float(keeps[corpus.payload_mask[:, : t - 1]].mean()), 4),
        "filler_kv_kept": round(float(keeps[corpus.filler_mask[:, : t - 1]].mean()), 4),
        "answer_keep_rate": round(float(keeps[fed].mean()), 4),
    }


def run_all(steps: int, batch: int, holdout: int, hidden: int, layers: int, k: int = 4,
            sparse_layer: int = 0, seed: int = 0, dense_steps: Optional[int] = None,
            log_every: int = 0, keep_rate: float = 0.5, mask_loss_weight: float = 100.0,
            predictor_lr: float = 3e-3, heads: int = 4, vision_hidden: int = 16,
            vision_heads: int = 2, device=None):
    """Both training stages, then every arm. Prints one JSON line an arm and
    a summary; returns ``(rows, gaps)``."""
    device = resolve_device(device)
    widths = dict(heads=heads, vision_hidden=vision_hidden, vision_heads=vision_heads)
    ho = build_corpus(holdout, k, seed=seed)  # disjoint seed stream from training
    cfg = make_cfg(hidden, layers, sparse_layer, keep_rate=keep_rate,
                   mask_loss_weight=mask_loss_weight, **widths)
    dense_cfg = make_cfg(hidden, layers, sparse_layer, use_output_text_predictor=False,
                         **widths)
    dense_steps = steps if dense_steps is None else dense_steps
    params, loss1 = train_lm(dense_cfg, k, dense_steps, batch_size=batch, seed=seed,
                             log_every=log_every, device=device)
    print(f"# stage 1 (dense): {dense_steps} steps, lm_loss {loss1:.4f}", file=sys.stderr)
    params = dict(params)
    # prune-in init: start at keep-everything so the early Gumbel phase
    # cannot push the shared output bias into keep-all saturation
    params["predictors"] = init_predictors(
        cfg, torch.Generator(device=device).manual_seed(seed + 1), device, torch.float32,
        text_keep_bias=3.0)
    params, loss2 = train_lm(cfg, k, steps, batch_size=batch, seed=seed + 1, params=params,
                             log_every=log_every, predictor_lr=predictor_lr, device=device)
    print(f"# stage 2 (sparse finetune): {steps} steps of fresh batch-{batch} data "
          f"({holdout} held out), final lm_loss {loss2:.4f}", file=sys.stderr)

    rows = {"dense": eval_arm(params, dense_cfg, ho, device=device),
            "learned": eval_arm(params, cfg, ho, device=device)}
    # random arm at the learned arm's MEASURED keep rate (matched budget)
    match = rows["learned"]["answer_keep_rate"]
    rng = np.random.default_rng(seed + 7)
    t = ho.answers.shape[1]
    override = (rng.uniform(size=(t - 1, holdout)) < match).astype(np.int32)
    rand_key = f"random@{match:.2f}"
    rows[rand_key] = eval_arm(params, cfg, ho, keep_override=override, device=device)
    # untrained control: fresh init WITHOUT the keep bias
    up = dict(params)
    up["predictors"] = init_predictors(
        cfg, torch.Generator(device=device).manual_seed(seed + 99), device, torch.float32)
    rows["untrained"] = eval_arm(up, cfg, ho, device=device)

    for name, row in rows.items():
        print(json.dumps({"arm": name, **row}), flush=True)
    gaps = {
        "learned_minus_random_acc": round(
            rows["learned"]["recall_acc"] - rows[rand_key]["recall_acc"], 4),
        "dense_minus_learned_acc": round(
            rows["dense"]["recall_acc"] - rows["learned"]["recall_acc"], 4),
    }
    print(json.dumps({"summary": rows, "gaps": gaps}))
    return rows, gaps


def gate_failures(rows, gaps):
    """The thresholds of ``tests/test_sparse_quality_gate.py::
    test_learned_text_pruning_beats_random``; an empty list when they hold."""
    learned = rows["learned"]
    random_ = rows[next(k for k in rows if k.startswith("random@"))]
    checks = [
        (learned["payload_kv_kept"] >= 0.95, "learned payload_kv_kept >= 0.95"),
        (learned["filler_kv_kept"] <= 0.20, "learned filler_kv_kept <= 0.20"),
        (0.35 <= learned["answer_keep_rate"] <= 0.65, "0.35 <= learned answer_keep_rate <= 0.65"),
        (learned["recall_acc"] >= 0.95, "learned recall_acc >= 0.95"),
        (random_["recall_acc"] <= learned["recall_acc"] - 0.30,
         "random recall_acc <= learned - 0.30"),
        (random_["recall_ppl"] >= 5.0 * learned["recall_ppl"], "random ppl >= 5 x learned ppl"),
        (gaps["dense_minus_learned_acc"] <= 0.05, "dense - learned accuracy <= 0.05"),
    ]
    return [what for ok, what in checks if not ok]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=64,
                    help="fresh samples per train step (infinite data)")
    ap.add_argument("--holdout", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vision-hidden", dest="vision_hidden", type=int, default=16)
    ap.add_argument("--vision-heads", dest="vision_heads", type=int, default=2)
    ap.add_argument("--k", type=int, default=2, help="payload tokens per sample")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dense-steps", dest="dense_steps", type=int, default=400)
    ap.add_argument("--log-every", type=int, default=0)
    ap.add_argument("--keep-rate", dest="keep_rate", type=float, default=0.5,
                    help="mask-ratio target")
    ap.add_argument("--mask-loss-weight", dest="mask_loss_weight", type=float, default=100.0)
    ap.add_argument("--predictor-lr", dest="predictor_lr", type=float, default=6e-3)
    ap.add_argument("--sparse-layer", dest="sparse_layer", type=int, default=0,
                    help="pruning boundary; 0 = every layer sees only kept KV")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    run_all(args.steps, args.batch, args.holdout, args.hidden, args.layers, k=args.k,
            sparse_layer=args.sparse_layer, seed=args.seed, dense_steps=args.dense_steps,
            log_every=args.log_every, keep_rate=args.keep_rate,
            mask_loss_weight=args.mask_loss_weight, predictor_lr=args.predictor_lr,
            heads=args.heads, vision_hidden=args.vision_hidden,
            vision_heads=args.vision_heads, device=args.device)


if __name__ == "__main__":
    main()
