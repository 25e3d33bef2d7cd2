"""Learned-vs-random vision-token pruning on the port: the method's quality
gate, ported from the repo's ``run/sparse_quality.py`` (numpy and the port
only).

Task: a 5x5-patch image is noise except ONE signal patch (position random
per sample) carrying one of two class patterns, plus same-amplitude
distractor patches; the question is fixed and the yes/no answer is the
signal patch's class. A trained vision predictor must keep the signal
patch at keep rate 0.2 (5 of 25 tokens); random pruning keeps it with
probability ~0.2, so held-out accuracy separates the two.

Training runs through the port's train step (Gumbel policy attention and
the mask-ratio loss, ``train.step.make_train_step`` + ``GroupedAdamW``) in
two stages: dense until the model reads the image, then with the
predictors. Evaluation runs the port's ``prefill`` (top-k, compaction;
``vision_score_override`` for the random arms) and one ``decode_step``.

Arms, on held-out samples: ``dense`` (no pruning), ``learned@r`` and
``random@r`` for r in {0.2, 0.5}, ``untrained@0.2`` (fresh predictor).
Metrics: teacher-forced answer PPL, greedy-answer POPE accuracy / F1,
answer margin, and the share of samples whose signal patch survived.

    python -m dynamic_llava_tpu_torch.run.sparse_quality --device cpu
    python -m dynamic_llava_tpu_torch.run.sparse_quality --device cuda \\
        --hidden 256 --vision-hidden 128      # head_dim 64: the kernels' width

``tests/test_torch_quality_gates.py`` holds the gate's thresholds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Callable, Optional

import numpy as np
import torch

from ..config import ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig
from ..eval.eval_pope import score_pope
from ..models import dynamic
from ..multimodal.fusion import plan_batch
from ..train.optimizer import label_params, make_optimizer
from ..train.step import batch_from_plan, make_train_step
from ..weights import init_llava_params, init_predictors, resolve_device

VOCAB = "<pad> <s> </s> Q A yes no is there a signal ? .".split()
YES, NO = VOCAB.index("yes"), VOCAB.index("no")
EOS = 2

Noise = Optional[Callable[[int], object]]


def build_corpus(n: int, image_size: int, patch: int, seed: int = 0,
                 noise: float = 0.5, amp: float = 2.5, distractors: int = 6):
    """n samples: image noise everywhere except ONE signal patch (whose
    class pattern decides the yes/no answer) plus ``distractors``
    same-amplitude random-pattern patches, so that only the patch's
    CONTENT identifies the signal. The same arrays as the JAX harness for
    a seed (one numpy generator, the same draws in the same order)."""
    rng = np.random.default_rng(seed)
    g = image_size // patch
    n_patches = g * g
    pat = rng.normal(size=(2, patch, patch, 3)).astype(np.float32)
    pat = amp * pat / np.abs(pat).max(axis=(1, 2, 3), keepdims=True)

    q = [1, VOCAB.index("Q"), VOCAB.index("is"), VOCAB.index("there"),
         VOCAB.index("a"), -200, VOCAB.index("signal"), VOCAB.index("?"),
         VOCAB.index("A")]
    prompts, answers, imgs, sig_pos, labels_txt = [], [], [], [], []
    for i in range(n):
        cls = i % 2
        perm = rng.permutation(n_patches)
        pos = int(perm[0])
        img = rng.normal(scale=noise, size=(image_size, image_size, 3)).astype(np.float32)

        def put(p, tile):
            r, c = divmod(int(p), g)
            img[r * patch:(r + 1) * patch, c * patch:(c + 1) * patch, :] = tile

        put(pos, pat[cls] + rng.normal(scale=0.1, size=(patch, patch, 3)))
        for p in perm[1:1 + distractors]:
            d = rng.normal(size=(patch, patch, 3)).astype(np.float32)
            put(p, amp * d / np.abs(d).max())
        prompts.append(np.asarray(q, np.int64))
        ans = YES if cls == 0 else NO
        answers.append(np.asarray([ans, EOS], np.int64))
        imgs.append(img)
        sig_pos.append(pos)
        labels_txt.append("yes" if ans == YES else "no")
    return (prompts, answers, np.stack(imgs), np.asarray(sig_pos), labels_txt)


def noise_source(seed: int, device, noise: Noise) -> Callable[[int], object]:
    """Step i's Gumbel noise: ``noise(i)`` when given (the uniform tensors
    of ``forward_train``), else one ``torch.Generator`` for the run."""
    if noise is not None:
        return noise
    gen = torch.Generator(device=device).manual_seed(100 + seed)
    return lambda i: gen


def train_sparse(cfg: LlavaConfig, prompts, answers, imgs, steps: int, seed: int = 0,
                 log_every: int = 0, params=None, device=None, noise: Noise = None):
    """Train through the port's train step (Gumbel policy + mask-ratio loss
    when predictors are on), lr 3e-3 for every group, tau 0.5, no remat.
    ``params`` continues from a checkpoint (the sparse stage finetunes a
    dense model). Returns ``(params, last lm_loss)``; ``params`` are
    updated in place."""
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
    plan = plan_batch(ids, cfg.num_image_tokens, labels_list=labels)
    batch = batch_from_plan(plan, imgs, device)
    opt = make_optimizer(base_lr=3e-3, predictor_lr=3e-3)
    step = make_train_step(cfg, opt, remat=False, labels=label_params(params))
    opt_state = opt.init(params)
    noise_at = noise_source(seed, device, noise)
    loss = None
    for i in range(steps):
        params, opt_state, m = step(params, opt_state, batch, noise_at(i), 0.5)
        if log_every and (i + 1) % log_every == 0:
            print(f"# step {i + 1}: lm_loss {float(m['lm_loss']):.4f} "
                  f"loss {float(m['loss']):.4f}", file=sys.stderr)
        loss = float(m["lm_loss"])
    return params, loss


def plan_tensors(plan, device):
    """The plan arrays ``dynamic.prefill`` takes, as tensors on ``device``."""
    i32 = torch.int32
    sp = plan.spans

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return (t(plan.token_ids, i32), t(plan.is_image), t(plan.image_slot, i32),
            t(plan.valid_len, i32), t(sp.image_start, i32), t(sp.last_instruct_start, i32),
            t(sp.last_instruct_end, i32), t(sp.has_image))


def log_softmax(lg: np.ndarray) -> np.ndarray:
    lg = lg - lg.max(axis=-1, keepdims=True)
    return lg - np.log(np.exp(lg).sum(axis=-1, keepdims=True))


@torch.no_grad()
def eval_arm(params, cfg: LlavaConfig, prompts, answers, imgs, sig_pos, labels_txt,
             score_override=None, device=None):
    """Batched prefill + one teacher-forced decode step on the held-out
    set: answer PPL, POPE accuracy / F1 of the greedy answer, the answer
    margin, and the signal patch's survival rate (None when the arm does
    not prune)."""
    device = resolve_device(device)
    plan = plan_batch(list(prompts), cfg.num_image_tokens)
    b = plan.batch
    cache = dynamic.make_gen_cache(cfg, b, plan.seq_len, 8, torch.float32, device=device)
    kwargs = {}
    if score_override is not None:
        kwargs["vision_score_override"] = torch.as_tensor(
            np.asarray(score_override, np.float32), device=device)
    state, info = dynamic.prefill(
        params, cfg, *plan_tensors(plan, device),
        torch.from_numpy(np.asarray(imgs, np.float32)).to(device), cache, **kwargs)
    ans = np.stack(answers)  # [B, 2] answer token + </s>
    logits1 = state.last_logits.float().cpu().numpy()  # predicts the answer
    state = dynamic.decode_step(params, cfg, torch.from_numpy(ans[:, 0]).to(device), state)
    logits2 = state.last_logits.float().cpu().numpy()  # predicts </s>

    lp1, lp2 = log_softmax(logits1), log_softmax(logits2)
    nll = -(lp1[np.arange(b), ans[:, 0]] + lp2[np.arange(b), ans[:, 1]])
    ppl = math.exp(float(nll.mean()) / 2.0)
    top2 = np.partition(logits1, -2, axis=-1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).mean())
    greedy = logits1.argmax(axis=-1)
    texts = [VOCAB[t] if 0 <= t < len(VOCAB) else "none" for t in greedy]
    pope = score_pope(texts, labels_txt)

    keep_rate = None
    if info.image_keep_mask is not None:
        mask = info.image_keep_mask.cpu().numpy()
        img_start = np.asarray(plan.spans.image_start)
        kept = mask[np.arange(b), img_start + np.asarray(sig_pos)]
        keep_rate = float(kept.mean())
    return {
        "holdout_answer_ppl": round(ppl, 4),
        "pope_accuracy_holdout": round(pope["accuracy"], 4),
        "pope_f1_holdout": round(pope["f1"], 4),
        "answer_margin": round(margin, 4),
        "signal_patch_kept": None if keep_rate is None else round(keep_rate, 4),
    }


def make_cfg(hidden: int, layers: int, keep_rate: float, use_vision_predictor: bool = True,
             image_size: int = 70, patch: int = 14, sparse_layer: int = 1, heads: int = 4,
             vision_hidden: int = 32, vision_heads: int = 2) -> LlavaConfig:
    """The JAX harness's config; ``heads``, ``vision_hidden`` and
    ``vision_heads`` set the widths (the defaults are the JAX values; the
    card's attention kernels need head_dim 64 or 128)."""
    return LlavaConfig(
        text=LlamaConfig(
            vocab_size=len(VOCAB), hidden_size=hidden, intermediate_size=hidden * 2,
            num_hidden_layers=layers, num_attention_heads=heads, num_key_value_heads=heads,
        ),
        vision=ClipVisionConfig(
            hidden_size=vision_hidden, intermediate_size=vision_hidden * 2,
            num_hidden_layers=2, num_attention_heads=vision_heads, image_size=image_size,
            patch_size=patch,
        ),
        sparse=SparseConfig(
            d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
            use_vision_predictor=use_vision_predictor, vision_keep_rate=keep_rate,
            use_text_predictor=False, use_output_text_predictor=False,
            use_instruct_predictor=False,
            # prune early relative to depth: layers below sparse_layer see
            # the full image and can carry the answer past the pruning
            sparse_layer=sparse_layer,
        ),
    )


def run_all(steps: int, pairs: int, holdout: int, hidden: int, layers: int, seed: int = 0,
            log_every: int = 0, sparse_layer: int = 0, dense_steps: Optional[int] = None,
            heads: int = 4, vision_hidden: int = 32, vision_heads: int = 2, device=None):
    """Both training stages, then every arm. Prints one JSON line an arm and
    a summary; returns ``(rows, gaps)``."""
    device = resolve_device(device)
    widths = dict(heads=heads, vision_hidden=vision_hidden, vision_heads=vision_heads)
    cfg = make_cfg(hidden, layers, 0.2, sparse_layer=sparse_layer, **widths)
    n_img = cfg.num_image_tokens
    prompts, answers, imgs, sig_pos, labels = build_corpus(
        pairs + holdout, cfg.vision.image_size, cfg.vision.patch_size, seed=seed)
    tr, ho = slice(0, pairs), slice(pairs, pairs + holdout)

    # stage 1 (the pretrained model's stand-in): dense until the model
    # reads the image; stage 2 adds the predictors and finetunes
    dense_steps = steps if dense_steps is None else dense_steps
    dense_cfg = make_cfg(hidden, layers, 1.0, use_vision_predictor=False,
                         sparse_layer=sparse_layer, **widths)
    params, loss1 = train_sparse(dense_cfg, prompts[tr], answers[tr], imgs[tr], dense_steps,
                                 seed=seed, log_every=log_every, device=device)
    print(f"# stage 1 (dense): {dense_steps} steps, lm_loss {loss1:.4f}", file=sys.stderr)
    params = dict(params)
    params["predictors"] = init_predictors(
        cfg, torch.Generator(device=device).manual_seed(seed + 1), device, torch.float32)
    params, lm_loss = train_sparse(cfg, prompts[tr], answers[tr], imgs[tr], steps, seed=seed,
                                   log_every=log_every, params=params, device=device)
    print(f"# stage 2 (sparse finetune): {steps} steps on {pairs} pairs ({holdout} held "
          f"out), final lm_loss {lm_loss:.4f}", file=sys.stderr)

    ho_args = (prompts[ho], answers[ho], imgs[ho], sig_pos[ho], labels[ho])
    rng = np.random.default_rng(seed + 7)
    rows = {"dense": eval_arm(params, dense_cfg, *ho_args, device=device)}
    for rate in (0.2, 0.5):
        cfg_r = dataclasses.replace(
            cfg, sparse=dataclasses.replace(cfg.sparse, vision_keep_rate=rate))
        rows[f"learned@{rate}"] = eval_arm(params, cfg_r, *ho_args, device=device)
        rows[f"random@{rate}"] = eval_arm(
            params, cfg_r, *ho_args, score_override=rng.uniform(size=(holdout, n_img)),
            device=device)
    # untrained predictor: fresh init, content-based but meaningless scores
    up = dict(params)
    up["predictors"] = init_predictors(
        cfg, torch.Generator(device=device).manual_seed(seed + 99), device, torch.float32)
    rows["untrained@0.2"] = eval_arm(up, cfg, *ho_args, device=device)

    for name, row in rows.items():
        print(json.dumps({"arm": name, **row}), flush=True)
    gaps = {
        f"learned_minus_random_acc@{r}": round(
            rows[f"learned@{r}"]["pope_accuracy_holdout"]
            - rows[f"random@{r}"]["pope_accuracy_holdout"], 4)
        for r in (0.2, 0.5)
    }
    print(json.dumps({"summary": rows, "gaps": gaps}))
    return rows, gaps


def gate_failures(rows, gaps):
    """The thresholds of ``tests/test_sparse_quality_gate.py::
    test_learned_pruning_beats_random``; an empty list when they hold."""
    learned, random_ = rows["learned@0.2"], rows["random@0.2"]
    checks = [
        (learned["signal_patch_kept"] >= 0.85, "learned@0.2 signal_patch_kept >= 0.85"),
        (random_["signal_patch_kept"] <= 0.40, "random@0.2 signal_patch_kept <= 0.40"),
        (learned["pope_accuracy_holdout"] >= random_["pope_accuracy_holdout"] + 0.15,
         "learned@0.2 accuracy >= random@0.2 + 0.15"),
        (learned["holdout_answer_ppl"] < random_["holdout_answer_ppl"],
         "learned@0.2 ppl < random@0.2 ppl"),
        (gaps["learned_minus_random_acc@0.5"] >= 0.10, "learned - random accuracy @0.5 >= 0.10"),
        (rows["dense"]["pope_accuracy_holdout"] - learned["pope_accuracy_holdout"] <= 0.20,
         "dense - learned@0.2 accuracy <= 0.20"),
    ]
    return [what for ok, what in checks if not ok]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--holdout", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vision-hidden", dest="vision_hidden", type=int, default=32)
    ap.add_argument("--vision-heads", dest="vision_heads", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dense-steps", dest="dense_steps", type=int, default=None,
                    help="stage-1 dense steps (default: same as --steps)")
    ap.add_argument("--log-every", type=int, default=0)
    ap.add_argument("--sparse-layer", dest="sparse_layer", type=int, default=0,
                    help="prune entering this layer; 0 = the embedding boundary, where "
                         "dropped tokens are invisible to every layer")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    run_all(args.steps, args.pairs, args.holdout, args.hidden, args.layers, seed=args.seed,
            log_every=args.log_every, sparse_layer=args.sparse_layer,
            dense_steps=args.dense_steps, heads=args.heads, vision_hidden=args.vision_hidden,
            vision_heads=args.vision_heads, device=args.device)


if __name__ == "__main__":
    main()
