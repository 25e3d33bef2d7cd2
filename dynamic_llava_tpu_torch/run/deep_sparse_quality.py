"""Learned-vs-random pruning at the PRODUCTION boundary (sparse_layer=2) on
the port, ported from the repo's ``run/deep_sparse_quality.py`` (numpy and
the port only).

``run/sparse_quality.py`` ablates at sparse_layer=0 because its one-signal
task washes out at any deeper boundary: layers 0..sl-1 (and the pre cache
tier at decode) always see the full image, and ONE attention hop suffices
to pool the single signal patch into the text stream, so pruning at layer 2
can never bite. The reference's production configuration prunes at layer 2
of 32, so the method's quality story needs a toy where the post-tier
tokens are load-bearing AT sl=2.

This harness is a CONTENT-ADDRESSED POINTER CHASE. Every used patch is
[ID half | payload half]; the chase starts at the patch whose ID is
pattern 0, whose payload is the ID of the next patch, and so on for
``hops`` dereferences; the final patch's payload is one of two class
patterns = the yes/no answer. Distractor patches carry class payloads
under non-chain IDs and pointer payloads. Resolving hop j needs one
attention layer over image tokens, so the answer needs hops+1 sequential
lookups:

  * hops=1 -> 2 lookups, completable inside the sl=2 pre tier: pruning
    (learned OR random) should NOT separate: the built-in negative control.
  * hops=2 -> 3 lookups: the final dereference can only happen at layers
    >= 2, where dropped tokens are GONE: the chain-end patch must survive
    pruning, and only a content-aware policy keeps it.

Training runs through the port's train step (Gumbel policy attention and
the mask-ratio loss) in two stages, on FRESH data every step: a dense
stage-1 stand-in for the pretrained LLaVA (a curriculum over chain depth),
then the sparse stage-2 finetune with the predictors (all depths cycled;
the base at a 40x lower lr than the predictors, as the reference recipe).
Evaluation runs the port's ``prefill`` (top-k, compaction;
``vision_score_override`` for the random arms) and one ``decode_step`` on
held-out samples. The harness has no threshold: it prints the rows.

    python -m dynamic_llava_tpu_torch.run.deep_sparse_quality --device cuda   # full table
    python -m dynamic_llava_tpu_torch.run.deep_sparse_quality --device cpu --hops 2 \\
        --steps 8 --dense-steps 8 --batch 8 --holdout 8                        # smoke

On the card the text head_dim is 32 and the tower's 24; the attention
wrappers zero-pad both to 64 (exact), so the tower and the prefill run K1,
the sparse stage K4, the backward K3 and the decode step K2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Optional

import numpy as np
import torch

from ..config import ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig
from ..eval.eval_pope import score_pope
from ..models import dynamic
from ..multimodal.fusion import plan_batch
from ..train.optimizer import gumbel_tau_schedule, label_params, make_optimizer
from ..train.step import batch_from_plan, make_train_step
from ..weights import init_llava_params, init_predictors, resolve_device
from .sparse_quality import (EOS, NO, VOCAB, YES, Noise, log_softmax, noise_source,
                             plan_tensors)

STAGE2_BASE_LR = 7.5e-5  # stage-2 base-LM lr; the predictors stay at 3e-3

QUESTION = [1, VOCAB.index("Q"), VOCAB.index("is"), VOCAB.index("there"),
            VOCAB.index("a"), -200, VOCAB.index("signal"), VOCAB.index("?"),
            VOCAB.index("A")]


def build_patterns(rng, patch: int, alphabet: int, amp: float, full: bool = False):
    """Pattern libraries: ``alphabet`` ID patterns + 2 class patterns, all
    amp-normalized so loudness carries no information. ``full=False``
    gives half-patch-wide patterns (the "halves" tile layout);
    ``full=True`` gives whole-patch patterns (the "additive" layout)."""

    def norm(x):
        return amp * x / np.abs(x).max(axis=(1, 2, 3), keepdims=True)

    w = patch if full else patch // 2
    ids = norm(rng.normal(size=(alphabet, patch, w, 3)).astype(np.float32))
    cls = norm(rng.normal(size=(2, patch, w, 3)).astype(np.float32))
    return ids, cls


def build_corpus(n: int, image_size: int, patch: int, seed: int = 0,
                 noise: float = 0.5, amp: float = 2.5, hops: int = 2,
                 class_distractors: int = 4, pointer_distractors: int = 2,
                 alphabet: int = 16, encoding: str = "halves",
                 pointer_coeff: float = 0.6):
    """n samples of the ID-chain chase. Returns (prompts, answers, imgs,
    chain_pos [n, hops+1] grid positions of the chain patches in order,
    labels_txt): the JAX harness's arrays for a seed (one numpy generator,
    the same draws in the same order).

    Tile encodings:
      * ``halves``: [ID half | payload half]. The dynamic hop-2 lookup
        must map a payload-half embedding onto an ID-half embedding: an
        arbitrary learned rotation with no initial gradient.
      * ``additive``: tile = ID + pointer_coeff * payload, one shared
        whole-patch library. Retrieved pointer content then matches the
        target's key IN THE SAME pattern subspace; ``pointer_coeff``
        (relative amplitude within an amp-normalized tile) disambiguates
        own-ID from pointer."""
    rng = np.random.default_rng(seed)
    g = image_size // patch
    n_patches = g * g
    id_pat, cls_pat = build_patterns(rng, patch, alphabet, amp,
                                     full=(encoding == "additive"))
    n_chain = hops + 1
    n_used = n_chain + class_distractors + pointer_distractors
    if n_used > n_patches or n_used > alphabet:
        raise ValueError(f"{n_used} used patches do not fit {n_patches} patches and "
                         f"{alphabet} IDs")

    prompts, answers, imgs, chain_pos, labels_txt = [], [], [], [], []
    for i in range(n):
        c = i % 2
        img = rng.normal(scale=noise, size=(image_size, image_size, 3)).astype(np.float32)
        pos = rng.permutation(n_patches)[:n_used]
        # unique IDs; index 0 of `ids_` is the chase start (ID pattern 0)
        ids_ = np.concatenate([[0], 1 + rng.permutation(alphabet - 1)[: n_used - 1]])

        def put(p, id_idx, payload):
            r, col = divmod(int(p), g)
            if encoding == "additive":
                tile = id_pat[id_idx] + pointer_coeff * payload
            else:
                tile = np.concatenate([id_pat[id_idx], payload], axis=1)
            tile = tile + rng.normal(scale=0.1, size=tile.shape).astype(np.float32)
            img[r * patch:(r + 1) * patch, col * patch:(col + 1) * patch, :] = tile

        # chain: patch with ID ids_[j] points (payload) at ID ids_[j+1];
        # the last chain patch's payload is the class pattern
        for j in range(hops):
            put(pos[j], ids_[j], id_pat[ids_[j + 1]])
        put(pos[hops], ids_[hops], cls_pat[c])
        k = n_chain
        for _ in range(class_distractors):
            put(pos[k], ids_[k], cls_pat[rng.integers(2)])
            k += 1
        for _ in range(pointer_distractors):
            put(pos[k], ids_[k], id_pat[rng.integers(1, alphabet)])
            k += 1

        prompts.append(np.asarray(QUESTION, np.int64))
        ans = YES if c == 0 else NO
        answers.append(np.asarray([ans, EOS], np.int64))
        imgs.append(img)
        chain_pos.append(pos[:n_chain].copy())
        labels_txt.append("yes" if ans == YES else "no")
    return (prompts, answers, np.stack(imgs), np.asarray(chain_pos), labels_txt)


def make_cfg(hidden: int, layers: int, keep_rate: float, sparse_layer: int,
             use_vision_predictor: bool = True, image_size: int = 70,
             patch: int = 14, pred_layers: int = 3) -> LlavaConfig:
    """The JAX harness's config: text heads 4, a tower of hidden 48 in 2
    heads, ``pred_layers`` bidirectional predictor blocks (tracing an m-hop
    chain needs m+1 propagation steps)."""
    return LlavaConfig(
        text=LlamaConfig(
            vocab_size=len(VOCAB), hidden_size=hidden, intermediate_size=hidden * 2,
            num_hidden_layers=layers, num_attention_heads=4, num_key_value_heads=4,
        ),
        vision=ClipVisionConfig(
            hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=2, image_size=image_size, patch_size=patch,
        ),
        sparse=SparseConfig(
            d_model=48, nhead=2, dim_feedforward=96, num_layers=pred_layers,
            use_vision_predictor=use_vision_predictor, vision_keep_rate=keep_rate,
            use_text_predictor=False, use_output_text_predictor=False,
            use_instruct_predictor=False, sparse_layer=sparse_layer,
        ),
    )


def hops_schedule(steps: int, max_hops: int):
    """Curriculum over chain depth: the h-hop task alone gives a
    from-scratch learner no gradient until the whole chain is traced. The
    schedule unlocks depth d at step d/(max_hops+1) of the run and then
    CYCLES every unlocked depth so earlier circuits are never forgotten."""
    sched = []
    for i in range(steps):
        unlocked = min(max_hops, int((max_hops + 1) * i / max(steps, 1)))
        sched.append(i % (unlocked + 1))
    return sched


def train_fresh(cfg: LlavaConfig, steps: int, batch_size: int, seed: int, image_size: int,
                patch: int, hops: int, params=None, log_every: int = 0, lr: float = 3e-3,
                base_lr: Optional[float] = None, corpus_kw=None, curriculum=True,
                device=None, noise: Noise = None):
    """Stage trainer on fresh per-step batches through the port's train
    step (Gumbel policy + mask-ratio loss when the predictor is on), tau
    annealed 1.0 -> 0.1 over the run, no remat. ``curriculum=True`` trains
    on mixed chain depths 0..hops (``hops_schedule``), ``"cycle"`` cycles
    all depths from step 0, False trains at ``hops`` only. The predictors
    train at ``lr``, the rest at ``base_lr`` (default ``lr``). ``noise(i)``
    gives step i's uniform tensors (``sparse_quality.noise_source``).
    Returns ``(params, {depth: its last fresh-batch lm_loss})``; ``params``
    are updated in place."""
    device = resolve_device(device)
    if params is None:
        params = init_llava_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                   device, torch.float32)
    if curriculum == "cycle" and hops:  # all depths from step 0
        sched = [i % (hops + 1) for i in range(steps)]
    elif curriculum and hops:  # progressive unlock
        sched = hops_schedule(steps, hops)
    else:
        sched = [hops] * steps
    corpora = {}
    for h in sorted(set(sched)):
        n_h = sum(1 for s in sched if s == h)
        prompts, answers, imgs, _, _ = build_corpus(
            n_h * batch_size, image_size, patch, seed=seed + 54321 + h, hops=h,
            **(corpus_kw or {}))
        ids, labels = [], []
        for p, a in zip(prompts, answers):
            row = np.concatenate([p, a])
            lab = row.copy()
            lab[: len(p)] = -100
            ids.append(row)
            labels.append(lab)
        corpora[h] = {"ids": ids, "labels": labels, "imgs": imgs, "next": 0}

    opt = make_optimizer(base_lr=lr if base_lr is None else base_lr, predictor_lr=lr)
    step = make_train_step(cfg, opt, remat=False, labels=label_params(params))
    opt_state = opt.init(params)
    tau_fn = gumbel_tau_schedule(1.0, 0.1, max(steps, 1))
    noise_at = noise_source(seed, device, noise)
    last_loss = {}
    for i in range(steps):
        h = sched[i]
        c = corpora[h]
        lo = c["next"] * batch_size
        hi = lo + batch_size
        c["next"] += 1
        plan = plan_batch(c["ids"][lo:hi], cfg.num_image_tokens, labels_list=c["labels"][lo:hi])
        batch = batch_from_plan(plan, c["imgs"][lo:hi], device)
        params, opt_state, m = step(params, opt_state, batch, noise_at(i), tau_fn(i))
        last_loss[h] = float(m["lm_loss"])
        if log_every and (i + 1) % log_every == 0:
            per_h = " ".join(f"h{k}:{v:.4f}" for k, v in sorted(last_loss.items()))
            print(f"# step {i + 1}: loss {float(m['loss']):.4f} lm_loss by depth [{per_h}]",
                  file=sys.stderr)
    return params, last_loss


@torch.no_grad()
def eval_arm(params, cfg: LlavaConfig, prompts, answers, imgs, chain_pos, labels_txt,
             score_override=None, device=None):
    """Held-out eval through the port's prefill / top-k / compaction path
    and one teacher-forced decode step: answer PPL, POPE accuracy / F1 of
    the greedy answer, and each chain position's survival rate
    (``chain{j}_kept``, ``chain_end_kept``; None when the arm does not
    prune)."""
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
    logits1 = state.last_logits.float().cpu().numpy()
    state = dynamic.decode_step(params, cfg, torch.from_numpy(ans[:, 0]).to(device), state)
    logits2 = state.last_logits.float().cpu().numpy()

    lp1, lp2 = log_softmax(logits1), log_softmax(logits2)
    nll = -(lp1[np.arange(b), ans[:, 0]] + lp2[np.arange(b), ans[:, 1]])
    ppl = math.exp(float(nll.mean()) / 2.0)
    greedy = logits1.argmax(axis=-1)
    texts = [VOCAB[t] if 0 <= t < len(VOCAB) else "none" for t in greedy]
    pope = score_pope(texts, labels_txt)

    row = {
        "holdout_answer_ppl": round(ppl, 4),
        "pope_accuracy_holdout": round(pope["accuracy"], 4),
        "pope_f1_holdout": round(pope["f1"], 4),
    }
    if info.image_keep_mask is not None:
        mask = info.image_keep_mask.cpu().numpy()
        img_start = np.asarray(plan.spans.image_start)
        for j in range(chain_pos.shape[1]):
            kept = mask[np.arange(b), img_start + chain_pos[:, j]]
            row[f"chain{j}_kept"] = round(float(kept.mean()), 4)
        row["chain_end_kept"] = row[f"chain{chain_pos.shape[1] - 1}_kept"]
    else:
        row["chain_end_kept"] = None
    return row


def run_all(steps: int, dense_steps: int, batch: int, holdout: int, hidden: int, layers: int,
            sparse_layer: int, hops: int, seed: int = 0, log_every: int = 0,
            pred_layers: int = 3, corpus_kw=None,
            stage2_base_lr: Optional[float] = STAGE2_BASE_LR, device=None):
    """Both training stages, then every arm at chain depths hops-1 and hops.
    Prints one JSON line an arm and a gaps line a depth; returns
    ``(rows, gaps)`` keyed by depth."""
    device = resolve_device(device)
    image_size, patch = 70, 14
    cfg = make_cfg(hidden, layers, 0.2, sparse_layer, pred_layers=pred_layers)
    n_img = cfg.num_image_tokens

    dense_cfg = make_cfg(hidden, layers, 1.0, sparse_layer, use_vision_predictor=False,
                         pred_layers=pred_layers)
    params, loss1 = train_fresh(dense_cfg, dense_steps, batch, seed, image_size, patch, hops,
                                log_every=log_every, corpus_kw=corpus_kw, device=device)
    print(f"# stage 1 (dense, hops-curriculum): {dense_steps} steps, "
          f"lm_loss by depth {loss1}", file=sys.stderr)
    params = dict(params)
    params["predictors"] = init_predictors(
        cfg, torch.Generator(device=device).manual_seed(seed + 1), device, torch.float32)
    # stage-2 lr split as the reference recipe (base 5e-6, predictors 2e-4:
    # 40x): a near-frozen base cannot unlearn its image reliance faster than
    # the predictor locks onto the load-bearing patches
    params, loss2 = train_fresh(cfg, steps, batch, seed + 1, image_size, patch, hops,
                                params=params, log_every=log_every, corpus_kw=corpus_kw,
                                curriculum="cycle", base_lr=stage2_base_lr, device=device)
    print(f"# stage 2 (sparse finetune, depth cycle): {steps} steps, "
          f"lm_loss by depth {loss2}", file=sys.stderr)

    # ONE mixed-depth model, evaluated per chain depth
    rng = np.random.default_rng(seed + 7)
    all_rows, all_gaps = {}, {}
    for h in range(max(hops - 1, 0), hops + 1):
        prompts, answers, imgs, chain_pos, labels_txt = build_corpus(
            holdout, image_size, patch, seed=seed + 999_999 + h, hops=h, **(corpus_kw or {}))
        ho_args = (prompts, answers, imgs, chain_pos, labels_txt)
        rows = {"dense": eval_arm(params, dense_cfg, *ho_args, device=device)}
        for rate in (0.2, 0.5):
            cfg_r = dataclasses.replace(
                cfg, sparse=dataclasses.replace(cfg.sparse, vision_keep_rate=rate))
            rows[f"learned@{rate}"] = eval_arm(params, cfg_r, *ho_args, device=device)
            rows[f"random@{rate}"] = eval_arm(
                params, cfg_r, *ho_args, score_override=rng.uniform(size=(holdout, n_img)),
                device=device)
        for name, row in rows.items():
            print(json.dumps({"hops": h, "arm": name, **row}), flush=True)
        gaps = {
            f"learned_minus_random_acc@{r}": round(
                rows[f"learned@{r}"]["pope_accuracy_holdout"]
                - rows[f"random@{r}"]["pope_accuracy_holdout"], 4)
            for r in (0.2, 0.5)
        }
        print(json.dumps({"hops": h, "sparse_layer": sparse_layer, "gaps": gaps}), flush=True)
        all_rows[h], all_gaps[h] = rows, gaps
    return all_rows, all_gaps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--dense-steps", dest="dense_steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--holdout", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--sparse-layer", dest="sparse_layer", type=int, default=2)
    ap.add_argument("--hops", type=int, default=2)
    ap.add_argument("--pred-layers", dest="pred_layers", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=0)
    ap.add_argument("--encoding", choices=("halves", "additive"), default="halves")
    ap.add_argument("--pointer-coeff", dest="pointer_coeff", type=float, default=0.6)
    ap.add_argument("--stage2-base-lr", dest="stage2_base_lr", type=float,
                    default=STAGE2_BASE_LR,
                    help="stage-2 base-LM lr (predictors stay at 3e-3; the reference "
                         "recipe's 40x split)")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    run_all(args.steps, args.dense_steps, args.batch, args.holdout, args.hidden, args.layers,
            args.sparse_layer, args.hops, seed=args.seed, log_every=args.log_every,
            pred_layers=args.pred_layers,
            corpus_kw={"encoding": args.encoding, "pointer_coeff": args.pointer_coeff},
            stage2_base_lr=args.stage2_base_lr, device=args.device)


if __name__ == "__main__":
    main()
