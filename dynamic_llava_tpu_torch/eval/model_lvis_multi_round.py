"""Multi-round LVIS probes (PPL and METEOR variants): the port's
counterpart of ``dynamic_llava_tpu/eval/model_lvis_multi_round.py`` (the
reference's ``model_lvis_multi_round_for_{ppl,meteor}.py``). Several QA
rounds run against ONE live KV cache: round 1 is the multimodal prefill,
each later round's follow-up instruction goes through the continuation
prefill (``dynamic.prefill_continue``: K2-M on the card), then its answer
is teacher-forced (``--mode ppl``) or generated greedily (``--mode
meteor``), one eager decode step a token. Each round logs both tiers'
cache lengths, so decode and instruct sparsification show across rounds.

The cache has room for ``(rounds + 1) * max_new_tokens`` new tokens, as in
JAX. Rounds whose follow-up chunks and answers (teacher-forced: every
answer token; generated: ``max_new_tokens`` a round) pass the pre tier's
room are refused before anything runs, as ``ChatSession`` refuses them:
past it the JAX tool's writes land clamped in the last slot while the
lengths run past the capacity, and on the card such a write would be out
of bounds.

    python -m dynamic_llava_tpu_torch.eval.model_lvis_multi_round --model-path CKPT_DIR \\
        --image-folder IMAGES --question-file Q.jsonl --mode ppl
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

from .model_vqa_loader import add_device_flag, load
from .self_ppl import decode_token, host_logits, log_softmax, prefill_state, tier_lengths


@torch.inference_mode()
def run_rounds(runtime, tokenizer, rounds, pixels, conv_mode: str,
               max_new_tokens: int, teacher_forced: bool) -> List[Dict]:
    """One record a round: ``round``, ``pre_cache_length``,
    ``post_cache_length`` and, teacher-forced, ``ppl`` and
    ``output_token_length``, else ``text``."""
    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates
    from ..generation.generate import GenerationConfig, Generator
    from ..mm_utils import tokenizer_image_token
    from ..models import dynamic
    from ..multimodal.fusion import plan_batch

    gen = Generator(runtime.params, runtime.cfg,
                    GenerationConfig(max_new_tokens=max_new_tokens,
                                     eos_token_id=tokenizer.eos_token_id))
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + rounds[0]["text"])
    conv.append_message(conv.roles[1], None)
    ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64)
    plan = plan_batch([ids], runtime.cfg.num_image_tokens)
    budget = (len(rounds) + 1) * max_new_tokens
    # follow-up chunks (round 2 on) and answers, tokenized before anything runs
    chunks = [np.asarray(tokenizer(f" USER: {item['text']} ASSISTANT:").input_ids[1:], np.int64)
              for item in rounds[1:]]
    answers = [tokenizer(item["answer"]).input_ids[1:] for item in rounds]
    need = sum(len(c) for c in chunks) + sum(
        len(a) if teacher_forced else max_new_tokens for a in answers)
    pre_len = gen.cache_sizes(plan, pixels, budget)[0]
    # the slots past the prompt below the tier's last (ChatSession's room)
    room = pre_len - 1 - int(plan.valid_len[0])
    if need > room:
        raise ValueError(
            f"{len(rounds)} rounds need {need} cache slots past the prompt (follow-up "
            f"chunks {[len(c) for c in chunks]}, answers "
            f"{[len(a) if teacher_forced else max_new_tokens for a in answers]}); the cache "
            f"sized for (rounds + 1) * max_new_tokens = {budget} new tokens has {room}")
    state, _ = prefill_state(gen, plan, pixels, budget)

    records = []
    for r, answer_ids in enumerate(answers):
        if r > 0:
            chunk = torch.as_tensor(chunks[r - 1][None]).to(gen.device)
            state = dynamic.prefill_continue(runtime.params, runtime.cfg, chunk, state)
        nll = []
        gen_ids = []
        steps = answer_ids if teacher_forced else range(max_new_tokens)
        for t in steps:
            logits = host_logits(state)
            if teacher_forced:
                nll.append(-log_softmax(logits)[t])
                nxt = t
            else:
                nxt = int(np.argmax(logits))
                if nxt == tokenizer.eos_token_id:
                    break
                gen_ids.append(nxt)
            state = decode_token(gen, state, nxt)
        pre, post = tier_lengths(state)
        rec = {"round": r, "pre_cache_length": pre, "post_cache_length": post}
        if teacher_forced:
            rec["ppl"] = float(np.exp(np.mean(nll))) if nll else None
            rec["output_token_length"] = len(answer_ids)
        else:
            rec["text"] = tokenizer.decode(gen_ids, skip_special_tokens=True)
        records.append(rec)
    return records


def eval_model(args, loaded=None) -> List[Dict]:
    """Write one line a sample of ``args.question_file`` (its ``rounds``, or
    the sample itself as one round) into ``args.answers_file``; returns the
    lines. ``loaded`` as in ``model_vqa_loader.load``."""
    from PIL import Image

    from ..mm_utils import process_images

    tokenizer, runtime, image_processor, _ = load(args, loaded)
    with open(os.path.expanduser(args.question_file)) as f:
        samples = [json.loads(line) for line in f]
    if args.limit:
        samples = samples[: args.limit]
    os.makedirs(os.path.dirname(os.path.abspath(args.answers_file)), exist_ok=True)
    written = []
    with open(args.answers_file, "w") as out:
        for sample in samples:
            image = Image.open(os.path.join(args.image_folder, sample["image"])).convert("RGB")
            pixels = process_images([image], image_processor, runtime.cfg)
            rounds = sample["rounds"] if "rounds" in sample else [sample]
            recs = run_rounds(
                runtime, tokenizer, rounds, pixels, args.conv_mode,
                args.max_new_tokens, teacher_forced=args.mode == "ppl",
            )
            line = {"question_id": sample.get("question_id"), "rounds": recs}
            out.write(json.dumps(line) + "\n")
            out.flush()
            written.append(line)
    return written


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", required=True)
    p.add_argument("--model-base", dest="model_base", default=None)
    p.add_argument("--image-folder", dest="image_folder", default="")
    p.add_argument("--question-file", dest="question_file", required=True)
    p.add_argument("--answers-file", dest="answers_file", default="multiround.jsonl")
    p.add_argument("--conv-mode", dest="conv_mode", default="vicuna_v1")
    p.add_argument("--mode", choices=["ppl", "meteor"], default="ppl")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--limit", type=int, default=0)
    return add_device_flag(p)


def main(argv=None) -> List[Dict]:
    return eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
