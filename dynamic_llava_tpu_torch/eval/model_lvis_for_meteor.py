"""LVIS generation-quality probe, free-running generation for METEOR: the
port's counterpart of ``dynamic_llava_tpu/eval/model_lvis_for_meteor.py``
(the reference's ``llava/dynamic_eval/model_lvis_for_meteor.py``). It
generates each answer (``Generator.generate``), logs the prefill's
post-tier length and the answer's token length, and scores METEOR against
the reference answer where ``nltk`` imports (``None`` elsewhere: the pairs
are in the file for external scoring).

    python -m dynamic_llava_tpu_torch.eval.model_lvis_for_meteor --model-path CKPT_DIR \\
        --image-folder IMAGES --question-file Q.jsonl --answers-file meteor.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

from .model_vqa_loader import add_device_flag, load
from .self_ppl import prefill_state, tier_lengths


def try_meteor(pred: str, ref: str):
    try:
        from nltk.translate.meteor_score import meteor_score

        return float(meteor_score([ref.split()], pred.split()))
    except Exception:
        return None


def eval_model(args, loaded=None) -> List[Dict]:
    """Write one record a line of ``args.question_file`` into
    ``args.answers_file``; returns the records. ``loaded`` as in
    ``model_vqa_loader.load``."""
    from PIL import Image

    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates
    from ..generation.generate import GenerationConfig, Generator
    from ..mm_utils import process_images, tokenizer_image_token
    from ..multimodal.fusion import plan_batch

    tokenizer, runtime, image_processor, _ = load(args, loaded)
    with open(os.path.expanduser(args.question_file)) as f:
        records = [json.loads(line) for line in f]
    if args.limit:
        records = records[: args.limit]
    os.makedirs(os.path.dirname(os.path.abspath(args.answers_file)), exist_ok=True)

    gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        eos_token_id=tokenizer.eos_token_id,
    ))
    written = []
    with open(args.answers_file, "w") as out:
        for line in records:
            conv = conv_templates[args.conv_mode].copy()
            conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + line["text"])
            conv.append_message(conv.roles[1], None)
            ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64)
            image = Image.open(os.path.join(args.image_folder, line["image"])).convert("RGB")
            pixels = process_images([image], image_processor, runtime.cfg)

            # the prefill's post-tier length, read from a cache of its own:
            # the Generator's runner (and its graph) stays for generate
            plan = plan_batch([ids], runtime.cfg.num_image_tokens)
            with torch.inference_mode():
                state, _ = prefill_state(gen, plan, pixels, args.max_new_tokens)
                prefill_post = tier_lengths(state)[1]
            del state

            out_ids = gen.generate([ids], pixels)[0]
            if out_ids and out_ids[-1] == tokenizer.eos_token_id:
                out_ids = out_ids[:-1]
            pred = tokenizer.decode(out_ids, skip_special_tokens=True).strip()
            ref = line.get("answer", "")
            rec = {
                "question_id": line.get("question_id"),
                "text": pred,
                "reference": ref,
                "meteor": try_meteor(pred, ref),
                "output_token_length": len(out_ids),
                "prefill_cache_length": prefill_post,
            }
            out.write(json.dumps(rec) + "\n")
            out.flush()
            written.append(rec)
    return written


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", required=True)
    p.add_argument("--model-base", dest="model_base", default=None)
    p.add_argument("--image-folder", dest="image_folder", default="")
    p.add_argument("--question-file", dest="question_file", required=True)
    p.add_argument("--answers-file", dest="answers_file", default="meteor.jsonl")
    p.add_argument("--conv-mode", dest="conv_mode", default="vicuna_v1")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--limit", type=int, default=0)
    return add_device_flag(p)


def main(argv=None) -> List[Dict]:
    return eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
