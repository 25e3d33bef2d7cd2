"""LVIS generation-quality probe, teacher-forced PPL + KV-cache shrinkage:
the port's counterpart of ``dynamic_llava_tpu/eval/model_lvis_for_ppl.py``
(the reference's ``llava/dynamic_eval/model_lvis_for_ppl.py``). It walks
the reference answer token by token through the decode path and logs each
sample's perplexity, ``prefill_cache_length`` / ``prefill_full_length``
(the post and pre tiers after the prefill: what the vision prune kept),
``output_cache_length`` against ``output_token_length`` (the decode tokens
the output-text predictor let into the post tier), and the device memory
(``profiling.memory_report``).

    python -m dynamic_llava_tpu_torch.eval.model_lvis_for_ppl --model-path CKPT_DIR \\
        --image-folder IMAGES --question-file Q.jsonl --answers-file ppl.jsonl
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
def teacher_forced_ppl(
    runtime, tokenizer, input_ids: np.ndarray, answer_ids: List[int],
    pixel_values, max_new: int = 1024,
) -> Dict:
    """Feed ``answer_ids`` after the prompt, one eager decode step each;
    the record of one sample (``ppl`` = exp of the mean NLL of the answer
    tokens, the cache lengths, the memory fields)."""
    from ..generation.generate import GenerationConfig, Generator
    from ..multimodal.fusion import plan_batch
    from ..profiling import memory_report

    gen = Generator(runtime.params, runtime.cfg, GenerationConfig(max_new_tokens=max_new))
    plan = plan_batch([input_ids], runtime.cfg.num_image_tokens
                      if pixel_values is not None else 0)
    state, _ = prefill_state(gen, plan, pixel_values, len(answer_ids) + 4)
    prefill_pre, prefill_post = tier_lengths(state)

    nll = []
    for tok in answer_ids:
        nll.append(-log_softmax(host_logits(state))[tok])
        state = decode_token(gen, state, tok)

    out_pre, out_post = tier_lengths(state)
    mem = memory_report(gen.device, model_params=runtime.params)
    return {
        "ppl": float(np.exp(np.mean(nll))),
        "prefill_cache_length": prefill_post,
        "prefill_full_length": prefill_pre,
        "output_token_length": len(answer_ids),
        "output_cache_length": out_post - prefill_post,
        "output_full_length": out_pre - prefill_pre,
        **mem,
    }


def eval_model(args, loaded=None) -> List[Dict]:
    """Write one record a line of ``args.question_file`` (``text``,
    ``answer``, ``image``) into ``args.answers_file``; returns the records.
    ``loaded`` as in ``model_vqa_loader.load``."""
    from PIL import Image

    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates
    from ..mm_utils import process_images, tokenizer_image_token

    tokenizer, runtime, image_processor, _ = load(args, loaded)
    with open(os.path.expanduser(args.question_file)) as f:
        records = [json.loads(line) for line in f]
    os.makedirs(os.path.dirname(os.path.abspath(args.answers_file)), exist_ok=True)
    written = []
    with open(args.answers_file, "w") as out:
        for line in records[: args.limit] if args.limit else records:
            conv = conv_templates[args.conv_mode].copy()
            conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + line["text"])
            conv.append_message(conv.roles[1], None)
            ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64)
            answer_ids = tokenizer(line["answer"]).input_ids[1:]  # strip bos
            image = Image.open(os.path.join(args.image_folder, line["image"])).convert("RGB")
            pixels = process_images([image], image_processor, runtime.cfg)
            rec = teacher_forced_ppl(runtime, tokenizer, ids, answer_ids, pixels)
            rec["question_id"] = line.get("question_id")
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
    p.add_argument("--answers-file", dest="answers_file", default="ppl.jsonl")
    p.add_argument("--conv-mode", dest="conv_mode", default="vicuna_v1")
    p.add_argument("--limit", type=int, default=0)
    return add_device_flag(p)


def main(argv=None) -> List[Dict]:
    return eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
