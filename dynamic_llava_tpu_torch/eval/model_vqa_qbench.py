"""Q-Bench (low-level vision quality) generator: the port's counterpart of
``dynamic_llava_tpu/eval/model_vqa_qbench.py`` (the reference's
``llava/eval/model_vqa_qbench.py``): multiple-choice questions over image
quality with lettered options, answered greedily.

A question file (a JSON list: ``img_path``, ``question``, ``candidates``)
-> each item written back with its ``response``, one JSON line an item.

    python -m dynamic_llava_tpu_torch.eval.model_vqa_qbench --model-path CKPT_DIR \\
        --image-folder IMAGES --questions-file Q.json --answers-file qbench.jsonl
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .model_vqa_loader import add_port_flags, answer, load

OPTIONS = ("A.", "B.", "C.", "D.")


def eval_model(args, loaded=None) -> None:
    """Answer ``args.questions_file`` into ``args.answers_file``;
    ``loaded`` as in ``model_vqa_loader.load``."""
    from PIL import Image

    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates
    from ..generation.generate import GenerationConfig, Generator
    from ..mm_utils import process_images, tokenizer_image_token

    tokenizer, runtime, image_processor, _ = load(args, loaded)
    with open(args.questions_file) as f:
        questions = json.load(f)
    os.makedirs(os.path.dirname(os.path.abspath(args.answers_file)) or ".", exist_ok=True)

    gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
        max_new_tokens=args.max_new_tokens, temperature=0.0,
        eos_token_id=tokenizer.eos_token_id))
    with open(args.answers_file, "w") as out:
        for item in questions:
            image = Image.open(os.path.join(args.image_folder, item["img_path"])).convert("RGB")
            pixels = process_images([image], image_processor, runtime.cfg)
            qs = item["question"] + "\n"
            for letter, cand in zip(OPTIONS, item["candidates"]):
                qs += f"{letter} {cand}\n"
            qs = (DEFAULT_IMAGE_TOKEN + "\n" + qs
                  + "Answer with the option's letter from the given choices directly.")
            conv = conv_templates[args.conv_mode].copy()
            conv.append_message(conv.roles[0], qs)
            conv.append_message(conv.roles[1], None)
            ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64)
            item["response"] = answer(gen, tokenizer, ids, pixels, args.spec_k)
            out.write(json.dumps(item) + "\n")
            out.flush()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", required=True)
    p.add_argument("--model-base", dest="model_base", default=None)
    p.add_argument("--image-folder", dest="image_folder", default="")
    p.add_argument("--questions-file", dest="questions_file", required=True)
    p.add_argument("--answers-file", dest="answers_file", default="qbench.jsonl")
    p.add_argument("--conv-mode", dest="conv_mode", default="llava_v1")
    p.add_argument("--lang", type=str, default="en")
    p.add_argument("--max_new_tokens", type=int, default=16)
    return add_port_flags(p)


def main(argv=None) -> None:
    eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
