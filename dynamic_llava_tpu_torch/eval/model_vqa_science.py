"""ScienceQA generator: the port's counterpart of
``dynamic_llava_tpu/eval/model_vqa_science.py`` (the reference's
``llava/dynamic_eval/model_vqa_science.py``).

A LLaVA-format question file (a JSON list: ``id``, ``conversations``, and
``image`` where the problem has one) -> the first turn without its
``<image>`` tag, the tag put back in front where there is an image
(text-only problems generate without pixels), with ``--single-pred-prompt``
the instruction to answer with the option's letter -> an answers JSONL
that ``eval_science_qa`` scores. ``--max_new_tokens`` defaults to the 1024
that the JAX generator fixes.

    python -m dynamic_llava_tpu_torch.eval.model_vqa_science --model-path CKPT_DIR \\
        --image-folder IMAGES --question-file llava_test_CQM-A.json \\
        --answers-file A.jsonl --single-pred-prompt
"""

from __future__ import annotations

import argparse
import json
import os
import uuid

import numpy as np

from .model_vqa_loader import add_port_flags, answer, get_chunk, load


def eval_model(args, loaded=None) -> None:
    """Answer ``args.question_file`` (this chunk of it) into
    ``args.answers_file``; ``loaded`` as in ``model_vqa_loader.load``."""
    from PIL import Image

    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates
    from ..generation.generate import GenerationConfig, Generator
    from ..mm_utils import process_images, tokenizer_image_token

    tokenizer, runtime, image_processor, _ = load(args, loaded)
    with open(os.path.expanduser(args.question_file)) as f:
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        eos_token_id=tokenizer.eos_token_id,
    ))
    with open(answers_file, "w") as ans_file:
        for line in questions:
            qs = line["conversations"][0]["value"].replace("<image>", "").strip()
            pixels = None
            if "image" in line:
                image = Image.open(os.path.join(args.image_folder, line["image"])).convert("RGB")
                pixels = process_images([image], image_processor, runtime.cfg)
                qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
            if args.single_pred_prompt:
                qs = qs + "\n" + "Answer with the option's letter from the given choices directly."
            conv = conv_templates[args.conv_mode].copy()
            conv.append_message(conv.roles[0], qs)
            conv.append_message(conv.roles[1], None)
            input_ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64)
            ans_file.write(json.dumps({
                "question_id": line["id"],
                "prompt": qs,
                "text": answer(gen, tokenizer, input_ids, pixels, args.spec_k, args.temperature),
                "answer_id": uuid.uuid4().hex,
                "model_id": args.model_path.split("/")[-1],
                "metadata": {},
            }) + "\n")
            ans_file.flush()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", type=str, required=True)
    p.add_argument("--model-base", dest="model_base", type=str, default=None)
    p.add_argument("--image-folder", dest="image_folder", type=str, default="")
    p.add_argument("--question-file", dest="question_file", type=str, required=True)
    p.add_argument("--answers-file", dest="answers_file", type=str, default="answer.jsonl")
    p.add_argument("--conv-mode", dest="conv_mode", type=str, default="llava_v1")
    p.add_argument("--num-chunks", dest="num_chunks", type=int, default=1)
    p.add_argument("--chunk-idx", dest="chunk_idx", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--single-pred-prompt", dest="single_pred_prompt", action="store_true")
    p.add_argument("--max_new_tokens", type=int, default=1024)
    return add_port_flags(p)


def main(argv=None) -> None:
    eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
