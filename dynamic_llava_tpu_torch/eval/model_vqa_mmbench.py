"""MMBench generator: the port's counterpart of
``dynamic_llava_tpu/eval/model_vqa_mmbench.py`` (the reference's
``llava/eval/model_vqa_mmbench.py``): a TSV with base64 images, the hint
and the options put into the question, and with ``--all-rounds`` one
round an option, the options shifted circularly between rounds.
``pandas`` reads the TSV; it is imported inside ``eval_model``, so nothing
else needs it.

    python -m dynamic_llava_tpu_torch.eval.model_vqa_mmbench --model-path CKPT_DIR \\
        --question-file mmbench_dev_20230712.tsv --answers-file A.jsonl \\
        --single-pred-prompt --all-rounds
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from .model_vqa_loader import add_port_flags, answer, get_chunk, load

all_options = ["A", "B", "C", "D"]


def is_none(value) -> bool:
    if value is None:
        return True
    try:
        if math.isnan(value):
            return True
    except TypeError:
        pass
    return str(value).lower() in ("nan", "none", "")


def get_options(row, options):
    return [row[o] for o in options if not is_none(row.get(o))]


def eval_model(args, loaded=None) -> None:
    """Answer the rows of ``args.question_file`` (this chunk of them) into
    ``args.answers_file``; ``loaded`` as in ``model_vqa_loader.load``."""
    import pandas as pd

    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates
    from ..generation.generate import GenerationConfig, Generator
    from ..mm_utils import load_image_from_base64, process_images, tokenizer_image_token

    tokenizer, runtime, image_processor, _ = load(args, loaded)
    questions = pd.read_table(os.path.expanduser(args.question_file))
    questions = get_chunk(questions.to_dict("records"), args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        eos_token_id=tokenizer.eos_token_id,
    ))
    with open(answers_file, "w") as ans_file:
        for row in questions:
            options = get_options(row, all_options)
            cur_option_char = all_options[: len(options)]
            image = load_image_from_base64(row["image"])
            pixels = process_images([image.convert("RGB")], image_processor, runtime.cfg)
            for round_idx in range(len(options) if args.all_rounds else 1):
                question = row["question"]
                hint = row.get("hint")
                if not is_none(hint):
                    question = hint + "\n" + question
                for option_char, option in zip(all_options[: len(options)], options):
                    question = question + "\n" + option_char + ". " + option
                qs = DEFAULT_IMAGE_TOKEN + "\n" + question
                if args.single_pred_prompt:
                    if args.lang == "cn":
                        qs = qs + "\n" + "请直接回答选项字母。"
                    else:
                        qs = qs + "\n" + (
                            "Answer with the option's letter from the given choices directly.")
                conv = conv_templates[args.conv_mode].copy()
                conv.append_message(conv.roles[0], qs)
                conv.append_message(conv.roles[1], None)
                input_ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer),
                                       np.int64)
                ans_file.write(json.dumps({
                    "question_id": row["index"],
                    "round_id": round_idx,
                    "prompt": question,
                    "text": answer(gen, tokenizer, input_ids, pixels, args.spec_k,
                                   args.temperature),
                    "options": options,
                    "option_char": cur_option_char,
                    "answer_id": None,
                    "model_id": args.model_path.split("/")[-1],
                    "metadata": {},
                }) + "\n")
                ans_file.flush()
                # circular shift for the next round
                options = options[1:] + options[:1]
                cur_option_char = cur_option_char[1:] + cur_option_char[:1]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", type=str, required=True)
    p.add_argument("--model-base", dest="model_base", type=str, default=None)
    p.add_argument("--question-file", dest="question_file", type=str, required=True)
    p.add_argument("--answers-file", dest="answers_file", type=str, default="answer.jsonl")
    p.add_argument("--conv-mode", dest="conv_mode", type=str, default="vicuna_v1")
    p.add_argument("--num-chunks", dest="num_chunks", type=int, default=1)
    p.add_argument("--chunk-idx", dest="chunk_idx", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--all-rounds", dest="all_rounds", action="store_true")
    p.add_argument("--single-pred-prompt", dest="single_pred_prompt", action="store_true")
    p.add_argument("--lang", type=str, default="en")
    return add_port_flags(p)


def main(argv=None) -> None:
    eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
