"""Detail-description probe over a dataset with self-PPL accounting: the
port's counterpart of ``dynamic_llava_tpu/eval/model_vqa_science_for_ppl.py``
(the reference's ``llava/eval/model_vqa_science_for_ppl.py``): asks
"Describe the image in detail." for every image of the question file,
records each answer with its token length and self-perplexity, and appends
a summary row with the mean self-PPL. Problems without an image are
skipped. (The reference's ``gpt4o_ppl`` column is a placeholder, always
0.0, kept for the format.)

    python -m dynamic_llava_tpu_torch.eval.model_vqa_science_for_ppl \\
        --model-path CKPT_DIR --image-folder IMAGES --question-file Q.json \\
        --answers-file A.jsonl [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import uuid

from .model_vqa_loader import add_device_flag, get_chunk, load
from .self_ppl import generate_with_self_ppl, prepare_image_prompt

DEFAULT_QUERY = "Describe the image in detail."


def eval_model(args, loaded=None) -> float:
    """Write ``args.answers_file``; returns the mean self-PPL. ``loaded``
    as in ``model_vqa_loader.load``."""
    tokenizer, runtime, image_processor, _ = load(args, loaded)
    with open(os.path.expanduser(args.question_file)) as f:
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    n_images = 0
    sum_self_ppl = 0.0
    with open(answers_file, "w") as ans_file:
        for line in questions[: args.limit] if args.limit else questions:
            if "image" not in line:
                continue
            ids, pixels = prepare_image_prompt(
                args.query, runtime.cfg,
                os.path.join(args.image_folder, line["image"]),
                image_processor, args.conv_mode, tokenizer)
            result = generate_with_self_ppl(
                runtime, tokenizer, ids, pixels,
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature)
            n_images += 1
            sum_self_ppl += result["self_ppl"]
            ans_file.write(json.dumps({
                "question_id": line["id"],
                "prompt": "<image>\n" + args.query,
                "answer": result["text"],
                "answer_id": uuid.uuid4().hex,
                "model_id": args.model_path.split("/")[-1],
                "metadata": {},
                "answer_token_len": str(result["answer_token_len"]),
                "self_ppl": str(result["self_ppl"]),
                "gpt4o_ppl": str(0.0),
            }) + "\n")
            ans_file.flush()
        mean_ppl = sum_self_ppl / n_images if n_images else 0.0
        ans_file.write(json.dumps({
            "mean_self_ppl": str(mean_ppl),
            "mean_gpt4o_ppl": str(0.0),
        }) + "\n")
    print("mean_self_ppl: " + str(mean_ppl))
    return mean_ppl


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", required=True)
    p.add_argument("--model-base", dest="model_base", default=None)
    p.add_argument("--image-folder", dest="image_folder", default="")
    p.add_argument("--question-file", dest="question_file", required=True)
    p.add_argument("--answers-file", dest="answers_file", default="answer.jsonl")
    p.add_argument("--conv-mode", dest="conv_mode", default="llava_v0")
    p.add_argument("--num-chunks", dest="num_chunks", type=int, default=1)
    p.add_argument("--chunk-idx", dest="chunk_idx", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--query", default=DEFAULT_QUERY)
    p.add_argument("--max_new_tokens", type=int, default=1024)
    p.add_argument("--limit", type=int, default=0)
    return add_device_flag(p)


def main(argv=None) -> float:
    return eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
