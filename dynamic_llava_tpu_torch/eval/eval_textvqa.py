"""TextVQA scorer: the port's own copy of
``dynamic_llava_tpu/eval/eval_textvqa.py`` (the reference's
``llava/dynamic_eval/eval_textvqa.py:35``).

Joins model answers with the TextVQA annotation file by (image_id, question)
and scores with the EvalAI VQA-accuracy metric from ``vqa_metrics``.

    python -m dynamic_llava_tpu_torch.eval.eval_textvqa --annotation-file A.json \
        --result-file answers.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import re

from .vqa_metrics import TextVQAAccuracyEvaluator

_OCR_PROMPT = re.compile(r"Question: (.*?) Short answer:", re.DOTALL)


def prompt_processor(prompt: str) -> str:
    """Recover the raw question from the several TextVQA prompt formats."""
    if prompt.startswith("OCR tokens: "):
        question = _OCR_PROMPT.search(prompt).group(1)
    elif "Reference OCR token: " in prompt and len(prompt.split("\n")) == 3:
        question = prompt.split("\n")[1]
    else:
        question = prompt.split("\n")[0]
    return question.lower()


def load_annotations(annotation_file: str) -> dict:
    with open(annotation_file) as f:
        data = json.load(f)["data"]
    return {(a["image_id"], a["question"].lower()): a for a in data}


def eval_single(annotation_file: str, result_file: str) -> float:
    print(os.path.splitext(os.path.basename(result_file))[0])
    annotations = load_annotations(annotation_file)

    pred_list = []
    with open(result_file) as f:
        results = [json.loads(line) for line in f]
    for result in results:
        key = (result["question_id"], prompt_processor(result["prompt"]))
        pred_list.append({
            "pred_answer": result["text"],
            "gt_answers": annotations[key]["answers"],
        })

    acc = TextVQAAccuracyEvaluator().eval_pred_list(pred_list)
    print("Samples: {}\nAccuracy: {:.2f}%".format(len(pred_list), 100.0 * acc))
    return acc


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-file", type=str)
    parser.add_argument("--result-file", type=str)
    parser.add_argument("--result-dir", type=str)
    args = parser.parse_args(argv)
    if args.result_file is not None:
        eval_single(args.annotation_file, args.result_file)
    if args.result_dir is not None:
        for f in sorted(os.listdir(args.result_dir)):
            if not f.endswith(".jsonl"):
                print(f"Skipping {f}")
                continue
            eval_single(args.annotation_file, os.path.join(args.result_dir, f))


if __name__ == "__main__":
    main()
