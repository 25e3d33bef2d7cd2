"""Score the GPT-4 "requery" ensemble for ScienceQA: the port's own copy of
``dynamic_llava_tpu/eval/eval_science_qa_gpt4_requery.py``, on the port's
own ``eval_science_qa`` and ``eval_science_qa_gpt4``.

The requery prediction is the submission where it parses, else the model's
choice; the written results JSON holds each problem's submitted index.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter
from typing import Dict

from .eval_science_qa import get_pred_idx, parse_strict_answer
from .eval_science_qa_gpt4 import (
    OPTIONS,
    load_jsonl_predictions,
    load_split_problems,
)


def evaluate(base_dir: str, our_result: str, gpt4_result: str,
             requery_result: str, output_result: str = None,
             split: str = "test", options=OPTIONS) -> Dict:
    split_problems = load_split_problems(base_dir, split)
    ours = load_jsonl_predictions(our_result)
    requery = load_jsonl_predictions(requery_result)
    gpt4 = json.load(open(os.path.expanduser(gpt4_result)))["outputs"]

    tally = Counter()
    submitted: Dict[str, int] = {}
    for pid, prob in split_problems.items():
        if pid not in ours or pid not in gpt4:
            raise KeyError(f"problem {pid} missing from our/gpt4 results")
        requery_text = requery[pid]["text"] if pid in requery else "MISSING"
        tally["missing_requery"] += pid not in requery

        our_answer = parse_strict_answer(ours[pid]["text"])
        gpt4_answer = parse_strict_answer(gpt4[pid])
        requery_answer = parse_strict_answer(requery_text)

        our_idx = get_pred_idx(our_answer, prob["choices"], options)
        gpt4_idx = get_pred_idx(gpt4_answer, prob["choices"], options)
        requery_idx = get_pred_idx(requery_answer, prob["choices"], options)

        tally["total"] += 1
        if gpt4_answer == "FAILED":
            tally["gpt4_failed"] += 1
            tally["gpt4_correct"] += gpt4_idx == prob["answer"]
            tally["gpt4_ourvisual_correct"] += our_idx == prob["answer"]
        elif gpt4_idx == prob["answer"]:
            tally["gpt4_correct"] += 1
            tally["gpt4_ourvisual_correct"] += 1

        tally["our_correct"] += our_idx == prob["answer"]

        # the requery answer is submitted when parseable, else our answer
        final_idx = our_idx if requery_answer == "FAILED" else requery_idx
        submitted[pid] = final_idx
        tally["requery_correct"] += final_idx == prob["answer"]

        tally["correct_upperbound"] += (
            gpt4_idx == prob["answer"] or our_idx == prob["answer"])

    total = tally["total"]
    for label, key in [
        ("Our-Correct", "our_correct"),
        ("GPT-4-Correct", "gpt4_correct"),
        ("GPT-4 NO-ANS (RANDOM)", "gpt4_failed"),
        ("GPT-4-OursVisual-Correct", "gpt4_ourvisual_correct"),
        ("Requery-Correct", "requery_correct"),
        ("Correct upper", "correct_upperbound"),
    ]:
        pct = tally[key] / total * 100 if total else 0.0
        print(f"Total: {total}, {label}: {tally[key]}, Accuracy: {pct:.2f}%")

    sqa_results = {
        "acc": tally["requery_correct"] / total * 100 if total else 0.0,
        "correct": tally["requery_correct"],
        "count": total,
        "results": submitted,
        "outputs": {},
    }
    if output_result:
        with open(os.path.expanduser(output_result), "w") as f:
            json.dump(sqa_results, f, indent=2)
    return sqa_results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base-dir", type=str, required=True)
    parser.add_argument("--gpt4-result", type=str, required=True)
    parser.add_argument("--requery-result", type=str, required=True)
    parser.add_argument("--our-result", type=str, required=True)
    parser.add_argument("--output-result", type=str, default=None)
    parser.add_argument("--split", type=str, default="test")
    args = parser.parse_args(argv)
    evaluate(args.base_dir, args.our_result, args.gpt4_result,
             args.requery_result, args.output_result, args.split)


if __name__ == "__main__":
    main()
