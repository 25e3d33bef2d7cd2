"""Score ScienceQA answers against a GPT-4 answer file: the port's own copy
of ``dynamic_llava_tpu/eval/eval_science_qa_gpt4.py``, on the port's own
``eval_science_qa``.

GPT-4's predictions are the primary submission; where GPT-4 gave no
parseable answer, the model's choice is substituted, and an upper bound
counts a problem correct if either got it.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter
from typing import Dict, List, Tuple

from .eval_science_qa import get_pred_idx, parse_strict_answer

OPTIONS = ("A", "B", "C", "D", "E")


def load_split_problems(base_dir: str, split: str) -> Dict[str, Dict]:
    split_ids = json.load(
        open(os.path.join(base_dir, "pid_splits.json")))[split]
    problems = json.load(open(os.path.join(base_dir, "problems.json")))
    return {pid: problems[pid] for pid in split_ids}


def load_jsonl_predictions(path: str) -> Dict[str, Dict]:
    preds = [json.loads(line) for line in open(os.path.expanduser(path))]
    return {p["question_id"]: p for p in preds}


def score_pair(our_text: str, gpt4_text: str, prob: Dict,
               options=OPTIONS) -> Tuple[int, int, bool]:
    """Return (gpt4_pred_idx, our_pred_idx, gpt4_failed) for one problem,
    applying the reference's substitution rule for unparseable GPT-4
    answers."""
    our_idx = get_pred_idx(parse_strict_answer(our_text),
                           prob["choices"], options)
    gpt4_answer = parse_strict_answer(gpt4_text)
    gpt4_failed = gpt4_answer == "FAILED"
    gpt4_idx = our_idx if gpt4_failed else get_pred_idx(
        gpt4_answer, prob["choices"], options)
    return gpt4_idx, our_idx, gpt4_failed


def evaluate(base_dir: str, our_result: str, gpt4_result: str,
             split: str = "test", options=OPTIONS) -> Dict[str, float]:
    split_problems = load_split_problems(base_dir, split)
    ours = load_jsonl_predictions(our_result)
    gpt4 = json.load(open(os.path.expanduser(gpt4_result)))["outputs"]

    tally = Counter()
    for pid, prob in split_problems.items():
        if pid not in ours or pid not in gpt4:
            continue
        gpt4_idx, our_idx, gpt4_failed = score_pair(
            ours[pid]["text"], gpt4[pid], prob, options)
        tally["gpt4_failed"] += gpt4_failed
        tally["correct" if gpt4_idx == prob["answer"] else "incorrect"] += 1
        tally["correct_upperbound"] += (
            gpt4_idx == prob["answer"] or our_idx == prob["answer"])

    total = tally["correct"] + tally["incorrect"]
    report = {
        "total": total,
        "correct": tally["correct"],
        "accuracy": tally["correct"] / total * 100 if total else 0.0,
        "correct_upperbound": tally["correct_upperbound"],
        "accuracy_upperbound":
            tally["correct_upperbound"] / total * 100 if total else 0.0,
        "gpt4_failed": tally["gpt4_failed"],
    }
    print(f"Total: {total}, Correct: {report['correct']}, "
          f"Accuracy: {report['accuracy']:.2f}%")
    print(f"Total: {total}, Correct (upper): {report['correct_upperbound']}, "
          f"Accuracy: {report['accuracy_upperbound']:.2f}%")
    print(f"Total: {total}, GPT-4 NO-ANS (RANDOM): {report['gpt4_failed']}, "
          f"Percentage: {report['gpt4_failed'] / total * 100 if total else 0.0:.2f}%")
    return report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base-dir", type=str, required=True)
    parser.add_argument("--gpt4-result", type=str, required=True)
    parser.add_argument("--our-result", type=str, required=True)
    parser.add_argument("--split", type=str, default="test")
    args = parser.parse_args(argv)
    evaluate(args.base_dir, args.our_result, args.gpt4_result, args.split)


if __name__ == "__main__":
    main()
