"""ScienceQA scorer: the port's own copy of
``dynamic_llava_tpu/eval/eval_science_qa.py``.

Scores answer JSONL against the ScienceQA problem set. The PARSE/SCORE
rules are the benchmark's spec (the reference's
``llava/dynamic_eval/eval_science_qa.py``: 'The answer is X.' extraction,
leading-letter fallback, random choice for unparseable answers, overall +
image-subset accuracy); the harness is structured ``score_sqa`` returns,
per-problem ``SqaJudgment`` records, a report printer and a thin CLI, in
the same idiom as ``eval_pope``.

    python -m dynamic_llava_tpu_torch.eval.eval_science_qa --base-dir SQA_DIR \
        --result-file answers.jsonl --output-file out.json --output-result res.json
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
from typing import Dict, NamedTuple, Optional, Sequence

DEFAULT_OPTIONS = ("A", "B", "C", "D", "E")


def parse_answer(text: str, options=DEFAULT_OPTIONS) -> str:
    """Extract 'The answer is X.' or a bare leading option letter."""
    m = re.search(r"The answer is ([A-E])", text)
    if m:
        return m.group(1)
    m = re.match(r"^\(?([A-E])\)?[.,:]?(\s|$)", text.strip())
    if m:
        return m.group(1)
    return "FAILED"


def parse_strict_answer(text: str) -> str:
    """Only accept exactly one 'The answer is X.' occurrence — the stricter
    rule the GPT-4 comparison scorers apply (reference
    eval_science_qa_gpt4.py:62-72)."""
    found = re.findall(r"The answer is ([A-Z]).", text)
    return found[0] if len(found) == 1 else "FAILED"


def get_pred_idx(prediction: str, choices, options=DEFAULT_OPTIONS) -> int:
    """Map the model's letter answer to a choice index; random on failure
    (matching the reference's scoring of unparseable answers)."""
    if prediction in options[: len(choices)]:
        return options.index(prediction)
    return random.choice(range(len(choices)))


class SqaJudgment(NamedTuple):
    """One scored problem."""

    question_id: str
    parsed_ans: str
    pred_idx: int
    ground_truth: str
    question: str
    pred: str
    is_multimodal: bool
    correct: bool

    def analysis(self) -> Dict:
        """The per-problem record the reference writes to --output-file."""
        return {
            "question_id": self.question_id,
            "parsed_ans": self.parsed_ans,
            "ground_truth": self.ground_truth,
            "question": self.question,
            "pred": self.pred,
            "is_multimodal": self.is_multimodal,
        }


def judge_problem(
    prob_id: str,
    prob: Dict,
    pred: Optional[Dict],
    options: Sequence[str] = DEFAULT_OPTIONS,
) -> SqaJudgment:
    """Score one problem. A missing prediction counts as FAILED (and then a
    random choice), per the reference protocol."""
    pred = pred or {"text": "FAILED", "prompt": "Unknown"}
    text = pred["text"]
    answer = parse_answer(text, options)
    idx = get_pred_idx(answer, prob["choices"], options)
    return SqaJudgment(
        question_id=prob_id,
        parsed_ans=answer,
        pred_idx=idx,
        ground_truth=options[prob["answer"]],
        question=pred.get("prompt", ""),
        pred=text,
        is_multimodal="<image>" in pred.get("prompt", ""),
        correct=idx == prob["answer"],
    )


def score_sqa(
    problems: Dict[str, Dict],
    predictions: Dict[str, Dict],
    options: Sequence[str] = DEFAULT_OPTIONS,
) -> Dict:
    """Judge every problem; returns {'acc', 'img_acc', 'correct', 'count',
    'judgments'} (accuracies in percent, like the reference prints)."""
    judgments = [
        judge_problem(pid, prob, predictions.get(pid), options)
        for pid, prob in problems.items()
    ]
    correct = sum(j.correct for j in judgments)
    mm = [j for j in judgments if j.is_multimodal]
    mm_correct = sum(j.correct for j in mm)
    return {
        "acc": 100.0 * correct / len(judgments) if judgments else 0.0,
        "img_acc": 100.0 * mm_correct / len(mm) if mm else 0.0,
        "correct": correct,
        "count": len(judgments),
        "img_correct": mm_correct,
        "img_count": len(mm),
        "judgments": judgments,
    }


def load_split(base_dir: str, split: str) -> Dict[str, Dict]:
    with open(os.path.join(base_dir, "pid_splits.json")) as f:
        split_indices = json.load(f)[split]
    with open(os.path.join(base_dir, "problems.json")) as f:
        problems = json.load(f)
    return {idx: problems[idx] for idx in split_indices}


def load_predictions(result_file: str) -> Dict[str, Dict]:
    with open(result_file) as f:
        preds = [json.loads(line) for line in f]
    return {p["question_id"]: p for p in preds}


def report(scores: Dict) -> None:
    line = (
        f"Total: {scores['count']}, Correct: {scores['correct']}, "
        f"Accuracy: {scores['acc']:.2f}%"
    )
    if scores["img_count"]:
        line += f", IMG-Accuracy: {scores['img_acc']:.2f}%"
    print(line)


def write_outputs(scores: Dict, output_file: Optional[str],
                  output_result: Optional[str]) -> None:
    """Persist the two reference-format artifacts: the correct/incorrect
    analysis split and the sqa_results index."""
    if output_file:
        split = {"correct": [], "incorrect": []}
        for j in scores["judgments"]:
            split["correct" if j.correct else "incorrect"].append(j.analysis())
        with open(output_file, "w") as f:
            json.dump(split, f, indent=2)
    if output_result:
        sqa_results = {
            "acc": scores["acc"],
            "correct": scores["correct"],
            "count": scores["count"],
            "results": {j.question_id: j.pred_idx for j in scores["judgments"]},
            "outputs": {j.question_id: j.pred for j in scores["judgments"]},
        }
        with open(output_result, "w") as f:
            json.dump(sqa_results, f, indent=2)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base-dir", type=str)
    parser.add_argument("--result-file", type=str)
    parser.add_argument("--output-file", type=str)
    parser.add_argument("--output-result", type=str)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--options", nargs="+", default=list(DEFAULT_OPTIONS))
    args = parser.parse_args(argv)

    scores = score_sqa(
        load_split(args.base_dir, args.split),
        load_predictions(args.result_file),
        args.options,
    )
    report(scores)
    write_outputs(scores, args.output_file, args.output_result)


if __name__ == "__main__":
    main()
