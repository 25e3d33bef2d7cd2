"""MME benchmark conversion + scoring: the port's own copy of
``dynamic_llava_tpu/eval/eval_mme.py``.

The reference drives MME through scripts shipped with the benchmark
download (its ``scripts/v1_5/eval/mme.sh:13-17`` calls
convert_answer_to_mme.py and eval_tool/calculation.py, neither of which is
in that repo). This module supplies both halves so an MME run is
self-contained:

- ``convert``: join model answers with ground truth (from the
  MME_Benchmark_release_version directory layout, or an annotation JSONL)
  into per-subtask records.
- ``score``: the standard MME metric — per-subtask accuracy, acc+ (both
  questions of an image answered correctly), score = (acc + acc+) * 100,
  and the perception / cognition totals.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List

PERCEPTION_TASKS = (
    "existence", "count", "position", "color", "posters", "celebrity",
    "scene", "landmark", "artwork", "OCR",
)
COGNITION_TASKS = (
    "commonsense_reasoning", "numerical_calculation", "text_translation",
    "code_reasoning",
)


def parse_yes_no(answer: str) -> str:
    """Map free-form model output to yes / no / other (the benchmark's own
    lenient rule: exact match, else look in the first four characters)."""
    ans = answer.lower().strip().replace(".", "")
    if ans in ("yes", "no"):
        return ans
    prefix = ans[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


def _norm_question(text: str) -> str:
    """Canonicalize a question for GT matching: drop the image tag and the
    single-word instruction suffix some LLaVA exports append."""
    text = text.replace("<image>", "").strip()
    suffix = "Answer the question using a single word or phrase."
    if text.endswith(suffix):
        text = text[: -len(suffix)].strip()
    return " ".join(text.split())


def _gt_from_mme_dir(mme_dir: str) -> Dict[str, str]:
    """Read ground truth from the official MME release layout: per-task
    dirs holding question/answer txt files (either next to the images or
    under questions_answers_YN/), one 'question\\tanswer' line per row.
    Keyed by (task, image_stem, normalized question)."""
    gt = {}
    for task in os.listdir(mme_dir):
        task_dir = os.path.join(mme_dir, task)
        if not os.path.isdir(task_dir):
            continue
        qa_dir = os.path.join(task_dir, "questions_answers_YN")
        scan_dir = qa_dir if os.path.isdir(qa_dir) else task_dir
        for fname in os.listdir(scan_dir):
            if not fname.endswith(".txt"):
                continue
            stem = fname[:-4]
            with open(os.path.join(scan_dir, fname)) as f:
                lines = f.readlines()
            for line in lines:
                if "\t" not in line:
                    continue
                question, answer = line.rstrip("\n").split("\t")[:2]
                gt[(task, stem, _norm_question(question))] = answer.strip()
    return gt


def convert_answers(
    question_file: str,
    result_file: str,
    mme_dir: str = None,
    annotation_file: str = None,
) -> List[Dict]:
    """Produce scoreable records {category, image, question, gt, pred}."""
    with open(os.path.expanduser(question_file)) as f:
        questions = {q["question_id"]: q for q in map(json.loads, f)}
    with open(os.path.expanduser(result_file)) as f:
        answers = [json.loads(line) for line in f]

    gt_by_qid: Dict = {}
    if annotation_file:
        with open(os.path.expanduser(annotation_file)) as f:
            annotations = [json.loads(line) for line in f]
        for ann in annotations:
            gt_by_qid[ann["question_id"]] = ann.get(
                "answer", ann.get("label", ann.get("gt")))
    dir_gt = _gt_from_mme_dir(os.path.expanduser(mme_dir)) if mme_dir else {}

    records = []
    for ans in answers:
        q = questions[ans["question_id"]]
        image = q["image"]
        stem = os.path.splitext(os.path.basename(image))[0]
        question_text = q["text"].strip()
        gt = gt_by_qid.get(ans["question_id"])
        if gt is None and dir_gt:
            gt = dir_gt.get((q["category"], stem, _norm_question(q["text"])))
        if gt is None:
            raise KeyError(
                f"no ground truth for question {ans['question_id']} "
                f"({q['category']}/{stem})")
        records.append({
            "category": q["category"],
            "image": image,
            "question": question_text,
            "gt": gt.strip().lower(),
            "pred": ans["text"],
        })
    return records


def score_records(records: Iterable[Dict]) -> Dict:
    """Per-subtask acc / acc+ / score and the perception/cognition totals."""
    by_task = defaultdict(list)
    for r in records:
        by_task[r["category"]].append(r)

    report = {"subtasks": {}, "perception": 0.0, "cognition": 0.0}
    for task, rows in sorted(by_task.items()):
        n_correct = 0
        by_image = defaultdict(list)
        for r in rows:
            ok = parse_yes_no(r["pred"]) == r["gt"]
            n_correct += ok
            by_image[r["image"]].append(ok)
        acc = n_correct / len(rows)
        pairs = [oks for oks in by_image.values()]
        acc_plus = (sum(all(oks) for oks in pairs) / len(pairs)) if pairs else 0.0
        score = (acc + acc_plus) * 100
        report["subtasks"][task] = {
            "acc": acc * 100, "acc_plus": acc_plus * 100, "score": score,
            "n": len(rows),
        }
        if task in PERCEPTION_TASKS:
            report["perception"] += score
        elif task in COGNITION_TASKS:
            report["cognition"] += score
    report["total"] = report["perception"] + report["cognition"]
    return report


def print_report(report: Dict) -> None:
    for task, stats in report["subtasks"].items():
        print(f"{task}: acc {stats['acc']:.2f}  acc+ {stats['acc_plus']:.2f}"
              f"  score {stats['score']:.2f}  (n={stats['n']})")
    print(f"perception: {report['perception']:.2f}")
    print(f"cognition: {report['cognition']:.2f}")
    print(f"total: {report['total']:.2f}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--question-file", required=True)
    parser.add_argument("--result-file", required=True)
    parser.add_argument("--mme-dir", default=None,
                        help="MME_Benchmark_release_version directory")
    parser.add_argument("--annotation-file", default=None,
                        help="JSONL with question_id + answer ground truth")
    parser.add_argument("--output-file", default=None,
                        help="optionally dump the converted records + report")
    args = parser.parse_args(argv)

    records = convert_answers(args.question_file, args.result_file,
                              mme_dir=args.mme_dir,
                              annotation_file=args.annotation_file)
    report = score_records(records)
    print_report(report)
    if args.output_file:
        with open(os.path.expanduser(args.output_file), "w") as f:
            json.dump({"records": records, "report": report}, f, indent=2)


if __name__ == "__main__":
    main()
