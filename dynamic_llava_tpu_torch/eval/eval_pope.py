"""POPE yes/no scorer: an own copy of ``dynamic_llava_tpu/eval/eval_pope.py``
(the port imports nothing of the JAX package; ``tests/test_torch_config.py``
holds the two equal).

Implements the POPE protocol: map free-form answers to yes/no, then report
the confusion matrix, precision/recall/F1, accuracy and yes-ratio per POPE
category (adversarial / popular / random).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterable, List


def normalize_answer(text: str) -> str:
    """POPE decision rule: look at the first sentence; any of the words
    'no'/'No'/'not' makes it a no, anything else is a yes."""
    first_sentence = text.split(".")[0].replace(",", "")
    words = set(first_sentence.split(" "))
    return "no" if words & {"no", "No", "not"} else "yes"


def score_pope(pred_texts: Iterable[str], labels: Iterable[str]) -> Dict:
    """Confusion-matrix metrics over normalized predictions ('yes' = the
    positive class)."""
    preds = [normalize_answer(t) == "yes" for t in pred_texts]
    truth = [label == "yes" for label in labels]
    if len(preds) != len(truth):
        raise ValueError(f"{len(preds)} predictions vs {len(truth)} labels")

    tp = sum(p and t for p, t in zip(preds, truth))
    fp = sum(p and not t for p, t in zip(preds, truth))
    tn = sum(not p and not t for p, t in zip(preds, truth))
    fn = sum(not p and t for p, t in zip(preds, truth))

    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {
        "tp": tp, "fp": fp, "tn": tn, "fn": fn,
        "accuracy": (tp + tn) / len(preds) if preds else 0.0,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": sum(preds) / len(preds) if preds else 0.0,
    }


def report(metrics: Dict) -> None:
    print(f"TP {metrics['tp']}  FP {metrics['fp']}  "
          f"TN {metrics['tn']}  FN {metrics['fn']}")
    for key in ("accuracy", "precision", "recall", "f1", "yes_ratio"):
        print(f"{key}: {metrics[key]}")
    print(", ".join("%.3f" % metrics[k]
                    for k in ("f1", "accuracy", "precision", "recall",
                              "yes_ratio")))


def eval_pope(answers: List[Dict], label_file: str) -> Dict:
    """Score one category's answers against its annotation file."""
    labels = [json.loads(line)["label"] for line in open(label_file)]
    metrics = score_pope((a["text"] for a in answers), labels)
    report(metrics)
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-dir", type=str, required=True)
    parser.add_argument("--question-file", type=str, required=True)
    parser.add_argument("--result-file", type=str, required=True)
    args = parser.parse_args(argv)

    question_category = {
        q["question_id"]: q["category"]
        for q in (json.loads(line) for line in open(args.question_file))
    }
    answers = [json.loads(line) for line in open(args.result_file)]

    for fname in sorted(os.listdir(args.annotation_dir)):
        if not (fname.startswith("coco_pope_") and fname.endswith(".json")):
            continue
        category = fname[len("coco_pope_"):-len(".json")]
        cur = [a for a in answers
               if question_category[a["question_id"]] == category]
        print(f"Category: {category}, # samples: {len(cur)}")
        eval_pope(cur, os.path.join(args.annotation_dir, fname))
        print("=" * 36)


if __name__ == "__main__":
    main()
