"""Aggregate GPT pairwise-review scores per category (the reference's
``summarize_gpt_review.py`` report, per category the relative score and
both means on a 0-10 scale, returned as a structure): an own copy of ``dynamic_llava_tpu/eval/summarize_gpt_review.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional


def _category_of(review: Dict) -> str:
    if "category" in review:
        return review["category"]
    return "_".join(review.get("tuple_category", ["all"]))


def summarize_file(review_file: str,
                   ignore: Optional[List[int]] = None) -> Dict[str, Dict]:
    """Per-category score summary of one review JSONL.

    Returns {category: {relative, score1, score2, n}} where relative is
    mean(score2)/mean(score1) as a percentage and scoreN are 0-10 means.
    """
    sums = defaultdict(lambda: [0.0, 0.0, 0])
    with open(review_file) as f:
        for line in f:
            review = json.loads(line)
            if ignore and review.get("question_id") in ignore:
                continue
            s1, s2 = review["tuple"]
            for cat in (_category_of(review), "all"):
                entry = sums[cat]
                entry[0] += s1
                entry[1] += s2
                entry[2] += 1

    summary = {}
    for cat, (sum1, sum2, n) in sums.items():
        mean1, mean2 = round(sum1 / n, 3), round(sum2 / n, 3)
        summary[cat] = {
            "relative": round(mean2 / mean1 * 100, 1) if mean1 else 0.0,
            "score1": round(mean1 * 10, 1),
            "score2": round(mean2 * 10, 1),
            "n": n,
        }
    return summary


def summarize(review_files: List[str], ignore: Optional[List[int]] = None,
              select: Optional[List[str]] = None) -> Dict[str, Dict]:
    all_summaries = {}
    for review_file in sorted(review_files):
        config = os.path.basename(review_file)
        config = config.replace("gpt4_text_", "").replace(".jsonl", "")
        if select is not None and any(x not in config for x in select):
            continue
        print(config)
        summary = summarize_file(review_file, ignore=ignore)
        all_summaries[config] = summary
        for cat in sorted(summary):
            s = summary[cat]
            print(cat, s["relative"], s["score1"], s["score2"])
        print("=" * 33)
    return all_summaries


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", "--dir", default=None)
    parser.add_argument("-v", "--version", default=None)
    parser.add_argument("-s", "--select", nargs="*", default=None)
    parser.add_argument("-f", "--files", nargs="*", default=[])
    parser.add_argument("-i", "--ignore", nargs="*", default=None)
    args = parser.parse_args(argv)

    ignore = [int(x) for x in args.ignore] if args.ignore else None
    if args.dir is not None:
        review_files = [
            os.path.join(args.dir, f)
            for f in os.listdir(args.dir)
            if f.endswith(".jsonl")
            and (args.version is None or args.version in f)
        ]
    else:
        review_files = args.files
    summarize(review_files, ignore=ignore, select=args.select)


if __name__ == "__main__":
    main()
