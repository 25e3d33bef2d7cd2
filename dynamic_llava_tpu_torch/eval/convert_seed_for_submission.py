"""Converter + scorer for SEED-Bench (the reference's
``scripts/convert_seed_for_submission.py``): an own copy of ``dynamic_llava_tpu/eval/convert_seed_for_submission.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

import argparse
import json


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-file", type=str, required=True)
    parser.add_argument("--result-file", type=str, required=True)
    parser.add_argument("--result-upload-file", type=str, required=True)
    return parser.parse_args(argv)


def eval_single(result_file, eval_only_type=None):
    results = {}
    for line in open(result_file):
        row = json.loads(line)
        results[row["question_id"]] = row
    return results


def main(argv=None):
    args = get_args(argv)
    annos = json.load(open(args.annotation_file))["questions"]
    annos = {q["question_id"]: q for q in annos}
    results = eval_single(args.result_file)

    type_counts = {}
    correct_counts = {}
    uploads = []
    for qid, row in results.items():
        anno = annos.get(qid)
        if anno is None:
            continue
        dtype = anno["question_type_id"]
        type_counts[dtype] = type_counts.get(dtype, 0) + 1
        pred = row["text"].strip().rstrip(".").upper()[:1]
        if pred == anno["answer"]:
            correct_counts[dtype] = correct_counts.get(dtype, 0) + 1
        uploads.append({"question_id": qid, "prediction": pred})

    total = sum(type_counts.values())
    correct = sum(correct_counts.values())
    if total:
        print(f"Total: {total}, Correct: {correct}, "
              f"Accuracy: {100. * correct / total:.2f}%")
    for t in sorted(type_counts):
        c = correct_counts.get(t, 0)
        print(f"type {t}: {100. * c / type_counts[t]:.2f}% ({c}/{type_counts[t]})")
    with open(args.result_upload_file, "w") as f:
        for rec in uploads:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
