"""Answer-format converter: our JSONL -> VQAv2 submission JSON (the
reference's ``scripts/convert_vqav2_for_submission.py``): an own copy of ``dynamic_llava_tpu/eval/convert_vqav2_for_submission.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", type=str, default="./playground/data/eval/vqav2")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--split", type=str, required=True)
    args = parser.parse_args(argv)

    src = os.path.join(args.dir, "answers", args.split, "merge.jsonl")
    test_split = os.path.join(args.dir, f"{args.split}.jsonl")
    dst = os.path.join(args.dir, "answers_upload", args.split, f"{args.ckpt}.json")
    os.makedirs(os.path.dirname(dst), exist_ok=True)

    results = [json.loads(line) for line in open(src)]
    results = {r["question_id"]: r["text"] for r in results}
    test_ids = [json.loads(line)["question_id"] for line in open(test_split)]

    out = []
    for qid in test_ids:
        text = results.get(qid, "")
        if text.endswith("."):
            text = text.rstrip(".")
        out.append({"question_id": qid, "answer": text})
    with open(dst, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(out)} answers -> {dst}")


if __name__ == "__main__":
    main()
