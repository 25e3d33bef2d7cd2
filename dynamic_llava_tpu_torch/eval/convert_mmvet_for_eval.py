"""Converter: answers JSONL -> MM-Vet grading JSON (the reference's
``scripts/convert_mmvet_for_eval.py``): an own copy of ``dynamic_llava_tpu/eval/convert_mmvet_for_eval.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--dst", type=str, required=True)
    args = parser.parse_args(argv)

    results = {}
    for line in open(args.src):
        data = json.loads(line)
        results[f"v1_{data['question_id']}"] = data["text"]
    with open(args.dst, "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
