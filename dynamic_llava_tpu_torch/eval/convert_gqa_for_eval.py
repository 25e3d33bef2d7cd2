"""Answer-format converter: our JSONL -> GQA official eval JSON (the
reference's ``scripts/convert_gqa_for_eval.py``): an own copy of ``dynamic_llava_tpu/eval/convert_gqa_for_eval.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--dst", type=str, required=True)
    args = parser.parse_args(argv)

    all_answers = []
    for line in open(args.src):
        res = json.loads(line)
        all_answers.append(
            {
                "questionId": res["question_id"],
                "prediction": res["text"].rstrip(".").lower(),
            }
        )
    with open(args.dst, "w") as f:
        json.dump(all_answers, f)


if __name__ == "__main__":
    main()
