"""Converter: answers JSONL -> VizWiz submission JSON (the reference's
``scripts/convert_vizwiz_for_submission.py``) on the port's own
``vqa_metrics``: an own copy of ``dynamic_llava_tpu/eval/convert_vizwiz_for_submission.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

import argparse
import json

from .vqa_metrics import VQAAnswerProcessor


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-file", type=str, required=True)
    parser.add_argument("--result-file", type=str, required=True)
    parser.add_argument("--result-upload-file", type=str, required=True)
    args = parser.parse_args(argv)

    results = [json.loads(line) for line in open(args.result_file)]
    results = {r["question_id"]: r["text"] for r in results}
    annos = json.load(open(args.annotation_file))
    processor = VQAAnswerProcessor()

    out = []
    for anno in annos:
        qid = anno["image"]
        out.append({
            "image": qid,
            "answer": processor(results.get(anno["question_id"], "")),
        })
    with open(args.result_upload_file, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(out)} answers")


if __name__ == "__main__":
    main()
