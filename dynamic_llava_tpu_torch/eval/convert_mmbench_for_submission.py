"""Converter: answers JSONL -> MMBench submission xlsx (the reference's
``scripts/convert_mmbench_for_submission.py``; ``pandas`` is imported
where it is used): an own copy of ``dynamic_llava_tpu/eval/convert_mmbench_for_submission.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-file", type=str, required=True)
    parser.add_argument("--result-dir", type=str, required=True)
    parser.add_argument("--upload-dir", type=str, required=True)
    parser.add_argument("--experiment", type=str, required=True)
    args = parser.parse_args(argv)

    import pandas as pd

    df = pd.read_table(args.annotation_file)
    cur_df = df.copy()
    cur_df = cur_df.drop(
        columns=[c for c in ("hint", "category", "source", "image", "comment",
                             "l2-category") if c in cur_df.columns]
    )
    cur_df.insert(6, "prediction", None)
    for pred in open(os.path.join(args.result_dir, f"{args.experiment}.jsonl")):
        pred = json.loads(pred)
        cur_df.loc[df["index"] == pred["question_id"], "prediction"] = pred["text"]

    os.makedirs(args.upload_dir, exist_ok=True)
    cur_df.to_excel(
        os.path.join(args.upload_dir, f"{args.experiment}.xlsx"),
        index=False, engine="openpyxl",
    )


if __name__ == "__main__":
    main()
