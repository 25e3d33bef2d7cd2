"""Converter: ScienceQA problems -> LLaVA eval question format (the
reference's ``scripts/convert_sqa_to_llava.py``, QCM-A prompt): an own copy of ``dynamic_llava_tpu/eval/convert_sqa_to_llava.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

import argparse
import json
import os


def get_question_text(problem):
    return problem["question"]


def get_context_text(problem, use_caption=False):
    txt_context = problem.get("hint", "")
    img_context = problem.get("caption", "") if use_caption else ""
    context = " ".join([txt_context, img_context]).strip()
    return context if context else "N/A"


def get_choice_text(problem, options=("A", "B", "C", "D", "E")):
    return " ".join(
        f"({options[i]}) {c}" for i, c in enumerate(problem["choices"])
    )


def build_prompt_qcma(problem) -> str:
    question = get_question_text(problem)
    context = get_context_text(problem)
    choices = get_choice_text(problem)
    return (
        f"Question: {question}\nContext: {context}\nOptions: {choices}\n"
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base-dir", type=str, required=True)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--output-file", type=str, required=True)
    args = parser.parse_args(argv)

    problems = json.load(open(os.path.join(args.base_dir, "problems.json")))
    split_ids = json.load(
        open(os.path.join(args.base_dir, "pid_splits.json"))
    )[args.split]

    out = []
    for pid in split_ids:
        problem = problems[pid]
        record = {
            "id": pid,
            "conversations": [
                {"from": "human", "value": build_prompt_qcma(problem)},
                {"from": "gpt", "value": ""},
            ],
        }
        if problem.get("image"):
            record["image"] = os.path.join(pid, problem["image"])
            record["conversations"][0]["value"] = (
                "<image>\n" + record["conversations"][0]["value"]
            )
        out.append(record)
    with open(args.output_file, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {len(out)} questions")


if __name__ == "__main__":
    main()
