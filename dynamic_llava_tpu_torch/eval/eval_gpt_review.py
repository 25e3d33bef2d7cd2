"""GPT-judged pairwise review (LLaVA-bench, MM-Vet, visual QA): the port's
own copy of ``dynamic_llava_tpu/eval/eval_gpt_review.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal).

One engine, ``run_review``, with a context builder a variant (``visual``:
captions and labelled boxes; ``bench``: the caption) and a judge that is any
callable from prompt to review text. The default judge, ``openai_judge``,
needs the ``openai`` package, the network and ``OPENAI_API_KEY``; it imports
``openai`` only when it is called, so a judge of one's own runs offline.
Reviews are written as JSONL; an existing output file is a resume point.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

NUM_SECONDS_TO_SLEEP = 0.5

JUDGE_SYSTEM_PROMPT = (
    "You are a helpful and precise assistant for checking the quality of "
    "the answer."
)


def openai_judge(model: str = "gpt-4-0314", max_tokens: int = 1024) -> Callable:
    import openai

    def get_eval(content: str) -> str:
        while True:
            try:
                response = openai.chat.completions.create(
                    model=model,
                    messages=[
                        {"role": "system", "content": JUDGE_SYSTEM_PROMPT},
                        {"role": "user", "content": content},
                    ],
                    temperature=0.2,
                    max_tokens=max_tokens,
                )
                return response.choices[0].message.content
            except Exception as e:
                print(e)
                time.sleep(NUM_SECONDS_TO_SLEEP)

    return get_eval


def parse_score(review: str) -> List[float]:
    """First line must be 'x y' — two float scores (reference parse logic)."""
    try:
        score_pair = review.split("\n")[0].replace(",", " ")
        sp = score_pair.split(" ")
        if len(sp) == 2:
            return [float(sp[0]), float(sp[1])]
        print("error", review)
        return [-1, -1]
    except Exception as e:
        print(e)
        print("error", review)
        return [-1, -1]


def _visual_context(inst: Dict) -> str:
    """Captions + labelled boxes (eval_gpt_review_visual.py:95-101)."""
    cap_str = "\n".join(inst["captions"])
    box_str = "\n".join(
        f'{b["category"]}: {b["bbox"]}' for b in inst["instances"]
    )
    return f"{cap_str}\n\n{box_str}"


def _bench_context(inst: Dict) -> str:
    """Caption-only context (eval_gpt_review_bench.py:96-99)."""
    caption = inst.get("caption", "")
    return "\n".join(caption) if isinstance(caption, list) else caption


@dataclasses.dataclass(frozen=True)
class ReviewVariant:
    build_context: Callable[[Dict], str]
    category_prefix: str = ""


VARIANTS = {
    "visual": ReviewVariant(_visual_context),
    "bench": ReviewVariant(_bench_context, category_prefix="llava_bench_"),
}


def build_judge_prompt(context: str, question: str, role: str,
                       answer1: str, answer2: str, rule_prompt: str) -> str:
    return (
        f"[Context]\n{context}\n\n"
        f"[Question]\n{question}\n\n"
        f"[{role} 1]\n{answer1}\n\n[End of {role} 1]\n\n"
        f"[{role} 2]\n{answer2}\n\n[End of {role} 2]\n\n"
        f"[System]\n{rule_prompt}\n\n"
    )


def _read_jsonl(path: str) -> List[Dict]:
    with open(os.path.expanduser(path)) as f:
        return [json.loads(line) for line in f if line.strip()]


def run_review(
    question_file: str,
    context_file: str,
    rule_file: str,
    answer_files: List[str],
    output_file: str,
    variant: str = "bench",
    judge: Optional[Callable] = None,
    limit: int = 0,
):
    """Judge answer_files[1] against answer_files[0] question by question."""
    judge = judge or openai_judge()
    spec = VARIANTS[variant]

    questions = _read_jsonl(question_file)
    answers1 = _read_jsonl(answer_files[0])
    answers2 = _read_jsonl(answer_files[1])
    rule_dict = json.load(open(os.path.expanduser(rule_file)))
    image_to_context = {c["image"]: c for c in _read_jsonl(context_file)}

    output_file = os.path.expanduser(output_file)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)) or ".",
                exist_ok=True)
    n_done = len(_read_jsonl(output_file)) if os.path.isfile(output_file) else 0

    with open(output_file, "a") as review_file:
        for idx, (ques, ans1, ans2) in enumerate(
                zip(questions, answers1, answers2)):
            if limit and idx >= limit:
                break
            if idx < n_done:
                print(f"Skipping {idx} as we already have it.")
                continue

            category = spec.category_prefix + ques["category"]
            if category not in rule_dict:
                raise KeyError(
                    f"Visual QA category not found in rule file: {category}.")
            rule = rule_dict[category]

            content = build_judge_prompt(
                context=spec.build_context(image_to_context[ques["image"]]),
                question=ques["text"],
                role=rule["role"],
                answer1=ans1["text"],
                answer2=ans2["text"],
                rule_prompt=rule["prompt"],
            )
            review = judge(content)
            review_file.write(json.dumps({
                "id": idx + 1,
                "question_id": ques["question_id"],
                "answer1_id": ans1.get("answer_id", ans1["question_id"]),
                "answer2_id": ans2.get("answer_id", ans2["question_id"]),
                "category": category,
                "content": review,
                "tuple": parse_score(review),
            }) + "\n")
            review_file.flush()


def main(argv=None, variant: str = "bench"):
    parser = argparse.ArgumentParser(
        description="GPT-judged pairwise answer review.")
    parser.add_argument("-q", "--question", required=True)
    parser.add_argument("-c", "--context", required=True)
    parser.add_argument("-a", "--answer-list", nargs="+", required=True)
    parser.add_argument("-r", "--rule", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--variant", choices=sorted(VARIANTS), default=variant)
    parser.add_argument("--max-tokens", type=int, default=1024)
    parser.add_argument("--limit", type=int, default=0)
    args = parser.parse_args(argv)
    run_review(args.question, args.context, args.rule, args.answer_list,
               args.output, variant=args.variant,
               judge=openai_judge(max_tokens=args.max_tokens),
               limit=args.limit)


if __name__ == "__main__":
    main()
