"""LLaVA-bench (in the wild) GPT review, caption context and ``llava_bench_``
rules: the port's own copy of ``dynamic_llava_tpu/eval/eval_gpt_review_bench.py``;
the logic is ``eval_gpt_review.run_review(variant="bench")``.
"""

from .eval_gpt_review import main as _main


def main(argv=None):
    _main(argv, variant="bench")


if __name__ == "__main__":
    main()
