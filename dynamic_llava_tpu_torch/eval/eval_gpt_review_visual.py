"""Visual-QA GPT review, captions and labelled boxes as the judge's
context: the port's own copy of
``dynamic_llava_tpu/eval/eval_gpt_review_visual.py``; the logic is
``eval_gpt_review.run_review(variant="visual")``.
"""

from .eval_gpt_review import main as _main


def main(argv=None):
    _main(argv, variant="visual")


if __name__ == "__main__":
    main()
