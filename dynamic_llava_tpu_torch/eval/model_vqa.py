"""Loop VQA generator (MM-Vet / LLaVA-bench): the port's counterpart of
``dynamic_llava_tpu/eval/model_vqa.py`` (the reference's
``llava/dynamic_eval/model_vqa.py``).

A question file (JSONL: ``question_id``, ``image``, ``text``) -> the loop
of ``model_vqa_loader`` (the conversation-template prompt, one
``Generator.generate`` a question; ``--spec_k``: speculative, the same
greedy answers) -> an answers JSONL with a random ``answer_id`` each. Only
the flags' defaults differ from ``model_vqa_loader`` (1024 new tokens).

    python -m dynamic_llava_tpu_torch.eval.model_vqa --model-path CKPT_DIR \\
        --image-folder IMAGES --question-file Q.jsonl --answers-file A.jsonl
"""

from __future__ import annotations

import argparse
import uuid

from . import model_vqa_loader
from .model_vqa_loader import add_port_flags


def eval_model(args, loaded=None) -> None:
    """Answer ``args.question_file`` (this chunk of it) into
    ``args.answers_file``: ``model_vqa_loader.eval_model``'s loop, with a
    random ``answer_id`` a record; ``loaded`` as there."""
    model_vqa_loader.eval_model(args, loaded, answer_id=lambda: uuid.uuid4().hex)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", type=str, required=True)
    p.add_argument("--model-base", dest="model_base", type=str, default=None)
    p.add_argument("--image-folder", dest="image_folder", type=str, default="")
    p.add_argument("--question-file", dest="question_file", type=str, required=True)
    p.add_argument("--answers-file", dest="answers_file", type=str, default="answer.jsonl")
    p.add_argument("--conv-mode", dest="conv_mode", type=str, default="vicuna_v1")
    p.add_argument("--num-chunks", dest="num_chunks", type=int, default=1)
    p.add_argument("--chunk-idx", dest="chunk_idx", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--max_new_tokens", type=int, default=1024)
    return add_port_flags(p)


def main(argv=None) -> None:
    eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
