"""Text-only QA answer generator (no images): the port's counterpart of
``dynamic_llava_tpu/eval/model_qa.py`` (the reference's
``llava/eval/model_qa.py:14-63``): answers a question JSONL with the
language model alone through the default conversation template, the
baseline side of the text-only GPT reviews.

    python -m dynamic_llava_tpu_torch.eval.model_qa --model-path CKPT_DIR \\
        --question-file Q.jsonl --answers-file A.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import uuid

import numpy as np

from .model_vqa_loader import add_port_flags, answer, load


def eval_model(args, loaded=None) -> None:
    """Answer ``args.question_file`` into ``args.answers_file``; ``loaded``
    as in ``model_vqa_loader.load``."""
    from .. import conversation as conversation_lib
    from ..generation.generate import GenerationConfig, Generator

    tokenizer, runtime, _, _ = load(args, loaded)
    gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        eos_token_id=tokenizer.eos_token_id,
    ))
    with open(os.path.expanduser(args.question_file)) as f:
        questions = [json.loads(line) for line in f]
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    with open(answers_file, "w") as ans_file:
        for line in questions:
            conv = conversation_lib.default_conversation.copy()
            conv.append_message(conv.roles[0], line["text"])
            conv.append_message(conv.roles[1], None)
            input_ids = np.asarray(tokenizer(conv.get_prompt()).input_ids, np.int64)
            ans_file.write(json.dumps({
                "question_id": line["question_id"],
                "text": answer(gen, tokenizer, input_ids, None, args.spec_k, args.temperature),
                "answer_id": uuid.uuid4().hex,
                "model_id": args.model_path.split("/")[-1],
                "metadata": {},
            }) + "\n")
            ans_file.flush()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", required=True)
    p.add_argument("--model-base", dest="model_base", default=None)
    p.add_argument("--question-file", dest="question_file", required=True)
    p.add_argument("--answers-file", dest="answers_file", default="answer.jsonl")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--max_new_tokens", type=int, default=1024)
    return add_port_flags(p)


def main(argv=None) -> None:
    eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
