"""Batch VQA answer generator (VQAv2 / GQA / TextVQA / POPE / VizWiz): the
port's counterpart of ``dynamic_llava_tpu/eval/model_vqa_loader.py``.

A question file (JSONL: ``question_id``, ``image``, ``text``) -> a
conversation-template prompt a question -> greedy ``Generator.generate``
(or, with ``--spec_k`` and temperature 0, ``generate_speculative``: the
same answers through verify rounds of 1 + k candidates) -> an answers
JSONL that ``eval/eval_pope.py`` scores. ``--num-chunks`` / ``--chunk-idx``
shard the questions across processes.

    python -m dynamic_llava_tpu_torch.eval.model_vqa_loader --model-path CKPT_DIR \\
        --image-folder IMAGES --question-file Q.jsonl --answers-file A.jsonl
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np


def split_list(lst, n):
    chunk_size = math.ceil(len(lst) / n)
    return [lst[i : i + chunk_size] for i in range(0, len(lst), chunk_size)]


def get_chunk(lst, n, k):
    return split_list(lst, n)[k]


def build_prompt(question: str, conv_mode: str, mm_use_im_start_end: bool) -> str:
    from ..constants import DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN, DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates

    if mm_use_im_start_end:
        qs = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN
              + "\n" + question)
    else:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + question
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def answer(gen, tokenizer, input_ids, pixels, spec_k: int = 0,
           temperature: float = 0.0) -> str:
    """One answer's text: ``gen.generate`` (``generate_speculative`` with
    ``spec_k`` > 0 at temperature 0: the same greedy answer through verify
    rounds of 1 + k candidates), a final EOS dropped, decoded without the
    special tokens. ``pixels`` is None for a text-only prompt."""
    if spec_k > 0 and temperature <= 0.0:
        out_ids = gen.generate_speculative([input_ids], pixels, draft_k=spec_k)[0]
    else:
        out_ids = gen.generate([input_ids], pixels)[0]
    if out_ids and out_ids[-1] == tokenizer.eos_token_id:
        out_ids = out_ids[:-1]
    return tokenizer.decode(out_ids, skip_special_tokens=True).strip()


def eval_model(args, loaded=None, answer_id=lambda: None) -> None:
    """Answer ``args.question_file``'s questions (this chunk of them) into
    ``args.answers_file``. ``loaded`` is ``load_pretrained_model``'s tuple
    where the caller has loaded the model already (or brings its own
    tokenizer); else the model is loaded from ``args.model_path``. Each
    record's ``answer_id`` is ``answer_id()`` (``model_vqa``: a random
    uuid)."""
    from PIL import Image

    from ..generation.generate import GenerationConfig, Generator
    from ..mm_utils import process_images, tokenizer_image_token

    tokenizer, runtime, image_processor, _ = load(args, loaded)
    with open(os.path.expanduser(args.question_file)) as f:
        questions = [json.loads(q) for q in f]
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=args.top_p if args.top_p is not None else 1.0,
        eos_token_id=tokenizer.eos_token_id,
    ))
    with open(answers_file, "w") as ans_file:
        for line in questions:
            prompt_text = build_prompt(line["text"], args.conv_mode,
                                       runtime.cfg.mm_use_im_start_end)
            input_ids = np.asarray(tokenizer_image_token(prompt_text, tokenizer), np.int64)
            image = Image.open(os.path.join(args.image_folder, line["image"])).convert("RGB")
            pixels = process_images([image], image_processor, runtime.cfg)
            outputs = answer(gen, tokenizer, input_ids, pixels, args.spec_k, args.temperature)
            ans_file.write(json.dumps({
                "question_id": line["question_id"],
                "prompt": line["text"],
                "text": outputs,
                "answer_id": answer_id(),
                "model_id": args.model_path.split("/")[-1],
                "metadata": {},
            }) + "\n")
            ans_file.flush()


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
    p.add_argument("--max_new_tokens", type=int, default=128)
    return add_port_flags(p)


def add_port_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags every generator of the port has beyond the JAX one's:
    ``--spec_k`` and ``--device``."""
    p.add_argument("--spec_k", type=int, default=0,
                   help="speculative decoding for greedy runs: verify 1+k candidates per "
                        "pass (0 = off)")
    return add_device_flag(p)


def add_device_flag(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--device``: the card by default (raises where there is none)."""
    p.add_argument("--device", type=str, default=None,
                   help="default: the card; 'cpu' runs the plain PyTorch versions")
    return p


def load(args, loaded=None):
    """``loaded`` (``load_pretrained_model``'s tuple, where the caller has
    loaded the model already or brings its own tokenizer), else the model
    at ``args.model_path`` over ``args.model_base`` on ``args.device``."""
    from ..models.builder import load_pretrained_model

    if loaded is None:
        loaded = load_pretrained_model(args.model_path, args.model_base, device=args.device)
    return loaded


def main(argv=None) -> None:
    eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
