"""Interactive chat CLI: the port's counterpart of
``dynamic_llava_tpu/serve/cli.py``.

Load a checkpoint, preprocess one image, then chat: round 1 prefills the
image and the first question, every later round feeds only its new text
through ``ChatSession`` (one live KV cache; the continuation runs K2-M).

    python -m dynamic_llava_tpu_torch.serve.cli --model-path CKPT_DIR \\
        --image-file IMAGE [--temperature 0] [--device cpu]

``chat_loop`` is the loop without stdin: it takes the turns as a list, so
a test or a script drives the same code the CLI runs.
"""

from __future__ import annotations

import argparse
from typing import Callable, Iterable, List

import numpy as np


def load_image(image_file: str):
    from io import BytesIO

    from PIL import Image

    if image_file.startswith(("http://", "https://")):
        import requests

        resp = requests.get(image_file)
        return Image.open(BytesIO(resp.content)).convert("RGB")
    return Image.open(image_file).convert("RGB")


def conv_mode_for(model_name: str) -> str:
    """The conversation template a model name implies."""
    name = model_name.lower()
    if "llama-2" in name:
        return "llava_llama_2"
    if "mpt" in name:
        return "mpt"
    if "v1" in name or "dynamic" in name:
        return "llava_v1"
    return "llava_v0"


def chat_loop(tokenizer, runtime, image_processor, pixels, turns: Iterable[str],
              conv_mode: str = "llava_v1", temperature: float = 0.2,
              max_new_tokens: int = 512, debug: bool = False,
              echo: Callable[..., None] = print) -> List[str]:
    """Chat over ``turns`` (the user's messages, in order) about one image
    and return the answers. ``pixels`` is a preprocessed ``[1, H, W, 3]``
    array or an image for ``image_processor``. The first turn carries the
    image; each answer is ``echo``-ed as the CLI prints it."""
    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import SeparatorStyle, conv_templates
    from ..generation.generate import ChatSession, GenerationConfig, Generator
    from ..mm_utils import KeywordsStoppingCriteria, process_images, tokenizer_image_token

    if not isinstance(pixels, np.ndarray):
        pixels = process_images([pixels], image_processor, runtime.cfg)
    conv = conv_templates[conv_mode].copy()
    gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
        max_new_tokens=max_new_tokens, temperature=temperature,
        eos_token_id=tokenizer.eos_token_id))
    # one live KV cache: round 1 prefills, later rounds feed only the new
    # chunk through the continuation
    session = ChatSession(gen, max_new_tokens_total=runtime.cfg.model_max_length)
    answers: List[str] = []
    prev_prompt = ""
    for inp in turns:
        echo(f"{conv.roles[1]}: ", end="", flush=True)
        first_turn = not answers
        if first_turn:
            inp = DEFAULT_IMAGE_TOKEN + "\n" + inp
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()
        stop_str = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
        stopping = KeywordsStoppingCriteria([stop_str], tokenizer, 0)
        if first_turn:
            input_ids = np.asarray(tokenizer_image_token(prompt, tokenizer), np.int64)
            out_ids = session.ask(input_ids, pixels, stopping_criteria=stopping)
        else:
            # only the text since the last rendered prompt, without BOS
            chunk = np.asarray(tokenizer(prompt[len(prev_prompt):]).input_ids, np.int64)
            if len(chunk) and chunk[0] == tokenizer.bos_token_id:
                chunk = chunk[1:]
            out_ids = session.ask(chunk, stopping_criteria=stopping)
        outputs = tokenizer.decode(out_ids, skip_special_tokens=True).strip()
        if outputs.endswith(stop_str):
            outputs = outputs[: -len(stop_str)].strip()
        echo(outputs)
        answers.append(outputs)
        conv.messages[-1][-1] = outputs
        prev_prompt = conv.get_prompt()
        if debug:
            echo("\n", {"prompt": prompt, "outputs": outputs}, "\n")
    return answers


def _stdin_turns(role: str):
    """The user's messages from stdin until an empty line or EOF."""
    while True:
        try:
            inp = input(f"{role}: ")
        except EOFError:
            inp = ""
        if not inp:
            print("exit...")
            return
        yield inp


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", dest="model_path", type=str, required=True)
    parser.add_argument("--model-base", dest="model_base", type=str, default=None)
    parser.add_argument("--image-file", dest="image_file", type=str, required=True)
    parser.add_argument("--conv-mode", dest="conv_mode", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--max-new-tokens", dest="max_new_tokens", type=int, default=512)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card; 'cpu' runs the plain PyTorch versions")
    args = parser.parse_args(args)

    from ..conversation import conv_templates
    from ..mm_utils import get_model_name_from_path
    from ..models.builder import load_pretrained_model

    model_name = get_model_name_from_path(args.model_path)
    tokenizer, runtime, image_processor, _ = load_pretrained_model(
        args.model_path, args.model_base, model_name, device=args.device)
    conv_mode = args.conv_mode or conv_mode_for(model_name)
    role = conv_templates[conv_mode].roles[0]
    chat_loop(tokenizer, runtime, image_processor, load_image(args.image_file),
              _stdin_turns(role), conv_mode=conv_mode, temperature=args.temperature,
              max_new_tokens=args.max_new_tokens, debug=args.debug)


if __name__ == "__main__":
    main()
