"""Single-query runner that reports generation time + self-PPL: the port's
counterpart of ``dynamic_llava_tpu/eval/run_llava_for_ppl.py`` (the
reference's ``llava/eval/run_llava_for_ppl.py``): answer one query about
one (or several comma-separated) images and print the wall-clock
generation time, the answer text, and the mean self-perplexity of the
generated tokens (``self_ppl.generate_with_self_ppl``).

    python -m dynamic_llava_tpu_torch.eval.run_llava_for_ppl --model-path CKPT_DIR \\
        --image-file IMAGE --query "Describe the image." [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .model_vqa_loader import add_device_flag, load
from .self_ppl import generate_with_self_ppl


def eval_model(args, loaded=None):
    """The result of ``generate_with_self_ppl`` for ``args.query``;
    ``loaded`` as in ``model_vqa_loader.load``."""
    from PIL import Image

    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates
    from ..mm_utils import get_model_name_from_path, process_images, tokenizer_image_token

    tokenizer, runtime, image_processor, _ = load(args, loaded)
    model_name = get_model_name_from_path(args.model_path)

    qs = args.query
    if DEFAULT_IMAGE_TOKEN not in qs:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + qs

    if args.conv_mode is None:
        # the reference's auto-dispatch on the model name
        name = model_name.lower()
        if "llama-2" in name:
            args.conv_mode = "llava_llama_2"
        elif "mistral" in name:
            args.conv_mode = "mistral_instruct"
        elif "v1" in name:
            args.conv_mode = "llava_v1"
        elif "mpt" in name:
            args.conv_mode = "mpt"
        else:
            args.conv_mode = "llava_v0"

    conv = conv_templates[args.conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    input_ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64)

    images = [Image.open(p).convert("RGB") for p in args.image_file.split(args.sep)]
    pixels = process_images(images, image_processor, runtime.cfg)

    start = time.time()
    result = generate_with_self_ppl(
        runtime, tokenizer, input_ids, pixels,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature)
    print("time:\n", time.time() - start)
    print("text:\n" + result["text"])
    print("mean perplexity:\n" + str(result["self_ppl"]))
    return result


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", required=True)
    p.add_argument("--model-base", dest="model_base", default=None)
    p.add_argument("--image-file", dest="image_file", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--conv-mode", dest="conv_mode", default=None)
    p.add_argument("--sep", default=",")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max_new_tokens", type=int, default=512)
    return add_device_flag(p)


def main(argv=None):
    return eval_model(parser().parse_args(argv))


if __name__ == "__main__":
    main()
