"""Single image / query runner: the port's counterpart of
``dynamic_llava_tpu/eval/run_dynamic_llava.py``.

    python -m dynamic_llava_tpu_torch.eval.run_dynamic_llava --model-path CKPT_DIR \\
        --image-file IMAGE --query "What is in the image?" [--device cpu]
"""

from __future__ import annotations

import argparse
import re

import numpy as np


def image_parser(args):
    return args.image_file.split(args.sep)


def eval_model(args) -> str:
    from ..constants import (
        DEFAULT_IM_END_TOKEN,
        DEFAULT_IM_START_TOKEN,
        DEFAULT_IMAGE_TOKEN,
        IMAGE_PLACEHOLDER,
    )
    from ..conversation import conv_templates
    from ..generation.generate import GenerationConfig, Generator
    from ..mm_utils import get_model_name_from_path, process_images, tokenizer_image_token
    from ..models.builder import load_pretrained_model
    from ..serve.cli import load_image

    model_name = args.model_name or get_model_name_from_path(args.model_path)
    tokenizer, runtime, image_processor, _ = load_pretrained_model(
        args.model_path, args.model_base, model_name, device=args.device)

    qs = args.query
    image_token_se = DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN
    image_token = image_token_se if runtime.cfg.mm_use_im_start_end else DEFAULT_IMAGE_TOKEN
    if IMAGE_PLACEHOLDER in qs:
        qs = re.sub(IMAGE_PLACEHOLDER, image_token, qs)
    elif DEFAULT_IMAGE_TOKEN not in qs:
        qs = image_token + "\n" + qs

    conv = conv_templates[args.conv_mode or "llava_v1"].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    images = [load_image(f) for f in image_parser(args)]
    pixels = process_images(images, image_processor, runtime.cfg)
    input_ids = np.asarray(tokenizer_image_token(prompt, tokenizer), np.int64)

    gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=args.top_p if args.top_p is not None else 1.0,
        eos_token_id=tokenizer.eos_token_id,
    ))
    out_ids = gen.generate([input_ids], pixels[:1])[0]
    outputs = tokenizer.decode(out_ids, skip_special_tokens=True).strip()
    print(outputs)
    return outputs


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", dest="model_path", type=str, required=True)
    parser.add_argument("--model-base", dest="model_base", type=str, default=None)
    parser.add_argument("--model-name", dest="model_name", type=str, default=None)
    parser.add_argument("--image-file", dest="image_file", type=str, required=True)
    parser.add_argument("--query", type=str, required=True)
    parser.add_argument("--conv-mode", dest="conv_mode", type=str, default=None)
    parser.add_argument("--sep", type=str, default=",")
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--max_new_tokens", dest="max_new_tokens", type=int, default=512)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card; 'cpu' runs the plain PyTorch versions")
    return eval_model(parser.parse_args(argv))


if __name__ == "__main__":
    main()
