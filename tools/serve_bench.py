#!/usr/bin/env python3
"""The model worker's streamed throughput against the bench's decode on
the same weights (the twin of ``run/serve_bench.py``).

Is the worker's streamed tok/s within ~10% of the bench core's decode, so
that the path a deployment serves is the path the bench measures? The tool
builds the bench's random bf16 weights, hands them to a ``ModelWorker``
with ``loaded=(tokenizer, runtime, processor, max_len)`` (no checkpoint:
the JAX tool stubs ``load_pretrained_model`` instead), streams one warm
and one timed text request through ``ModelWorker.generate_stream``
(tokenize, prefill, chunked decode on the ``DecodeRunner``, detokenize a
chunk) and runs ``eval.bench.bench_config`` at B=1 on the same weights.
The tokenizer is a real fast tokenizer over a word-level vocabulary of
the model's size (``make_tokenizer``).

Reported: the worker's TTFT (request to first chunk; the first chunk waits
for a whole decode chunk), its steady-state tok/s (the tokens after the
first chunk over the time from the first chunk to the last that added
tokens: the JAX formula guesses the first chunk's tokens as an even share
and counts the final chunk, which repeats the text), its token count, the
bench's decode tok/s and the ratio.

    python3 tools/serve_bench.py [--model 1b] [--new-tokens 256] [--text-len 64]
    python3 tools/serve_bench.py --model small --cpu --new-tokens 8

It runs on the card unless ``--cpu`` is given, prints the card's name and
power limit, and one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import harness


def make_tokenizer(vocab_size: int):
    """A real fast tokenizer over a synthetic word-level vocab (``t2`` ..
    ``t{vocab_size - 1}``, ``<unk>`` 0, ``</s>`` 1): the worker's tokenize /
    detokenize work is representative."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, "</s>": 1}
    for i in range(2, vocab_size):
        vocab[f"t{i}"] = i
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    wrapped = PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", eos_token="</s>", pad_token="<unk>",
    )
    wrapped.model_max_length = 2048
    return wrapped


def measure(args, params=None, texts=None) -> dict:
    """The worker's stream and the bench's decode on ``params`` (default:
    the bench's random bf16 weights of ``args.model``). ``texts``, if
    given, receives the timed request's generated text (the streamed text
    after the prompt)."""
    from dynamic_llava_tpu_torch import utils
    from dynamic_llava_tpu_torch.eval.bench import bench_config, build_bench_params
    from dynamic_llava_tpu_torch.mm_utils import ClipImagePreprocessor
    from dynamic_llava_tpu_torch.models.builder import LlavaRuntime

    dev = harness.device(args)
    cfg = harness.model_config(args)
    if params is None:
        params = build_bench_params(cfg, None, dev)
    tokenizer = make_tokenizer(cfg.text.vocab_size)
    # the worker's log file, under the checkout's build directory
    utils.LOGDIR = str(harness.ROOT / "build" / "serve_logs")
    from dynamic_llava_tpu_torch.serve.model_worker import ModelWorker

    worker = ModelWorker(
        "", "", "bench", True, "<random-bench-weights>", None, f"bench-{args.model}",
        device=dev, loaded=(tokenizer, LlavaRuntime(params=params, cfg=cfg),
                            ClipImagePreprocessor(size=cfg.vision.image_size),
                            cfg.model_max_length))
    try:
        prompt = " ".join(f"t{100 + i}" for i in range(args.text_len))
        req = {"prompt": prompt, "images": [], "temperature": 0.0,
               "max_new_tokens": args.new_tokens, "stop": None}
        for _ in worker.generate_stream(dict(req)):  # warm: the capture
            pass
        t0 = time.time()
        chunks = []  # (time, text) of each chunk whose text grew
        for chunk in worker.generate_stream(dict(req)):
            now, text = time.time(), json.loads(chunk.rstrip(b"\0"))["text"]
            if not chunks or len(text) > len(chunks[-1][1]):
                chunks.append((now, text))
    finally:
        worker.close()
    text = chunks[-1][1][len(prompt):].strip()
    if texts is not None:
        texts.append(text)
    n_tok = len(tokenizer(text).input_ids)
    ttft = chunks[0][0] - t0
    # steady state: the tokens after the first chunk over the time from the
    # first chunk to the last that added tokens (the worker's final chunk
    # repeats the text)
    if len(chunks) > 1:
        n_first = len(tokenizer(chunks[0][1][len(prompt):].strip()).input_ids)
        decode_tok_s = (n_tok - n_first) / (chunks[-1][0] - chunks[0][0])
    else:
        decode_tok_s = n_tok / (time.time() - t0)
    raw = bench_config(params, cfg, batch=1, text_len=args.text_len,
                       new_tokens=args.new_tokens)
    return {
        "model": args.model,
        "worker_decode_tok_s": round(decode_tok_s, 2),
        "worker_ttft_s": round(ttft, 3),
        "worker_tokens": n_tok,
        "raw_decode_tok_s": round(raw["decode_tok_s"], 2),
        "worker_vs_raw": round(decode_tok_s / raw["decode_tok_s"], 4),
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="1b", choices=["1b", "7b", "small"])
    p.add_argument("--new-tokens", dest="new_tokens", type=int, default=256)
    p.add_argument("--text-len", dest="text_len", type=int, default=64)
    harness.add_run_flags(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    harness.print_card(args)
    print(json.dumps(measure(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
