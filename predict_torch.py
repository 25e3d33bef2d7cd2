"""Replicate cog predictor on the PyTorch / CUDA port (the counterpart of
``predict.py``, whose JAX predictor stays as it is).

One image and a prompt in, the answer streamed out, in cog's
``BasePredictor``. The compute path is ``dynamic_llava_tpu_torch``'s:
``load_pretrained_model`` onto the card (or the device ``setup`` names),
the llava_v1 conversation template, and ``ChatSession.ask`` (the decode
chunks replayed from a CUDA graph, the keyword stop matched on the device),
run on a thread that feeds a queue, so text is yielded while the model
generates.

* Weights come from ``MODEL_PATH`` (an HF checkpoint directory baked into
  the image or mounted).
* ``cog`` is optional at import time so the module is testable anywhere;
  under cog the class is a real ``BasePredictor``.
* The predictor keeps one ``Generator`` and replaces it when a call's
  sampling settings differ (each call's session owns its own runner).
"""

from __future__ import annotations

import os
from io import BytesIO
from typing import Iterator

try:  # pragma: no cover - exercised only inside a cog container
    from cog import BasePredictor, Input, Path as CogPath

    def _input(**kw):
        return Input(**kw)

except Exception:  # cog not installed: plain-Python shim, same surface
    class BasePredictor:  # type: ignore[no-redef]
        def setup(self) -> None: ...

    CogPath = str  # type: ignore[assignment,misc]

    def _input(default=None, **kw):
        return default


DEFAULT_MODEL_PATH = os.environ.get("MODEL_PATH", "./weights/dynamic-llava-v1.5-13b")


def load_image(image_file: str):
    from PIL import Image

    if image_file.startswith(("http://", "https://")):
        import requests

        response = requests.get(image_file)
        return Image.open(BytesIO(response.content)).convert("RGB")
    return Image.open(image_file).convert("RGB")


class Predictor(BasePredictor):
    def setup(self, model_path: str | None = None, device=None) -> None:
        """Load the model once. ``device``: where it runs, the card unless
        the caller asks for another (``"cpu"``)."""
        from dynamic_llava_tpu_torch.models.builder import load_pretrained_model

        (self.tokenizer, self.runtime, self.image_processor,
         self.context_len) = load_pretrained_model(
            model_path or DEFAULT_MODEL_PATH, None, device=device
        )
        self._gen = None
        self._gen_key = None

    def _generator(self, max_tokens: int, temperature: float, top_p: float):
        from dynamic_llava_tpu_torch.generation.generate import (
            GenerationConfig,
            Generator,
        )

        key = (max_tokens, temperature, top_p)
        if self._gen is None or self._gen_key != key:
            self._gen = Generator(
                self.runtime.params, self.runtime.cfg,
                GenerationConfig(
                    max_new_tokens=max_tokens,
                    temperature=temperature,
                    top_p=top_p,
                    eos_token_id=self.tokenizer.eos_token_id,
                ),
            )
            self._gen_key = key
        return self._gen

    def predict(
        self,
        image: CogPath = _input(description="Input image"),
        prompt: str = _input(description="Prompt to use for text generation",
                             default=""),
        top_p: float = _input(
            description="Sample from the top p fraction of likely tokens",
            ge=0.0, le=1.0, default=1.0,
        ),
        temperature: float = _input(
            description="0 is deterministic; higher is more random",
            default=0.2, ge=0.0,
        ),
        max_tokens: int = _input(
            description="Maximum number of tokens to generate",
            default=1024, ge=0,
        ),
    ) -> Iterator[str]:
        """Single-turn VQA: yields the answer text incrementally."""
        import queue
        import threading

        import numpy as np

        from dynamic_llava_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
        from dynamic_llava_tpu_torch.conversation import (
            SeparatorStyle,
            conv_templates,
        )
        from dynamic_llava_tpu_torch.generation.generate import ChatSession
        from dynamic_llava_tpu_torch.mm_utils import (
            KeywordsStoppingCriteria,
            process_images,
            tokenizer_image_token,
        )

        conv = conv_templates["llava_v1"].copy()
        conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + prompt)
        conv.append_message(conv.roles[1], None)
        full_prompt = conv.get_prompt()
        stop_str = (
            conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
        )

        pixels = process_images(
            [load_image(str(image))], self.image_processor, self.runtime.cfg
        )
        input_ids = np.asarray(
            tokenizer_image_token(full_prompt, self.tokenizer), np.int64
        )
        gen = self._generator(max_tokens, temperature, top_p)
        session = ChatSession(gen, max_new_tokens_total=max_tokens + 8)
        stopping = KeywordsStoppingCriteria([stop_str], self.tokenizer, 0)

        # ask() runs on a thread feeding a queue, so text is yielded WHILE
        # the model generates; a synchronous on_chunk replay would make the
        # time to the first byte the whole generation's
        q: "queue.Queue" = queue.Queue()
        result: dict = {}

        def run():
            try:
                result["out"] = session.ask(
                    input_ids, pixels, stopping_criteria=stopping,
                    on_chunk=lambda fresh: q.put(list(fresh)),
                )
            except BaseException as e:  # surfaced on the consumer side
                result["err"] = e
            finally:
                q.put(None)

        threading.Thread(target=run, daemon=True).start()

        # a decode chunk at a time: re-decode the accumulated ids and yield
        # the delta (tokenizers do not detokenize incrementally in general)
        emitted = ""
        acc = []
        while True:
            ch = q.get()
            if ch is None:
                break
            acc.extend(t for t in ch if t != self.tokenizer.eos_token_id)
            text = self.tokenizer.decode(acc, skip_special_tokens=True)
            if text.endswith(stop_str):
                text = text[: -len(stop_str)]
            if len(text) > len(emitted):
                yield text[len(emitted):]
                emitted = text
        if "err" in result:
            raise result["err"]
        # the final text: ask() may have cut the answer at a stop that the
        # streamed chunks ran past
        final = self.tokenizer.decode(
            [t for t in result["out"] if t != self.tokenizer.eos_token_id],
            skip_special_tokens=True,
        )
        if final.endswith(stop_str):
            final = final[: -len(stop_str)]
        if len(final) > len(emitted):
            yield final[len(emitted):]
