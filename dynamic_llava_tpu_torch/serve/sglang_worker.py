"""High-throughput worker: micro-batching or continuous batching (the
port's counterpart of ``dynamic_llava_tpu/serve/sglang_worker.py``).

The reference's ``sglang_worker`` fronts the SGLang runtime; this worker
fills the same role natively. Concurrent requests are micro-batched onto
``Generator.generate`` (one padded prefill, the pipelined chunked decode,
per-sample keep decisions in the sparsified decode), greedy batches onto
``generate_speculative`` under ``--spec-k``, or, with ``--continuous``,
admitted into the running slots of a ``ContinuousEngine`` the moment one
frees. Each request streams its accumulated text a decode chunk (a verify
round under ``--spec-k``).

The HTTP surface is ``model_worker``'s (register / heartbeat /
``worker_generate_stream`` / ``worker_get_status``), so the controller
dispatches to either; ``generate_stream_gate`` is the stdlib
``http_compat`` worker contract.

    python -m dynamic_llava_tpu_torch.serve.sglang_worker --model-path CKPT \\
        --controller-address http://localhost:10000 \\
        --worker-address http://localhost:40001 --port 40001 [--continuous] [--device cpu]

All device work runs on the one batching thread, as in the JAX worker.
Where it differs from the JAX worker, on purpose:

* ONE kept ``Generator``. The JAX worker keeps one a ``(max_new,
  temperature)`` and never drops any (each only compiled programs); here a
  ``Generator`` holds a runner whose KV cache lives on the card, so the
  worker keeps one and replaces it (its runner freed first) when a batch's
  key differs.
* ``close()`` ends the batching thread and the heartbeat, answers any
  request still queued with an error chunk, and drops the weights; the
  JAX worker's threads never end.
* ``main`` serves on the stdlib server where FastAPI / uvicorn do not
  import (the JAX ``main`` needs uvicorn).
* ``device`` / ``--device``: where the model runs, the card unless the
  caller asks for another (``"cpu"``).
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import threading
import uuid
from typing import Callable, List, Optional

import numpy as np

from ..constants import WORKER_HEART_BEAT_INTERVAL
from ..utils import build_logger, pretty_print_semaphore, server_error_msg

worker_id = str(uuid.uuid4())[:6]
logger = build_logger("sglang_worker", f"sglang_worker_{worker_id}.log")


def chunk(text: str, error_code: int = 0) -> bytes:
    """One protocol chunk: ``{"text", "error_code"}`` and the b"\\0" that
    ends it."""
    return json.dumps({"text": text, "error_code": error_code}).encode() + b"\0"


class Request:
    """One in-flight generation; ``push`` receives b"\\0"-delimited JSON
    chunks and a final ``None``. The callback must be thread-safe: chunks
    arrive from the batching thread."""

    def __init__(self, params: dict, push: Callable[[Optional[bytes]], None]):
        self.params = params
        self.push = push

    def fail(self):
        self.push(chunk(server_error_msg, 1))
        self.push(None)


class BatchedWorker:
    """Collects concurrent requests into micro-batches. Each batch shares
    one padded prefill + pipelined chunked decode; per-request text streams
    through the generate ``on_chunk`` callback. Requests are grouped by
    temperature so one batch shares a sampling config."""

    # seconds between keep-alive acks while a request waits
    keepalive_s = 5.0

    def __init__(self, model_path: str, model_base: Optional[str] = None,
                 max_batch: int = 8, batch_window_ms: int = 30,
                 decode_chunk: int = 32,
                 controller_addr: str = "", worker_addr: str = "",
                 model_name: Optional[str] = None, no_register: bool = True,
                 spec_k: int = 0,
                 continuous: bool = False, slots: int = 4,
                 prompt_bucket: int = 768, max_new_cap: int = 512,
                 device=None, loaded=None):
        """``loaded``: a ``load_pretrained_model`` tuple to serve instead of
        loading ``model_path``."""
        from ..mm_utils import get_model_name_from_path
        from ..models.builder import load_pretrained_model

        if loaded is None:
            loaded = load_pretrained_model(model_path, model_base, device=device)
        (self.tokenizer, self.runtime, self.image_processor, self.context_len
         ) = loaded
        self.model_name = model_name or get_model_name_from_path(model_path)
        self.max_batch = max_batch
        self.batch_window_ms = batch_window_ms
        self.decode_chunk = decode_chunk
        # speculative verify rounds for GREEDY micro-batches (0 = off)
        self.spec_k = spec_k
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.pending: List[Request] = []
        self._gen = None
        self._gen_key = None
        self.last_batch_size = 0  # observability: size of the last micro-batch
        # the last micro-batches: their prompts in batch order, temperature
        # and max_new
        self.batch_log: collections.deque = collections.deque(maxlen=64)
        # the runner captures paid for: the batch or engine step, runner, ms
        self.captures: list = []
        self.batches_run = self.steps_run = 0
        self.lock = threading.Lock()
        self.stopped = threading.Event()
        # --continuous: requests join a RUNNING batch the moment a slot
        # frees (generation.continuous) instead of waiting for the window
        # batch to finish
        self.continuous = continuous
        self._engine = None
        if continuous:
            from ..generation.continuous import ContinuousEngine
            from ..generation.generate import GenerationConfig

            self._engine = ContinuousEngine(
                self.runtime.params, self.runtime.cfg,
                GenerationConfig(
                    max_new_tokens=max_new_cap,
                    eos_token_id=self.tokenizer.eos_token_id,
                    decode_chunk=decode_chunk,
                ),
                slots=slots, prompt_bucket=prompt_bucket,
                max_new_cap=max_new_cap,
                # the engine enforces greedy-only at submit under spec_k
                spec_k=spec_k,
                device=self.runtime.params["llm"]["final_ln"].device,
            )
        self.thread = threading.Thread(
            target=self._loop_continuous if continuous else self._loop,
            daemon=True,
        )
        self.thread.start()
        self.heart_beat_thread = None
        if not no_register:
            self.register_to_controller()
            self.heart_beat_thread = threading.Thread(
                target=self._heart_beat_loop, daemon=True
            )
            self.heart_beat_thread.start()

    # -- controller protocol (mirrors model_worker) ----------------------

    def get_status(self) -> dict:
        return {
            "model_names": [self.model_name],
            "speed": 1,
            "queue_length": self.get_queue_length(),
        }

    def get_queue_length(self) -> int:
        with self.lock:
            return len(self.pending)

    def register_to_controller(self):
        import requests

        logger.info("Register to controller")
        r = requests.post(self.controller_addr + "/register_worker", json={
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status(),
        })
        assert r.status_code == 200

    def send_heart_beat(self):
        import requests

        logger.info(
            f"Send heart beat. Models: {[self.model_name]}. "
            f"Semaphore: {pretty_print_semaphore(None)}."
        )
        url = self.controller_addr + "/receive_heart_beat"
        while not self.stopped.is_set():
            try:
                ret = requests.post(url, json={
                    "worker_name": self.worker_addr,
                    "queue_length": self.get_queue_length(),
                }, timeout=5)
                exist = ret.json()["exist"]
                break
            except Exception as e:  # noqa: BLE001
                logger.error(f"heart beat error: {e}")
            self.stopped.wait(5)
        else:
            return
        if not exist:
            self.register_to_controller()

    def _heart_beat_loop(self):
        while not self.stopped.wait(WORKER_HEART_BEAT_INTERVAL):
            self.send_heart_beat()

    def close(self):
        """End the batching thread and the heartbeat, fail what is still
        queued, and drop the model: the weights, the kept ``Generator`` or
        the engine, and their runners."""
        self.stopped.set()
        self.thread.join()
        if self.heart_beat_thread is not None:
            self.heart_beat_thread.join()
        with self.lock:
            left, self.pending = self.pending, []
        for req in left:
            req.fail()
        self._gen = self._engine = self.runtime = None
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- batching core ---------------------------------------------------

    def submit(self, req: Request):
        with self.lock:
            self.pending.append(req)

    def _take_batch(self) -> List[Request]:
        """Up to ``max_batch`` pending requests sharing the head request's
        temperature (one sampling config per batch)."""
        with self.lock:
            if not self.pending:
                return []
            temp = float(self.pending[0].params.get("temperature", 0.0))
            batch, rest = [], []
            for r in self.pending:
                same = float(r.params.get("temperature", 0.0)) == temp
                (batch if same and len(batch) < self.max_batch else rest).append(r)
            self.pending = rest
        return batch

    def _loop(self):
        while not self.stopped.wait(self.batch_window_ms / 1e3):
            batch = self._take_batch()
            if not batch:
                continue
            self.last_batch_size = len(batch)
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001
                logger.exception(f"batch failed: {e}")
                for req in batch:
                    req.fail()

    def _request_inputs(self, req: Request):
        """(token_ids, pixels | None, max_new, temperature) for one request."""
        import base64
        from io import BytesIO

        from PIL import Image

        from ..mm_utils import process_images, tokenizer_image_token

        p = req.params
        ids = np.asarray(
            tokenizer_image_token(p["prompt"], self.tokenizer), np.int64
        )
        pixels = None
        images = p.get("images") or []
        if images:
            pil = Image.open(BytesIO(base64.b64decode(images[0]))).convert("RGB")
            pixels = process_images(
                [pil], self.image_processor, self.runtime.cfg
            )[0]
        max_new = min(int(p.get("max_new_tokens", 256)), 1024)
        temp = float(p.get("temperature", 0.0))
        return ids, pixels, max_new, temp

    def _loop_continuous(self):
        """Slot-based loop: drain the queue into free engine slots, decode
        one chunk, stream fresh tokens a request. The runner's graphs stay
        while requests come and go."""
        eng = self._engine
        live: dict = {}  # engine req id -> (Request, accumulated ids)
        while not self.stopped.is_set():
            with self.lock:
                incoming, self.pending = self.pending, []
            for req in incoming:
                try:
                    ids, pixels, max_new, temp = self._request_inputs(req)
                    # sampled requests ride the same batch: per-slot
                    # temperature / top_p (generation.continuous)
                    top_p = float(req.params.get("top_p", 1.0))
                    rid = eng.submit(
                        ids, pixel_values=pixels, max_new_tokens=max_new,
                        temperature=temp, top_p=top_p,
                    )
                    live[rid] = (req, [])
                except Exception as e:  # noqa: BLE001
                    logger.error(f"admission failed: {e}")
                    req.fail()
            if not live:
                self.stopped.wait(self.batch_window_ms / 1e3)
                continue
            self.last_batch_size = sum(
                r is not None for r in eng._slot_req
            )
            try:
                fresh = eng.step()
            except Exception as e:  # noqa: BLE001
                logger.exception(f"engine step failed: {e}")
                for rid, (req, _) in live.items():
                    req.fail()
                    eng.requests.pop(rid, None)
                live.clear()
                continue
            self.steps_run += 1
            self._log_capture(eng.runner, f"engine step {self.steps_run}")
            for rid, toks in fresh.items():
                req, acc = live[rid]
                acc.extend(toks)
                req.push(chunk(self._decode_text(req, acc)))
            for rid in [r for r in live if eng.requests[r].done]:
                req, acc = live.pop(rid)
                req.push(chunk(self._decode_text(req, acc)))
                req.push(None)
                del eng.requests[rid]
        for req, _ in live.values():
            req.fail()

    def _decode_text(self, req: Request, out_ids: List[int]) -> str:
        eos = self.tokenizer.eos_token_id
        ids = [t for t in out_ids if t != eos]
        text = self.tokenizer.decode(ids, skip_special_tokens=True)
        stop = req.params.get("stop")
        if stop and text.endswith(stop):
            text = text[: -len(stop)]
        return req.params["prompt"] + text

    def _generator(self, max_new: int, temp: float):
        """The worker's one ``Generator`` for ``(max_new, temp)``: the kept
        one, or a new one that replaces it (the old runner freed first)."""
        from ..generation.generate import GenerationConfig, Generator

        if self._gen is None or self._gen_key != (max_new, temp):
            self._gen = None
            self._gen = Generator(
                self.runtime.params, self.runtime.cfg,
                GenerationConfig(
                    max_new_tokens=max_new,
                    temperature=temp,
                    eos_token_id=self.tokenizer.eos_token_id,
                    decode_chunk=self.decode_chunk,
                ),
            )
            self._gen_key = (max_new, temp)
        return self._gen

    def _log_capture(self, runner, at: str):
        """Record the capture(s) of ``runner`` not recorded yet, paid for
        ``at`` (a batch or an engine step)."""
        if runner is None:
            return
        done = getattr(runner, "captures_recorded", 0)
        ms = getattr(runner, "captures_ms", None)
        ms = list(ms.values()) if ms else ([] if runner.capture_ms is None
                                           else [runner.capture_ms])
        for v in ms[done:]:
            self.captures.append({"at": at, "runner": type(runner).__name__,
                                  "capture_ms": v})
            logger.info(f"{at}: {type(runner).__name__} captured in {v:.1f} ms")
        runner.captures_recorded = len(ms)

    def _run_batch(self, batch: List[Request]):
        ids_list, pixels_list = [], []
        for req in batch:
            ids, pixels, _, _ = self._request_inputs(req)
            ids_list.append(ids)
            if pixels is None:
                size = self.runtime.cfg.vision.image_size
                pixels = np.zeros((size, size, 3), np.float32)
            pixels_list.append(pixels)
        max_new = max(
            min(int(r.params.get("max_new_tokens", 256)), 1024)
            for r in batch
        )
        temp = float(batch[0].params.get("temperature", 0.0))
        self.batches_run += 1
        self.batch_log.append({"prompts": [r.params["prompt"] for r in batch],
                               "temperature": temp, "max_new": max_new})
        gen = self._generator(max_new, temp)

        # stream: re-decode the accumulated ids each chunk (tokenizers do
        # not detokenize incrementally in general) and push the full text
        # so far, the model_worker chunk protocol
        acc: List[List[int]] = [[] for _ in batch]

        def on_chunk(i, fresh):
            acc[i].extend(fresh)
            batch[i].push(chunk(self._decode_text(batch[i], acc[i])))

        if self.spec_k > 0 and temp <= 0.0:
            outs = gen.generate_speculative(
                ids_list, np.stack(pixels_list), draft_k=self.spec_k,
                on_tokens=on_chunk, max_new_tokens=max_new,
            )
        else:
            outs = gen.generate(
                ids_list, np.stack(pixels_list), on_chunk=on_chunk
            )
        self._log_capture(gen.decode_runner, f"batch {self.batches_run}")
        for req, out_ids in zip(batch, outs):
            req.push(chunk(self._decode_text(req, out_ids)))
            req.push(None)

    # -- serving adapters ------------------------------------------------

    def generate_stream_gate(self, params: dict):
        """Synchronous chunk generator (stdlib http_compat contract).
        Yields protocol-valid keep-alive acks while the request waits in
        the batch queue or its batch captures a graph, so an upstream
        proxy's read timeout never fires on a busy worker."""
        q: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self.submit(Request(params, q.put))
        while True:
            try:
                item = q.get(timeout=self.keepalive_s)
            except queue.Empty:
                yield chunk(params.get("prompt", ""))
                continue
            if item is None:
                return
            yield item


def build_app(worker: BatchedWorker):
    import asyncio

    from fastapi import FastAPI, Request as FRequest
    from fastapi.responses import StreamingResponse

    app = FastAPI()

    @app.post("/worker_generate_stream")
    async def generate_stream(request: FRequest):
        params = await request.json()
        loop = asyncio.get_running_loop()
        aq: "asyncio.Queue[Optional[bytes]]" = asyncio.Queue()
        worker.submit(Request(
            params, lambda c: loop.call_soon_threadsafe(aq.put_nowait, c)
        ))

        async def stream():
            while True:
                item = await aq.get()
                if item is None:
                    break
                yield item

        return StreamingResponse(stream())

    @app.post("/worker_get_status")
    async def get_status(request: FRequest):
        return worker.get_status()

    return app


def parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=40001)
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--worker-address", type=str,
                        default="http://localhost:40001")
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--model-name", type=str, default=None)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--batch-window-ms", type=int, default=30,
                        help="micro-batch collection window")
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--spec-k", type=int, default=0,
                        help="speculative decoding for greedy micro-batches"
                             " (verify 1+k candidates per pass; 0 = off)")
    parser.add_argument("--continuous", action="store_true",
                        help="slot-based continuous batching: requests join "
                             "the running batch when a slot frees; greedy "
                             "and sampled requests share the batch "
                             "(per-slot temperature/top_p)")
    parser.add_argument("--slots", type=int, default=4,
                        help="decode slots for --continuous")
    parser.add_argument("--prompt-bucket", type=int, default=768,
                        help="max (and padded) prompt length for --continuous")
    parser.add_argument("--max-new-cap", type=int, default=512,
                        help="per-request max_new_tokens cap for --continuous")
    parser.add_argument("--device", type=str, default=None,
                        help="where the model runs (default: the card; 'cpu' "
                             "runs the plain PyTorch versions)")
    return parser


def main(argv=None):
    args = parser().parse_args(argv)

    worker = BatchedWorker(
        args.model_path, args.model_base, args.max_batch,
        batch_window_ms=args.batch_window_ms,
        controller_addr=args.controller_address,
        worker_addr=args.worker_address,
        model_name=args.model_name, no_register=args.no_register,
        spec_k=args.spec_k,
        continuous=args.continuous, slots=args.slots,
        prompt_bucket=args.prompt_bucket, max_new_cap=args.max_new_cap,
        device=args.device,
    )
    from .http_compat import fastapi_available, worker_stdlib_app

    if fastapi_available():
        import uvicorn

        uvicorn.run(build_app(worker), host=args.host, port=args.port)
    else:
        logger.info("fastapi/uvicorn unavailable; serving on stdlib http")
        worker_stdlib_app(worker, args.host, args.port).serve()


if __name__ == "__main__":
    main()
