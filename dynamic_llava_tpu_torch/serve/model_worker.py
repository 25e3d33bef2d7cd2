"""Model worker: loads a model and serves streaming generation over HTTP
(the port's counterpart of ``dynamic_llava_tpu/serve/model_worker.py``).

It registers with the controller, sends heartbeats, and streams each
request's text as b"\\0"-delimited JSON chunks, the reference LLaVA
worker's protocol. Greedy and sampled requests decode in chunks on the
``Generator``'s ``DecodeRunner`` (a CUDA graph replayed a step on the card),
chunk k+1 enqueued before chunk k's tokens are read; with ``--spec-k`` a
greedy request runs speculative verify rounds instead. Both producers feed
one stop / stream consumer.

    python -m dynamic_llava_tpu_torch.serve.model_worker --model-path CKPT \\
        --controller-address http://localhost:10000 \\
        --worker-address http://localhost:40000 --port 40000 [--device cpu]

Where it differs from the JAX worker, on purpose:

* ONE device lock. The JAX worker lets up to ``limit_model_concurrency``
  requests run their device programs at once (XLA keeps each call's state
  apart). Here a request's state lives in the static buffers of the one
  kept runner, and a CUDA graph capture must see no launch from another
  thread, so a request holds the worker's device lock from its prefill to
  its last chunk or round (captures included). The semaphore, the waiting /
  active counts and the keep-alive acks stay, so the controller sees the
  same queue; a request waiting for the lock streams acks too.
* ONE kept ``Generator``. The JAX worker keeps one a sampling setting, each
  only compiled programs; here a ``Generator`` holds a runner with a KV
  cache on the card, so the worker keeps one and replaces it (its runner
  freed first) when a request's temperature / top-p differ. Greedy requests
  share one whatever their top-p.
* ``global_counter`` counts every request, in both server flavours (the
  JAX stdlib server never increments it, so every sampled request there
  draws from seed 0); a sampled request draws from its own number.
* ``close()`` ends the heartbeat and drops the weights.
* ``device`` / ``--device``: where the model runs, the card unless the
  caller asks for another (``"cpu"``).
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import threading
import uuid
from io import BytesIO

import numpy as np

from ..constants import WORKER_HEART_BEAT_INTERVAL
from ..utils import build_logger, server_error_msg

worker_id = str(uuid.uuid4())[:6]
logger = build_logger("model_worker", f"model_worker_{worker_id}.log")


def heart_beat_worker(worker: "ModelWorker"):
    while not worker.stopped.wait(WORKER_HEART_BEAT_INTERVAL):
        worker.send_heart_beat()


def chunk(text: str, error_code: int = 0) -> bytes:
    """One protocol chunk: ``{"text", "error_code"}`` and the b"\\0" that
    ends it."""
    return json.dumps({"text": text, "error_code": error_code}).encode() + b"\0"


class ModelWorker:
    # seconds between keep-alive acks while a request waits for a
    # concurrency slot or for the device
    keepalive_s = 5.0

    def __init__(
        self,
        controller_addr: str,
        worker_addr: str,
        worker_id: str,
        no_register: bool,
        model_path: str,
        model_base: str,
        model_name: str,
        limit_model_concurrency: int = 5,
        kv_overflow: str = "drop",
        kv_window=None,
        spec_k: int = 0,
        max_queue_wait_s: float = 300.0,
        device=None,
        loaded=None,
    ):
        """``loaded``: a ``load_pretrained_model`` tuple to serve instead of
        loading ``model_path`` (a caller's own tokenizer, or weights it
        already holds)."""
        from ..mm_utils import get_model_name_from_path
        from ..models.builder import load_pretrained_model

        if spec_k > 0 and kv_overflow != "drop":
            # fail at startup, not with an error chunk on every greedy
            # request (speculative decode is drop-mode only)
            raise ValueError("--spec-k requires --kv-overflow drop")
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = worker_id
        self.model_name = model_name or get_model_name_from_path(model_path)
        self.limit_model_concurrency = limit_model_concurrency
        # deployment-level KV policy: "ring" + a window serves long
        # generations at a fixed per-request cache allocation
        self.kv_overflow = kv_overflow
        self.kv_window = kv_window
        # speculative decoding for greedy requests (0 = off); sampled
        # requests always take the chunked path
        self.spec_k = spec_k
        if loaded is None:
            logger.info(f"Loading the model {self.model_name} on worker {worker_id} ...")
            loaded = load_pretrained_model(model_path, model_base, self.model_name,
                                           device=device)
        self.tokenizer, self.runtime, self.image_processor, self.context_len = loaded
        # the gate: a semaphore acquired INSIDE the streamed body, so queued
        # requests emit keep-alive acks; explicit counts feed get_queue_length
        self._gate = threading.Semaphore(limit_model_concurrency)
        self._counts_lock = threading.Lock()
        self._waiting = 0
        self._active = 0
        self.max_queue_wait_s = max_queue_wait_s
        self.global_counter = 0
        # every device step of a request runs under this lock (see the
        # module docstring), and so does a change of the kept Generator
        self._device_lock = threading.Lock()
        self._gen = None
        self._gen_key = None
        # the runner captures requests paid for: request number, runner, ms
        self.captures: list = []
        self.stopped = threading.Event()
        self.heart_beat_thread = None

        if not no_register:
            self.register_to_controller()
            self.heart_beat_thread = threading.Thread(
                target=heart_beat_worker, args=(self,), daemon=True
            )
            self.heart_beat_thread.start()

    def register_to_controller(self):
        import requests

        logger.info("Register to controller")
        url = self.controller_addr + "/register_worker"
        data = {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status(),
        }
        r = requests.post(url, json=data)
        assert r.status_code == 200

    def send_heart_beat(self):
        import requests

        logger.info(
            f"Send heart beat. Models: {[self.model_name]}. "
            f"active: {self._active}. waiting: {self._waiting}. "
            f"global_counter: {self.global_counter}"
        )
        url = self.controller_addr + "/receive_heart_beat"
        while not self.stopped.is_set():
            try:
                ret = requests.post(
                    url,
                    json={
                        "worker_name": self.worker_addr,
                        "queue_length": self.get_queue_length(),
                    },
                    timeout=5,
                )
                exist = ret.json()["exist"]
                break
            except requests.exceptions.RequestException as e:
                logger.error(f"heart beat error: {e}")
            self.stopped.wait(5)
        else:
            return
        if not exist:
            self.register_to_controller()

    def get_queue_length(self) -> int:
        # running + waiting: shortest-queue dispatch must see gate-queued
        # requests, not just in-flight ones
        with self._counts_lock:
            return self._active + self._waiting

    def get_status(self) -> dict:
        return {
            "model_names": [self.model_name],
            "speed": 1,
            "queue_length": self.get_queue_length(),
        }

    def close(self):
        """End the heartbeat and drop the model: the weights, the kept
        ``Generator`` and its runner (after any request's device work)."""
        self.stopped.set()
        if self.heart_beat_thread is not None:
            self.heart_beat_thread.join()
        with self._device_lock:
            self._gen = None
            self.runtime = None
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- generation ------------------------------------------------------

    def _generator(self, temperature: float, top_p: float):
        """The worker's one ``Generator``, for these sampling settings
        (called under the device lock): the kept one, or a new one that
        replaces it, the old runner freed before the new one is made."""
        from ..generation.generate import GenerationConfig, Generator

        if temperature <= 0.0:
            top_p = 1.0  # greedy ignores it
        key = (round(temperature, 4), round(top_p, 4))
        if self._gen is None or self._gen_key != key:
            self._gen = None
            self._gen = Generator(
                self.runtime.params,
                self.runtime.cfg,
                GenerationConfig(
                    temperature=temperature,
                    top_p=top_p,
                    eos_token_id=self.tokenizer.eos_token_id,
                    kv_overflow=self.kv_overflow,
                    kv_window=self.kv_window,
                ),
            )
            self._gen_key = key
        return self._gen

    def _log_capture(self, runner, request_no: int):
        """Record the capture of ``runner`` if it happened for this request."""
        if runner is None or runner.capture_ms is None or getattr(runner, "capture_recorded", False):
            return
        runner.capture_recorded = True
        self.captures.append({"request": request_no, "runner": type(runner).__name__,
                              "capture_ms": runner.capture_ms})
        logger.info(f"request {request_no}: {type(runner).__name__} captured in "
                    f"{runner.capture_ms:.1f} ms")

    def _wait_for_device(self):
        """Take the device lock, yielding an empty batch (the consumer turns
        it into a keep-alive ack) every ``keepalive_s`` while another
        request holds it."""
        while not self._device_lock.acquire(timeout=self.keepalive_s):
            yield []

    def generate_stream(self, params: dict, request_no=None):
        """The request's chunks. ``request_no`` seeds a sampled request
        (default: ``global_counter``)."""
        from PIL import Image

        from ..mm_utils import (
            KeywordsStoppingCriteria,
            process_images,
            tokenizer_image_token,
        )

        tokenizer, runtime = self.tokenizer, self.runtime
        request_no = self.global_counter if request_no is None else request_no
        prompt = params["prompt"]
        images = params.get("images", None)
        pixels = None
        if images is not None and len(images) > 0:
            pil_images = [
                Image.open(BytesIO(base64.b64decode(im))).convert("RGB")
                for im in images
            ]
            pixels = process_images(pil_images, self.image_processor, runtime.cfg)

        temperature = float(params.get("temperature", 1.0))
        top_p = float(params.get("top_p", 1.0))
        max_new_tokens = min(int(params.get("max_new_tokens", 256)), 1024)
        stop_str = params.get("stop", None)

        input_ids = np.asarray(tokenizer_image_token(prompt, tokenizer), np.int64)
        stopping = (
            KeywordsStoppingCriteria([stop_str], tokenizer, len(input_ids))
            if stop_str
            else None
        )

        if self.spec_k > 0 and temperature <= 0.0:
            batches = self._spec_batches(input_ids, pixels, max_new_tokens, request_no)
        else:
            batches = self._chunked_batches(input_ids, pixels, max_new_tokens,
                                            temperature, top_p, request_no)
        yield from self._stream_from_batches(
            batches, prompt=prompt, stop_str=stop_str, stopping=stopping,
            input_ids=input_ids, tokenizer=tokenizer,
            max_new_tokens=max_new_tokens,
        )

    def _chunked_batches(self, input_ids, pixels, max_new_tokens, temperature, top_p,
                         request_no):
        """Producer: the pipelined chunked decode of ``Generator.generate``
        (one host wait a chunk, chunk k+1 enqueued before chunk k's tokens
        are read). Yields each chunk's tokens; closing it releases the
        device lock (a chunk still in flight finishes on the stream before
        the next request's work)."""
        import torch

        from ..multimodal.fusion import plan_batch

        yield from self._wait_for_device()
        try:
            gen = self._generator(temperature, top_p)
            gc = gen.gen_cfg
            chunk_len = max(1, min(gc.decode_chunk, max_new_tokens))
            n_chunks = -(-max_new_tokens // chunk_len)
            plan = plan_batch(
                [input_ids],
                self.runtime.cfg.num_image_tokens if pixels is not None else 0,
                max_length=self.runtime.cfg.model_max_length,
                pad_multiple=gc.pad_multiple,
            )
            budget = n_chunks * chunk_len
            with torch.inference_mode():
                state, _ = gen.prefill_from_plan(plan, pixels, budget, chunk=chunk_len)
                runner = gen.runner(plan, pixels, budget, chunk=chunk_len)
                runner.load(state, request_no)
                del state
                pending = runner.run_chunk()
            self._log_capture(runner, request_no)
            for ci in range(n_chunks):
                following = None
                if ci + 1 < n_chunks:
                    with torch.inference_mode():
                        following = runner.run_chunk()
                toks = pending.tokens()
                yield [int(t) for t in toks[:, 0]]
                pending = following
        finally:
            self._device_lock.release()

    def _spec_batches(self, input_ids, pixels, max_new_tokens, request_no):
        """Producer: speculative verify rounds in a thread of their own,
        yielding each round's accepted tokens. Closing it cancels the
        thread at the next round; the thread releases the device lock when
        its device work has ended."""
        q: queue.Queue = queue.Queue()
        cancel = threading.Event()

        class _Abort(Exception):
            pass

        def on_tokens(_i, fresh):
            if cancel.is_set():
                raise _Abort()
            q.put(list(fresh))

        def run():
            try:
                gen = self._generator(0.0, 1.0)
                gen.generate_speculative(
                    [input_ids], pixels, draft="prompt_lookup",
                    draft_k=self.spec_k, on_tokens=on_tokens,
                    max_new_tokens=max_new_tokens,
                )
                self._log_capture(gen.decode_runner, request_no)
                q.put(None)
            except _Abort:
                q.put(None)
            except Exception as e:  # surfaced as an error chunk, not a hang
                q.put(e)
            finally:
                self._device_lock.release()

        yield from self._wait_for_device()
        try:
            t = threading.Thread(target=run, daemon=True)
            t.start()
        except BaseException:
            self._device_lock.release()
            raise
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            cancel.set()
            t.join(timeout=120)
            if t.is_alive():
                logger.error("speculative generation thread did not stop")

    def _stream_from_batches(self, batches, *, prompt, stop_str, stopping,
                             input_ids, tokenizer, max_new_tokens):
        """Shared stop / stream consumer: accumulates fresh token batches,
        handles EOS / token budget / stop-string suffix /
        ``KeywordsStoppingCriteria``, re-decodes the accumulated ids a
        batch (tokenizers do not detokenize incrementally in general), and
        always finishes with the trimmed full text."""
        generated: list = []
        eos = tokenizer.eos_token_id
        done = False
        try:
            for batch in batches:
                for t in batch:
                    t = int(t)
                    if t == eos or len(generated) >= max_new_tokens:
                        done = True
                        break
                    generated.append(t)
                    if stop_str or stopping is not None:
                        text = tokenizer.decode(
                            generated, skip_special_tokens=True
                        )
                        if stop_str and text.endswith(stop_str):
                            done = True  # trimmed in the final yield
                            break
                        if stopping is not None and stopping(
                            list(input_ids) + generated
                        ):
                            done = True
                            break
                if done:
                    break
                text = tokenizer.decode(generated, skip_special_tokens=True)
                yield chunk(prompt + text)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()  # stop the producer's device work
        text = tokenizer.decode(generated, skip_special_tokens=True)
        if stop_str and text.endswith(stop_str):
            text = text[: -len(stop_str)]
        yield chunk(prompt + text)

    def generate_stream_gate(self, params: dict):
        """Request entry for BOTH server flavours: counts the request,
        acquires the concurrency gate inside the streamed body, yielding
        keep-alive acks while QUEUED (so an upstream proxy's read timeout
        never fires on a busy worker), and fails with an error chunk after
        ``max_queue_wait_s``."""
        with self._counts_lock:
            self.global_counter += 1
            request_no = self.global_counter
        try:
            waited = 0.0
            with self._counts_lock:
                self._waiting += 1
            try:
                while not self._gate.acquire(timeout=self.keepalive_s):
                    waited += self.keepalive_s
                    if waited >= self.max_queue_wait_s:
                        logger.error(
                            f"request queued past {self.max_queue_wait_s}s; "
                            "rejecting"
                        )
                        yield chunk(server_error_msg, 1)
                        return
                    yield chunk(params.get("prompt", ""))
            finally:
                with self._counts_lock:
                    self._waiting -= 1
            with self._counts_lock:
                self._active += 1
            try:
                yield from self.generate_stream(params, request_no)
            finally:
                self._gate.release()
                with self._counts_lock:
                    self._active -= 1
        except ValueError as e:
            logger.error(f"Caught ValueError: {e}")
            yield chunk(server_error_msg, 1)
        except Exception as e:
            logger.exception(f"Caught Unknown Error: {e}")
            yield chunk(server_error_msg, 1)


def build_app(worker: ModelWorker):
    from fastapi import FastAPI, Request
    from fastapi.responses import StreamingResponse

    app = FastAPI()

    @app.post("/worker_generate_stream")
    async def generate_stream(request: Request):
        params = await request.json()
        # the sync generator runs in starlette's threadpool; the gate (and
        # its queued-request keep-alives) and the request count live inside
        # generate_stream_gate
        return StreamingResponse(worker.generate_stream_gate(params))

    @app.post("/worker_get_status")
    async def get_status(request: Request):
        return worker.get_status()

    return app


def parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=40000)
    parser.add_argument("--worker-address", type=str, default="http://localhost:40000")
    parser.add_argument("--controller-address", type=str, default="http://localhost:10000")
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--model-name", type=str, default=None)
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--kv-overflow", choices=("drop", "ring"),
                        default="drop",
                        help="KV policy past the decode budget: drop "
                             "(reference contract) or ring (fixed-window "
                             "recency eviction for long generations)")
    parser.add_argument("--kv-window", type=int, default=None,
                        help="decode-region cache allocation per tier, in "
                             "tokens (the ring window size)")
    parser.add_argument("--spec-k", type=int, default=0,
                        help="speculative decoding: verify 1+k candidates "
                             "per fused pass for greedy requests (0 = off)")
    parser.add_argument("--max-queue-wait", type=float, default=300.0,
                        help="seconds a request may wait for a concurrency "
                             "slot (keep-alives stream meanwhile) before "
                             "it is rejected with an error chunk")
    parser.add_argument("--device", type=str, default=None,
                        help="where the model runs (default: the card; 'cpu' "
                             "runs the plain PyTorch versions)")
    return parser


def main(argv=None):
    args = parser().parse_args(argv)

    worker = ModelWorker(
        args.controller_address,
        args.worker_address,
        worker_id,
        args.no_register,
        args.model_path,
        args.model_base,
        args.model_name,
        args.limit_model_concurrency,
        kv_overflow=args.kv_overflow,
        kv_window=args.kv_window,
        spec_k=args.spec_k,
        max_queue_wait_s=args.max_queue_wait,
        device=args.device,
    )
    from .http_compat import fastapi_available, worker_stdlib_app

    if fastapi_available():
        import uvicorn

        uvicorn.run(build_app(worker), host=args.host, port=args.port,
                    log_level="info")
    else:
        logger.info("fastapi/uvicorn unavailable; serving on stdlib http")
        worker_stdlib_app(worker, args.host, args.port).serve()


if __name__ == "__main__":
    main()
