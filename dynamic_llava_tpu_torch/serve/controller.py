"""Serving controller: worker registry, dispatch and the streaming proxy.
The port's own copy of ``dynamic_llava_tpu/serve/controller.py``
(``tests/test_torch_config.py`` holds the two equal).

It holds a registry of model workers, expires them by heartbeat
(``CONTROLLER_HEART_BEAT_EXPIRATION``) and dispatches by lottery or
shortest queue. The HTTP protocol is the reference LLaVA controller's, so
either package's workers and clients talk to it.

    python -m dynamic_llava_tpu_torch.serve.controller --host 0.0.0.0 --port 10000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from enum import Enum, auto
from typing import Dict, List

import numpy as np

from ..constants import CONTROLLER_HEART_BEAT_EXPIRATION
from ..utils import build_logger, server_error_msg

logger = build_logger("controller", "controller.log")


class DispatchMethod(Enum):
    LOTTERY = auto()
    SHORTEST_QUEUE = auto()

    @classmethod
    def from_str(cls, name: str) -> "DispatchMethod":
        if name == "lottery":
            return cls.LOTTERY
        if name == "shortest_queue":
            return cls.SHORTEST_QUEUE
        raise ValueError(f"Invalid dispatch method: {name}")


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: int
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str):
        self.worker_info: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod.from_str(dispatch_method)
        self.heart_beat_thread = threading.Thread(
            target=self._heart_beat_loop, daemon=True
        )
        self.heart_beat_thread.start()

    def register_worker(
        self, worker_name: str, check_heart_beat: bool, worker_status: dict
    ) -> bool:
        if worker_status is None:
            worker_status = self._get_worker_status(worker_name)
        if worker_status is None:
            return False
        self.worker_info[worker_name] = WorkerInfo(
            model_names=worker_status["model_names"],
            speed=worker_status["speed"],
            queue_length=worker_status["queue_length"],
            check_heart_beat=check_heart_beat,
            last_heart_beat=time.time(),
        )
        logger.info(f"Register done: {worker_name}, {worker_status}")
        return True

    def _get_worker_status(self, worker_name: str):
        import requests

        try:
            r = requests.post(worker_name + "/worker_get_status", timeout=5)
            if r.status_code == 200:
                return r.json()
        except requests.exceptions.RequestException as e:
            logger.error(f"Get status fails: {worker_name}, {e}")
        return None

    def refresh_all_workers(self):
        old = dict(self.worker_info)
        self.worker_info = {}
        for name, info in old.items():
            if not self.register_worker(name, info.check_heart_beat, None):
                logger.info(f"Remove stale worker: {name}")

    def list_models(self) -> List[str]:
        names = set()
        for info in self.worker_info.values():
            names.update(info.model_names)
        return sorted(names)

    def get_worker_address(self, model_name: str) -> str:
        candidates = [
            (name, info)
            for name, info in self.worker_info.items()
            if model_name in info.model_names
        ]
        if not candidates:
            return ""
        if self.dispatch_method == DispatchMethod.LOTTERY:
            speeds = np.array([i.speed for _, i in candidates], np.float32)
            total = float(speeds.sum())
            if total <= 0:
                return ""
            idx = int(np.random.choice(len(candidates), p=speeds / total))
            return candidates[idx][0]
        # shortest queue, normalized by speed
        loads = [i.queue_length / max(i.speed, 1e-4) for _, i in candidates]
        idx = int(np.argmin(loads))
        name = candidates[idx][0]
        self.worker_info[name].queue_length += 1
        logger.info(f"names: {[c[0] for c in candidates]}, "
                    f"queue_lens: {loads}, ret: {name}")
        return name

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        if worker_name not in self.worker_info:
            logger.info(f"Receive unknown heart beat. {worker_name}")
            return False
        self.worker_info[worker_name].queue_length = queue_length
        self.worker_info[worker_name].last_heart_beat = time.time()
        return True

    def remove_stale_workers(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        stale = [
            name
            for name, info in self.worker_info.items()
            if info.check_heart_beat and info.last_heart_beat < expire
        ]
        for name in stale:
            logger.info(f"Remove stale worker: {name}")
            self.worker_info.pop(name, None)

    def _heart_beat_loop(self):
        while True:
            time.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
            self.remove_stale_workers()

    def worker_api_generate_stream(self, params: dict):
        import requests

        worker_addr = self.get_worker_address(params["model"])
        if not worker_addr:
            yield (json.dumps({"text": server_error_msg, "error_code": 2}) + "\0").encode()
            return
        try:
            # (connect, read): connect failures fail fast like the
            # reference's flat 15 s, but the read window tolerates a JAX
            # worker's first-compile stall (20-40 s on a real chip; the
            # reference's eager-torch workers never pause that long).
            # Queue waits are covered by the worker's keep-alive acks.
            response = requests.post(
                worker_addr + "/worker_generate_stream",
                json=params, stream=True, timeout=(15, 120),
            )
            for chunk in response.iter_lines(decode_unicode=False, delimiter=b"\0"):
                if chunk:
                    yield chunk + b"\0"
        except requests.exceptions.RequestException:
            yield (json.dumps({"text": server_error_msg, "error_code": 3}) + "\0").encode()


def build_app(controller: Controller):
    from fastapi import FastAPI, Request
    from fastapi.responses import StreamingResponse

    app = FastAPI()

    @app.post("/register_worker")
    async def register_worker(request: Request):
        data = await request.json()
        controller.register_worker(
            data["worker_name"], data["check_heart_beat"],
            data.get("worker_status"),
        )

    @app.post("/refresh_all_workers")
    async def refresh_all_workers():
        controller.refresh_all_workers()

    @app.post("/list_models")
    async def list_models():
        return {"models": controller.list_models()}

    @app.post("/get_worker_address")
    async def get_worker_address(request: Request):
        data = await request.json()
        return {"address": controller.get_worker_address(data["model"])}

    @app.post("/receive_heart_beat")
    async def receive_heart_beat(request: Request):
        data = await request.json()
        exist = controller.receive_heart_beat(
            data["worker_name"], data["queue_length"]
        )
        return {"exist": exist}

    @app.post("/worker_generate_stream")
    async def worker_api_generate_stream(request: Request):
        params = await request.json()
        return StreamingResponse(controller.worker_api_generate_stream(params))

    return app


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=10000)
    parser.add_argument(
        "--dispatch-method", type=str,
        choices=["lottery", "shortest_queue"], default="shortest_queue",
    )
    args = parser.parse_args(argv)
    controller = Controller(args.dispatch_method)
    from .http_compat import controller_stdlib_app, fastapi_available

    if fastapi_available():
        import uvicorn

        uvicorn.run(build_app(controller), host=args.host, port=args.port,
                    log_level="info")
    else:
        logger.info("fastapi/uvicorn unavailable; serving on stdlib http")
        controller_stdlib_app(controller, args.host, args.port).serve()


if __name__ == "__main__":
    main()
