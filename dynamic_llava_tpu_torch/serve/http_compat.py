"""Dependency-light HTTP layer of the serving stack: the port's own copy of
``dynamic_llava_tpu/serve/http_compat.py`` (``tests/test_torch_config.py``
holds the two equal).

The same endpoint semantics as a FastAPI + uvicorn app on the stdlib
``http.server``: JSON POST routes and b"\\0"-delimited chunked streaming,
so the controller / worker / client stack runs without them. The serve
mains prefer FastAPI where it imports.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, Union

Handler = Callable[[dict], Union[dict, Iterator[bytes], None]]


class JsonRouteServer:
    """POST-only JSON router. Handlers get the parsed body; they return a
    dict (JSON response), a bytes-iterator (chunked stream), or None."""

    def __init__(self, host: str, port: int):
        self.routes: Dict[str, Handler] = {}
        self.host, self.port = host, port
        self._httpd = None

    def route(self, path: str):
        def deco(fn: Handler) -> Handler:
            self.routes[path] = fn
            return fn

        return deco

    def add_route(self, path: str, fn: Handler):
        self.routes[path] = fn

    def serve(self, background: bool = False):
        routes = self.routes

        class RequestHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_POST(self):
                fn = routes.get(self.path)
                if fn is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b"{}"
                try:
                    payload = json.loads(body or b"{}")
                except json.JSONDecodeError:
                    payload = {}
                try:
                    result = fn(payload)
                except Exception as e:  # noqa: BLE001
                    self.send_response(500)
                    msg = json.dumps({"error": str(e)}).encode()
                    self.send_header("Content-Length", str(len(msg)))
                    self.end_headers()
                    self.wfile.write(msg)
                    return
                if result is None:
                    result = {}
                if isinstance(result, dict):
                    data = json.dumps(result).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:  # streaming iterator
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for chunk in result:
                        self.wfile.write(f"{len(chunk):x}\r\n".encode())
                        self.wfile.write(chunk)
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")

        self._httpd = ThreadingHTTPServer((self.host, self.port), RequestHandler)
        if background:
            t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            t.start()
            return t
        self._httpd.serve_forever()

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()


def fastapi_available() -> bool:
    try:
        import fastapi  # noqa: F401
        import uvicorn  # noqa: F401

        return True
    except ImportError:
        return False


def controller_stdlib_app(controller, host: str, port: int) -> JsonRouteServer:
    srv = JsonRouteServer(host, port)
    srv.add_route(
        "/register_worker",
        lambda d: {"ok": controller.register_worker(
            d["worker_name"], d["check_heart_beat"], d.get("worker_status")
        )},
    )
    srv.add_route("/refresh_all_workers", lambda d: (controller.refresh_all_workers(), {})[1])
    srv.add_route("/list_models", lambda d: {"models": controller.list_models()})
    srv.add_route(
        "/get_worker_address",
        lambda d: {"address": controller.get_worker_address(d["model"])},
    )
    srv.add_route(
        "/receive_heart_beat",
        lambda d: {"exist": controller.receive_heart_beat(
            d["worker_name"], d["queue_length"]
        )},
    )
    srv.add_route(
        "/worker_generate_stream",
        lambda d: controller.worker_api_generate_stream(d),
    )
    return srv


def worker_stdlib_app(worker, host: str, port: int) -> JsonRouteServer:
    srv = JsonRouteServer(host, port)
    srv.add_route("/worker_get_status", lambda d: worker.get_status())
    srv.add_route("/worker_generate_stream", lambda d: worker.generate_stream_gate(d))
    return srv
