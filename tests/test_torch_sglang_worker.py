"""The port's ``BatchedWorker`` over real stdlib HTTP on 127.0.0.1 against
the JAX package's, on one tiny checkpoint (``helpers.make_tiny_checkpoint``)
loaded in bf16 on the CPU: the window micro-batch (three requests in one
batch), greedy micro-batches under ``--spec-k 3`` and ``--continuous``
(three requests on two slots, the third joining the running batch) give
the JAX workers' final texts for the same requests; requests of mixed
temperatures split into batches as the JAX worker splits them; a bad
request gets an ``error_code`` 1 chunk; the worker registers and beats
with the port's controller; ``close()`` ends its threads and drops the
model. The JAX workers run once, in a module fixture, through
``generate_stream_gate`` without HTTP."""

import json
import threading
import time
import types

import pytest

import jax  # noqa: F401  (the JAX package below runs on the CPU, conftest)

from test_torch_serve_http import NAME, image64, serve, stream

from dynamic_llava_tpu.serve import sglang_worker as jsw
from dynamic_llava_tpu_torch.serve import controller as tcontroller
from dynamic_llava_tpu_torch.serve import http_compat
from dynamic_llava_tpu_torch.serve import sglang_worker as tsw

from helpers import make_tiny_checkpoint

MAX_NEW = 6
PROMPTS = ["USER : <image> What is in the image ? ASSISTANT :",
           "USER : Is there a dog ? ASSISTANT :",
           "USER : describe briefly ASSISTANT :"]
# arm -> (worker options, prompts sent at once)
ARMS = {
    "window": ({}, PROMPTS),
    "spec_k": ({"spec_k": 3}, PROMPTS[1:]),
    "continuous": ({"continuous": True, "slots": 2, "prompt_bucket": 32,
                    "max_new_cap": MAX_NEW}, PROMPTS),
}
WORKER = dict(max_batch=8, batch_window_ms=200, decode_chunk=4, model_name=NAME)


def request(prompt, **kw) -> dict:
    params = {"model": NAME, "prompt": prompt, "temperature": 0.0, "max_new_tokens": MAX_NEW}
    if "<image>" in prompt:
        params["images"] = [image64()]
    params.update(kw)
    return params


def at_once(send, params_list) -> list:
    """``send(params)`` of every request, each on a thread of its own,
    started together; their results."""
    out = [None] * len(params_list)

    def run(i):
        out[i] = send(params_list[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(params_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
        assert not t.is_alive(), "a stream never completed"
    return out


def gate_chunks(worker, params) -> list:
    return [json.loads(c.rstrip(b"\0")) for c in worker.generate_stream_gate(dict(params))]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_checkpoint(str(tmp_path_factory.mktemp("sglang") / "ckpt"))


@pytest.fixture(scope="module")
def jax_ref(ckpt):
    """Each arm's chunks from the JAX worker, its requests sent at once, and
    the size of the last batch it ran."""
    ref = {}
    for arm, (opts, prompts) in ARMS.items():
        w = jsw.BatchedWorker(ckpt, **WORKER, **opts)
        ref[arm] = at_once(lambda p: gate_chunks(w, p), [request(p) for p in prompts])
        ref[arm + "-batch"] = w.last_batch_size
    return ref


@pytest.fixture(scope="module")
def port(ckpt):
    """The port's workers, one an arm, each served over HTTP as it is first
    asked for; closed at the end."""
    made = {}

    def get(arm):
        if arm not in made:
            w = tsw.BatchedWorker(ckpt, **WORKER, **ARMS[arm][0], device="cpu")
            app = http_compat.worker_stdlib_app(w, "127.0.0.1", 0)
            made[arm] = (w, serve(app), app)
        return made[arm]

    yield get
    for w, _, app in made.values():
        app.shutdown()
        w.close()


@pytest.mark.parametrize("arm", list(ARMS))
def test_batched_worker_over_http_gives_the_jax_texts(port, jax_ref, arm):
    w, url, _ = port(arm)
    prompts = ARMS[arm][1]
    got = at_once(lambda p: stream(url, p), [request(p) for p in prompts])
    for chunks, ref, p in zip(got, jax_ref[arm], prompts):
        assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
        assert all(c["text"].startswith(p) for c in chunks)
        assert chunks[-1]["text"] == ref[-1]["text"]
    if arm == "continuous":
        assert w.last_batch_size <= 2 and jax_ref[arm + "-batch"] <= 2
    else:
        # every request rode ONE micro-batch, as in the JAX worker
        assert w.last_batch_size == jax_ref[arm + "-batch"] == len(prompts)
        assert sorted(w.batch_log[-1]["prompts"]) == sorted(prompts)
    if arm == "window":
        # streamed a decode chunk at a time (chunks of 4 over 6 tokens)
        assert all(len(chunks) >= 2 for chunks in got)


def test_mixed_temperatures_split_as_in_jax():
    """``_take_batch`` on the same queue in both packages: the same batches,
    each of one temperature, at most ``max_batch``."""
    temps = [0.0, 0.7, 0.0, 0.0, 0.7, 0.2, 0.0]
    batches = {}
    for mod in (jsw, tsw):
        fake = types.SimpleNamespace(lock=threading.Lock(), max_batch=2, pending=[
            mod.Request({"prompt": str(i), "temperature": t}, None)
            for i, t in enumerate(temps)])
        runs = []
        while fake.pending:
            runs.append([r.params["prompt"] for r in mod.BatchedWorker._take_batch(fake)])
        batches[mod.__name__] = runs
    assert batches["dynamic_llava_tpu_torch.serve.sglang_worker"] == batches[
        "dynamic_llava_tpu.serve.sglang_worker"]
    assert batches["dynamic_llava_tpu.serve.sglang_worker"] == [
        ["0", "2"], ["1", "4"], ["3", "6"], ["5"]]


def test_mixed_temperatures_over_http(port, jax_ref):
    """Greedy and sampled requests at once: separate batches, the greedy
    ones with their JAX texts."""
    w, url, _ = port("window")
    n = w.batches_run
    params = [request(PROMPTS[0]), request(PROMPTS[1]), request(PROMPTS[2], temperature=0.7)]
    got = at_once(lambda p: stream(url, p), params)
    assert all(c["error_code"] == 0 for chunks in got for c in chunks)
    for chunks, ref in zip(got[:2], jax_ref["window"][:2]):
        assert chunks[-1]["text"] == ref[-1]["text"]
    ran = list(w.batch_log)[-(w.batches_run - n):]
    assert sorted((b["temperature"], len(b["prompts"])) for b in ran) in (
        [(0.0, 2), (0.7, 1)], [(0.0, 1), (0.0, 1), (0.7, 1)])


def test_continuous_worker_serves_sampled_requests(port):
    w, url, _ = port("continuous")
    chunks = stream(url, request(PROMPTS[1], temperature=0.7, top_p=0.9))
    assert chunks and all(c["error_code"] == 0 for c in chunks)
    assert chunks[-1]["text"].startswith(PROMPTS[1])


def test_bad_request_gets_an_error_chunk(port):
    for arm in ("window", "continuous"):
        _, url, _ = port(arm)
        chunks = stream(url, request(PROMPTS[1], images=["!!!not-base64-image!!!"]))
        assert chunks[-1]["error_code"] == 1


def test_registration_heartbeat_and_close(ckpt):
    """A registered worker: the controller lists it and dispatches to it,
    its heartbeat is answered; ``close()`` ends the batching and heartbeat
    threads, answers a request still queued with an error chunk, and drops
    the model."""
    import requests

    ctrl = tcontroller.Controller("shortest_queue")
    capp = http_compat.controller_stdlib_app(ctrl, "127.0.0.1", 0)
    curl = serve(capp)
    try:
        w = tsw.BatchedWorker(ckpt, **WORKER, device="cpu", controller_addr=curl,
                              worker_addr="http://127.0.0.1:9", no_register=False)
        assert w.get_status() == {"model_names": [NAME], "speed": 1, "queue_length": 0}
        assert requests.post(curl + "/list_models").json()["models"] == [NAME]
        w.send_heart_beat()
        assert ctrl.worker_info["http://127.0.0.1:9"].queue_length == 0
        addr = requests.post(curl + "/get_worker_address", json={"model": NAME}).json()
        assert addr == {"address": "http://127.0.0.1:9"}
        got = []
        w.batch_window_ms = 60_000  # the queued request is never batched
        time.sleep(0.5)  # the loop's current wait (200 ms) has ended
        w.submit(tsw.Request(request(PROMPTS[1]), got.append))
        w.close()
    finally:
        capp.shutdown()
    assert not w.thread.is_alive() and not w.heart_beat_thread.is_alive()
    assert [json.loads(c.rstrip(b"\0"))["error_code"] for c in got[:-1]] == [1]
    assert got[-1] is None
    assert w.runtime is None and w._gen is None and w._engine is None


def test_close_ends_a_continuous_worker(ckpt):
    w = tsw.BatchedWorker(ckpt, **WORKER, **ARMS["continuous"][0], device="cpu")
    out = gate_chunks(w, request(PROMPTS[1]))
    assert out[-1]["error_code"] == 0
    w.close()
    assert not w.thread.is_alive() and w._engine is None
