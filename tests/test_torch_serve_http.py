"""The port's model worker and controller over real stdlib HTTP on
127.0.0.1 against the JAX package's, on one tiny HF-style checkpoint
(``helpers.make_tiny_checkpoint``) loaded in bf16 on the CPU. The JAX
workers run once, in a module fixture, through ``generate_stream_gate``
without HTTP; the port's answer over HTTP. Greedy tokens are exact, so the
final texts must be equal: plain greedy with an image, ``--spec-k 3``, a
stop string and ``--kv-overflow ring`` with a window of 2. Also: three
concurrent requests (each prompt four times) give their solo texts with
one holder of the device lock at a time, a queued request streams
keep-alive acks, a bad request gets an ``error_code`` 1 chunk, a sampled
request draws from its own request number (the JAX stdlib server seeds
every request with 0), the controller's registry and dispatch equal the
JAX controller's, and the Gradio request flow and the client scripts run
against the port's stack."""

import base64
import json
import sys
import tempfile
import threading
import time
from io import BytesIO

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package below runs on the CPU, conftest)

from dynamic_llava_tpu import utils as jutils
from dynamic_llava_tpu_torch import utils as tutils

# the serving modules open their rotating log files when imported: both
# packages' go to a temporary directory
jutils.LOGDIR = tutils.LOGDIR = tempfile.mkdtemp(prefix="serve_logs_")

from dynamic_llava_tpu import conversation as jconversation  # noqa: E402
from dynamic_llava_tpu.serve import controller as jcontroller  # noqa: E402
from dynamic_llava_tpu.serve import gradio_web_server as jgradio  # noqa: E402
from dynamic_llava_tpu.serve import model_worker as jmw  # noqa: E402
from dynamic_llava_tpu_torch import conversation as tconversation  # noqa: E402
from dynamic_llava_tpu_torch.serve import controller as tcontroller  # noqa: E402
from dynamic_llava_tpu_torch.serve import gradio_web_server as tgradio  # noqa: E402
from dynamic_llava_tpu_torch.serve import http_compat  # noqa: E402
from dynamic_llava_tpu_torch.serve import model_worker as tmw  # noqa: E402
from dynamic_llava_tpu_torch.serve import register_worker, test_message  # noqa: E402

from helpers import make_tiny_checkpoint  # noqa: E402

NAME = "tiny-dynamic-llava"
MAX_NEW = 6
PROMPTS = ["USER : <image> What is in the image ? ASSISTANT :",
           "USER : Say hello . ASSISTANT :",
           "USER : Is there a dog ? ASSISTANT :"]
# case -> (worker options, request): the stop string is set from the plain answer
CASES = {
    "greedy": ({}, dict(prompt=PROMPTS[0], image=True)),
    "spec_k": ({"spec_k": 3}, dict(prompt=PROMPTS[0], image=True)),
    "stop": ({}, dict(prompt=PROMPTS[1])),
    "ring": ({"kv_overflow": "ring", "kv_window": 2}, dict(prompt=PROMPTS[1])),
}


def image64(seed=0, shape=(48, 48, 3)) -> str:
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, shape).astype("uint8")
    buf = BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def request(prompt, image=False, **kw) -> dict:
    params = {"model": NAME, "prompt": prompt, "temperature": 0.0, "max_new_tokens": MAX_NEW}
    if image:
        params["images"] = [image64()]
    params.update(kw)
    return params


def gate_chunks(worker, params) -> list:
    """A worker's chunks for ``params`` through ``generate_stream_gate``."""
    return [json.loads(c.rstrip(b"\0")) for c in worker.generate_stream_gate(dict(params))]


def serve(app) -> str:
    """Serve ``app`` (an ``http_compat.JsonRouteServer`` on port 0) in the
    background; its URL."""
    app.serve(background=True)
    return f"http://127.0.0.1:{app._httpd.server_address[1]}"


def stream(url, params, timeout=120) -> list:
    """The chunks a POST of ``params`` to ``url`` streams back."""
    import requests

    resp = requests.post(url + "/worker_generate_stream", json=params, stream=True,
                         timeout=timeout)
    return [json.loads(c.decode())
            for c in resp.iter_lines(decode_unicode=False, delimiter=b"\0") if c]


class CountingLock:
    """A lock that counts its acquisitions and the most holders at once."""

    def __init__(self, lock):
        self.lock, self.held, self.most, self.taken = lock, 0, 0, 0

    def acquire(self, *args, **kwargs):
        got = self.lock.acquire(*args, **kwargs)
        if got:
            self.held += 1
            self.taken += 1
            self.most = max(self.most, self.held)
        return got

    def release(self):
        self.held -= 1
        self.lock.release()

    def locked(self):
        return self.lock.locked()


def worker_kwargs(ckpt, **kw) -> dict:
    return dict(controller_addr="", worker_addr="", worker_id="t", no_register=True,
                model_path=ckpt, model_base=None, model_name=NAME, **kw)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_checkpoint(str(tmp_path_factory.mktemp("serve") / "ckpt"))


@pytest.fixture(scope="module")
def jax_ref(ckpt):
    """The JAX workers' final texts: each case of ``CASES``, and each of
    ``PROMPTS`` greedy without an image."""
    ref, reqs, workers = {}, {}, {}
    for case, (opts, req) in CASES.items():
        key = tuple(sorted(opts.items()))
        if key not in workers:
            workers[key] = jmw.ModelWorker(**worker_kwargs(ckpt, **opts))
        params = request(**req)
        if case == "stop":
            words = ref["plain-1"][len(PROMPTS[1]):].split()
            assert len(words) >= 3, ref["plain-1"]
            params["stop"] = words[2]
        chunks = gate_chunks(workers[key], params)
        assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
        ref[case], reqs[case] = chunks[-1]["text"], params
        if case == "greedy":
            for i, p in enumerate(PROMPTS):
                ref[f"plain-{i}"] = gate_chunks(workers[key], request(p))[-1]["text"]
    ref["requests"] = reqs
    return ref


@pytest.fixture(scope="module")
def port(ckpt):
    """The port's workers, one a set of options, each served over HTTP as
    it is first asked for; ``port["url"]`` is the plain worker's URL."""
    made = {}

    def get(**opts):
        key = tuple(sorted(opts.items()))
        if key not in made:
            w = tmw.ModelWorker(**worker_kwargs(ckpt, device="cpu",
                                                limit_model_concurrency=3, **opts))
            app = http_compat.worker_stdlib_app(w, "127.0.0.1", 0)
            made[key] = (w, app, serve(app))
        return made[key]

    w, _, url = get()
    yield {"get": get, "worker": w, "url": url}
    for w, app, _ in made.values():
        app.shutdown()
        w.close()


@pytest.mark.parametrize("case", list(CASES))
def test_model_worker_over_http_gives_the_jax_text(port, jax_ref, case):
    opts, _ = CASES[case]
    _, _, url = port["get"](**opts)
    chunks = stream(url, jax_ref["requests"][case])
    assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
    assert all(c["text"].startswith(jax_ref["requests"][case]["prompt"]) for c in chunks)
    assert chunks[-1]["text"] == jax_ref[case]
    if case == "stop":
        stop = jax_ref["requests"][case]["stop"]
        assert len(jax_ref[case]) < len(jax_ref["plain-1"])
        assert not chunks[-1]["text"].endswith(stop)


def test_spec_k_needs_drop_mode(ckpt):
    with pytest.raises(ValueError, match="drop"):
        tmw.ModelWorker(**worker_kwargs(ckpt, device="cpu", spec_k=3, kv_overflow="ring"))


def test_sampled_request_draws_from_its_request_number(port, jax_ref):
    """Every request is counted (stdlib flavour too); a sampled request's
    tokens are ``Generator.generate``'s with the request number as seed,
    and it replaces the kept ``Generator``, which a greedy request then
    replaces back."""
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.mm_utils import tokenizer_image_token

    w, url = port["worker"], port["url"]
    before = w.global_counter
    params = request(PROMPTS[1], temperature=0.7, top_p=0.9)
    chunks = stream(url, params)
    assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
    assert w.global_counter == before + 1
    assert w._gen_key == (0.7, 0.9)

    gen = Generator(w.runtime.params, w.runtime.cfg, GenerationConfig(
        max_new_tokens=MAX_NEW, temperature=0.7, top_p=0.9,
        eos_token_id=w.tokenizer.eos_token_id))
    ids = np.asarray(tokenizer_image_token(PROMPTS[1], w.tokenizer), np.int64)
    out = gen.generate([ids], seed=w.global_counter)[0]
    if out and out[-1] == w.tokenizer.eos_token_id:
        out = out[:-1]
    assert chunks[-1]["text"] == PROMPTS[1] + w.tokenizer.decode(out, skip_special_tokens=True)

    assert stream(url, request(PROMPTS[1]))[-1]["text"] == jax_ref["plain-1"]
    assert w._gen_key == (0.0, 1.0) and w.global_counter == before + 2


def test_concurrent_requests_give_their_solo_texts(port, jax_ref):
    """Each prompt sent four times, all twelve requests at once (more
    threads than the CPU's cores, the interpreter switching threads every
    microsecond): each holds the device lock from its prefill to its last
    chunk, so the runner's buffers are never shared, every answer is its
    solo text, and every request is counted once."""
    w, url = port["worker"], port["url"]
    lock = CountingLock(w._device_lock)
    sends = [i % len(PROMPTS) for i in range(4 * len(PROMPTS))]
    results = [None] * len(sends)
    before = w.global_counter

    def run(k):
        results[k] = stream(url, request(PROMPTS[sends[k]]))

    interval = sys.getswitchinterval()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(w, "_device_lock", lock)
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=run, args=(k,)) for k in range(len(sends))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
        finally:
            sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert (lock.taken, lock.most) == (len(sends), 1)  # one holder at a time
    for i, chunks in zip(sends, results):
        assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
        assert chunks[-1]["text"] == jax_ref[f"plain-{i}"]
    assert w.global_counter == before + len(sends)
    assert w.get_queue_length() == 0


def test_queued_request_streams_keepalive_acks(port, jax_ref):
    """A request waiting for a concurrency slot, and then for the device,
    streams acks (the prompt, error_code 0) before its answer; past
    ``max_queue_wait_s`` it gets an error_code 1 chunk."""
    w, url = port["worker"], port["url"]
    params = request(PROMPTS[1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(w, "keepalive_s", 0.05)
        for _ in range(w.limit_model_concurrency):
            w._gate.acquire()
        w._device_lock.acquire()
        got = []
        t = threading.Thread(target=lambda: got.extend(stream(url, params)))
        t.start()
        time.sleep(0.5)
        assert w.get_queue_length() == 1
        w._gate.release()
        time.sleep(0.3)
        w._device_lock.release()
        t.join(60)
        assert not t.is_alive()
        for _ in range(w.limit_model_concurrency - 1):
            w._gate.release()
        acks = [c for c in got if c["text"] == params["prompt"]]
        assert len(acks) >= 4 and all(c["error_code"] == 0 for c in got), got
        assert got[-1]["text"] == jax_ref["plain-1"]

        mp.setattr(w, "max_queue_wait_s", 0.2)
        for _ in range(w.limit_model_concurrency):
            w._gate.acquire()
        try:
            rejected = stream(url, params)
        finally:
            for _ in range(w.limit_model_concurrency):
                w._gate.release()
    assert rejected[-1]["error_code"] == 1
    assert all(c["error_code"] == 0 for c in rejected[:-1])
    assert w.get_queue_length() == 0


def test_bad_request_gets_an_error_chunk(port):
    chunks = stream(port["url"], request(PROMPTS[0], images=["!!!not-base64-image!!!"]))
    assert chunks[-1]["error_code"] == 1
    assert not port["worker"]._device_lock.locked()


def test_controller_registry_and_dispatch_match_jax():
    """The same registrations, heartbeats and picks on both controllers:
    the model list, shortest-queue picks (which raise the picked worker's
    queue), lottery picks under one ``np.random`` seed, heartbeats of known
    and unknown workers, and the stale-worker sweep."""
    statuses = {
        "http://a": {"model_names": ["m", "n"], "speed": 1, "queue_length": 2},
        "http://b": {"model_names": ["m"], "speed": 2, "queue_length": 3},
        "http://c": {"model_names": ["n"], "speed": 1, "queue_length": 0},
    }
    logs = {}
    for mod in (jcontroller, tcontroller):
        ctrls = {d: mod.Controller(d) for d in ("shortest_queue", "lottery")}
        log = []
        for ctrl in ctrls.values():
            for name, st in statuses.items():
                log.append(ctrl.register_worker(name, name != "http://c", dict(st)))
            log.append(ctrl.list_models())
        sq, lot = ctrls["shortest_queue"], ctrls["lottery"]
        log.append([sq.get_worker_address(m) for m in ("m", "m", "m", "n", "n", "x")])
        np.random.seed(0)
        log.append([lot.get_worker_address(m) for m in ("m",) * 8 + ("n",) * 4 + ("x",)])
        log.append([sq.receive_heart_beat("http://b", 0), sq.receive_heart_beat("http://z", 1)])
        log.append(sq.get_worker_address("m"))
        for ctrl in ctrls.values():
            for info in ctrl.worker_info.values():
                info.last_heart_beat -= 2 * mod.CONTROLLER_HEART_BEAT_EXPIRATION
            ctrl.receive_heart_beat("http://a", 0)
            ctrl.remove_stale_workers()
            log.append(sorted(ctrl.worker_info))
        logs[mod.__name__] = log
    assert logs["dynamic_llava_tpu_torch.serve.controller"] == logs[
        "dynamic_llava_tpu.serve.controller"]
    with pytest.raises(ValueError):
        tcontroller.Controller("random")


def test_stream_through_the_controllers(port, jax_ref):
    """The port's worker registered (by ``register_worker``, its status
    fetched over HTTP) with the port's controller and the JAX controller:
    the same model list and address, the same heartbeat answer, and the
    same chunks proxied through either; an unknown model gets the
    controller's error_code 2 chunk."""
    import requests

    w, wurl = port["worker"], port["url"]
    got = {}
    for mod in (jcontroller, tcontroller):
        ctrl = mod.Controller("shortest_queue")
        app = http_compat.controller_stdlib_app(ctrl, "127.0.0.1", 0)
        curl = serve(app)
        try:
            register_worker.register(curl, wurl)
            models = requests.post(curl + "/list_models").json()["models"]
            addr = requests.post(curl + "/get_worker_address", json={"model": NAME}).json()
            w.controller_addr, w.worker_addr = curl, wurl
            w.send_heart_beat()
            beat = ctrl.worker_info[wurl].last_heart_beat
            chunks = stream(curl, request(PROMPTS[0], image=True))
            missing = stream(curl, request(PROMPTS[0], model="nope"))
            got[mod.__name__] = (models, addr, beat > 0, chunks, missing)
        finally:
            app.shutdown()
            w.controller_addr = w.worker_addr = ""
    port_got = got["dynamic_llava_tpu_torch.serve.controller"]
    assert port_got == got["dynamic_llava_tpu.serve.controller"]
    models, addr, _, chunks, missing = port_got
    assert models == [NAME] and addr == {"address": wurl}
    assert chunks[-1]["text"] == jax_ref["greedy"]
    assert missing == [{"text": tutils.server_error_msg, "error_code": 2}]


def test_message_client_runs_against_the_port_stack(port, capsys):
    ctrl = tcontroller.Controller("shortest_queue")
    app = http_compat.controller_stdlib_app(ctrl, "127.0.0.1", 0)
    curl = serve(app)
    try:
        register_worker.main(["--controller-address", curl, "--worker-name", port["url"]])
        test_message.main(["--controller-address", curl, "--model-name", NAME,
                           "--max-new-tokens", "4", "--message", "Say hello ."])
    finally:
        app.shutdown()
    out = capsys.readouterr().out
    assert f"Models: ['{NAME}']" in out and f"worker_addr: {port['url']}" in out
    conv = tconversation.default_conversation.copy()
    conv.append_message(conv.roles[0], "Say hello .")
    assert conv.get_prompt().replace(conv.sep, "\n") in out


def test_gradio_request_flow_against_the_port_stack(port, tmp_path, monkeypatch):
    """``http_bot`` of both packages through the port's controller to the
    port's worker: the same streamed states and final answer (greedy), the
    same regenerate / clear results, and vote records in the conversation
    log."""
    monkeypatch.chdir(tmp_path)  # the conversation log lands in tmp
    ctrl = tcontroller.Controller("shortest_queue")
    app = http_compat.controller_stdlib_app(ctrl, "127.0.0.1", 0)
    curl = serve(app)
    runs = {}
    try:
        register_worker.register(curl, port["url"], check_heart_beat=False)
        for conv, gr in ((jconversation, jgradio), (tconversation, tgradio)):
            assert gr.get_model_list(curl) == [NAME]
            state = conv.default_conversation.copy()
            state.append_message(state.roles[0], "Say hello .")
            state.append_message(state.roles[1], None)
            updates = [st.messages[-1][-1] for st in
                       gr.http_bot(state, NAME, 0.0, 1.0, MAX_NEW, curl)]
            out = gr.regenerate(state)
            again = [st.messages[-1][-1] for st in
                     gr.http_bot(out[0], NAME, 0.0, 1.0, MAX_NEW, curl)]
            gr.upvote_last_response(out[0], NAME)
            cleared = gr.clear_history()
            runs[gr.__name__] = (updates, again, out[1:], list(map(list, cleared[0].messages)),
                                 cleared[1:])
    finally:
        app.shutdown()
    assert runs["dynamic_llava_tpu_torch.serve.gradio_web_server"] == runs[
        "dynamic_llava_tpu.serve.gradio_web_server"]
    updates, again, _, _, _ = runs["dynamic_llava_tpu_torch.serve.gradio_web_server"]
    assert updates[0] == "▌" and not updates[-1].endswith("▌")
    assert again[-1] == updates[-1] and "error_code" not in updates[-1]
    with open(tgradio.get_conv_log_filename()) as f:
        types = [json.loads(line)["type"] for line in f if line.strip()]
    assert types.count("chat") == 4 and types.count("upvote") == 2
