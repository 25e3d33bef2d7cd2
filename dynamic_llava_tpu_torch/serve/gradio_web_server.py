"""Gradio chat UI talking to the controller: the port's own copy of
``dynamic_llava_tpu/serve/gradio_web_server.py`` (``tests/test_torch_config.py``
holds the two equal).

The HTTP protocol to the controller and workers is the reference's, so this
UI fronts either package's stack. Gradio is optional: ``build_demo`` imports
it and fails with a clear message where it is absent. ``requests`` is
imported inside the functions that post (the one difference from the JAX
module, which imports it at the top), so the module imports where neither
is installed, and the request flow (``http_bot``) needs only ``requests``.

    python -m dynamic_llava_tpu_torch.serve.gradio_web_server \\
        --controller-url http://localhost:10000
"""

from __future__ import annotations

import argparse
import base64
import datetime
import json
import os
import time
from io import BytesIO

from ..constants import LOGDIR
from ..conversation import SeparatorStyle, default_conversation
from ..utils import build_logger, moderation_msg, server_error_msg, violates_moderation

logger = build_logger("gradio_web_server", "gradio_web_server.log")

headers = {"User-Agent": "Dynamic-LLaVA-TPU Client"}

no_change_btn = enable_btn = disable_btn = None  # bound after gradio import

priority = {"vicuna-13b": "aaaaaaa", "koala-13b": "aaaaaab"}


def get_conv_log_filename():
    t = datetime.datetime.now()
    return os.path.join(LOGDIR, f"{t.year}-{t.month:02d}-{t.day:02d}-conv.json")


def get_model_list(controller_url: str):
    import requests

    ret = requests.post(controller_url + "/refresh_all_workers")
    assert ret.status_code == 200
    ret = requests.post(controller_url + "/list_models")
    models = ret.json()["models"]
    models.sort(key=lambda x: priority.get(x, x))
    logger.info(f"Models: {models}")
    return models


def _encode_image(image) -> str:
    buf = BytesIO()
    image.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def vote_last_response(state, vote_type: str, model_selector: str,
                       ip: str = ""):
    """Append a vote record to the conversation log (reference
    gradio_web_server.py:84-93): same jsonl file as chat records, with the
    vote type in the ``type`` field so downstream analysis can join them."""
    with open(get_conv_log_filename(), "a") as f:
        f.write(json.dumps({
            "tstamp": round(time.time(), 4),
            "type": vote_type,
            "model": model_selector,
            "state": state.dict(),
            "ip": ip,
        }) + "\n")


def upvote_last_response(state, model_selector, request=None):
    logger.info("upvote.")
    vote_last_response(state, "upvote", model_selector, _ip(request))
    return ("",) + (disable_btn,) * 3


def downvote_last_response(state, model_selector, request=None):
    logger.info("downvote.")
    vote_last_response(state, "downvote", model_selector, _ip(request))
    return ("",) + (disable_btn,) * 3


def flag_last_response(state, model_selector, request=None):
    logger.info("flag.")
    vote_last_response(state, "flag", model_selector, _ip(request))
    return ("",) + (disable_btn,) * 3


def _ip(request) -> str:
    client = getattr(request, "client", None)
    return getattr(client, "host", "") if client is not None else ""


def regenerate(state, image_process_mode="Default", request=None):
    """Blank the last assistant turn and re-enable the bot flow so the same
    prompt is resubmitted (reference :109-116). A previous human turn that
    carried an image keeps it, with the (possibly changed) process mode."""
    logger.info("regenerate.")
    state.messages[-1][-1] = None
    prev_human = state.messages[-2]
    if isinstance(prev_human[1], (tuple, list)):
        prev_human[1] = (*prev_human[1][:2], image_process_mode)
    state.skip_next = False
    return (state, _chat_pairs(state), "", None) + (disable_btn,) * 5


def clear_history(request=None):
    logger.info("clear_history.")
    state = default_conversation.copy()
    return (state, _chat_pairs(state), "", None) + (disable_btn,) * 5


def _chat_pairs(state):
    """Render conversation messages as gradio chatbot [user, bot] pairs."""
    chat = []
    msgs = state.messages[state.offset:]
    for i in range(0, len(msgs) - 1, 2):
        q, a = msgs[i][1], msgs[i + 1][1]
        chat.append([q[0] if isinstance(q, (tuple, list)) else q,
                     a[0] if isinstance(a, (tuple, list)) else a])
    return chat


def http_bot(state, model_selector, temperature, top_p, max_new_tokens,
             controller_url: str):
    """Core request flow: controller -> worker -> streamed chunks. Yields
    progressively-updated conversation states."""
    import requests

    if state.skip_next:
        yield state
        return

    model_name = model_selector
    ret = requests.post(
        controller_url + "/get_worker_address", json={"model": model_name}
    )
    worker_addr = ret.json()["address"]
    if worker_addr == "":
        state.messages[-1][-1] = server_error_msg
        yield state
        return

    prompt = state.get_prompt()
    images = []
    for _, msg in state.messages:
        if isinstance(msg, tuple) and len(msg) >= 2 and msg[1] is not None:
            images.append(_encode_image(msg[1]))

    pload = {
        "model": model_name,
        "prompt": prompt,
        "temperature": float(temperature),
        "top_p": float(top_p),
        "max_new_tokens": min(int(max_new_tokens), 1536),
        "stop": (
            state.sep
            if state.sep_style in (SeparatorStyle.SINGLE, SeparatorStyle.MPT)
            else state.sep2
        ),
        "images": images,
    }
    state.messages[-1][-1] = "▌"
    yield state
    try:
        response = requests.post(
            worker_addr + "/worker_generate_stream",
            headers=headers, json=pload, stream=True, timeout=30,
        )
        for chunk in response.iter_lines(decode_unicode=False, delimiter=b"\0"):
            if not chunk:
                continue
            data = json.loads(chunk.decode())
            if data["error_code"] == 0:
                output = data["text"][len(prompt):].strip()
                state.messages[-1][-1] = output + "▌"
            else:
                state.messages[-1][-1] = (
                    f"{data['text']} (error_code: {data['error_code']})"
                )
                yield state
                return
            yield state
    except requests.exceptions.RequestException:
        state.messages[-1][-1] = server_error_msg
        yield state
        return
    state.messages[-1][-1] = state.messages[-1][-1].rstrip("▌")
    yield state

    with open(get_conv_log_filename(), "a") as f:
        f.write(json.dumps({
            "tstamp": round(time.time(), 4),
            "type": "chat",
            "model": model_name,
            "state": state.dict(),
        }) + "\n")


def build_demo(controller_url: str, concurrency_count: int = 10):
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; the serving stack "
            "is fully functional via serve.cli / serve.model_worker + any "
            "HTTP client speaking the worker_generate_stream protocol"
        ) from e

    global no_change_btn, enable_btn, disable_btn
    no_change_btn = gr.Button()
    enable_btn = gr.Button(interactive=True)
    disable_btn = gr.Button(interactive=False)

    models = get_model_list(controller_url)

    with gr.Blocks(title="Dynamic-LLaVA (TPU)") as demo:
        state = gr.State(default_conversation.copy())
        model_selector = gr.Dropdown(choices=models,
                                     value=models[0] if models else None)
        imagebox = gr.Image(type="pil")
        chatbot = gr.Chatbot(label="Dynamic-LLaVA-TPU")
        textbox = gr.Textbox(show_label=False)
        with gr.Row():
            temperature = gr.Slider(0.0, 1.0, value=0.2, label="Temperature")
            top_p = gr.Slider(0.0, 1.0, value=0.7, label="Top P")
            max_tokens = gr.Slider(0, 1024, value=512, step=64,
                                   label="Max output tokens")
        with gr.Row(elem_id="buttons"):
            upvote_btn = gr.Button(value="👍  Upvote", interactive=False)
            downvote_btn = gr.Button(value="👎  Downvote", interactive=False)
            flag_btn = gr.Button(value="⚠️  Flag", interactive=False)
            regenerate_btn = gr.Button(value="🔄  Regenerate",
                                       interactive=False)
            clear_btn = gr.Button(value="🗑️  Clear", interactive=False)
        btn_list = [upvote_btn, downvote_btn, flag_btn, regenerate_btn,
                    clear_btn]

        def add_text(state, text, image):
            if len(text) <= 0 and image is None:
                state.skip_next = True
                return state, "", None, state.to_gradio_chatbot() if hasattr(
                    state, "to_gradio_chatbot") else []
            if violates_moderation(text):
                state.skip_next = True
                return state, moderation_msg, None, []
            if image is not None:
                text = (text, image, "Default")
            state.append_message(state.roles[0], text)
            state.append_message(state.roles[1], None)
            state.skip_next = False
            chat = [
                [m[0] if isinstance(m[0], str) else m[0][0],
                 m[1] if isinstance(m[1], str) or m[1] is None else m[1][0]]
                for m in zip(state.messages[::2], state.messages[1::2])
            ]
            return state, "", None, chat

        def bot(state, model, temp, tp, mnt):
            for st in http_bot(state, model, temp, tp, mnt, controller_url):
                chat = []
                msgs = st.messages[st.offset:]
                for i in range(0, len(msgs) - 1, 2):
                    q = msgs[i][1]
                    a = msgs[i + 1][1]
                    chat.append([q[0] if isinstance(q, tuple) else q, a])
                yield st, chat

        bot_inputs = [state, model_selector, temperature, top_p, max_tokens]
        textbox.submit(
            add_text, [state, textbox, imagebox],
            [state, textbox, imagebox, chatbot],
        ).then(
            bot, bot_inputs, [state, chatbot],
        ).then(lambda: [enable_btn] * 5, None, btn_list)

        # vote / regenerate / clear (reference gradio_web_server.py:444-462)
        upvote_btn.click(
            upvote_last_response, [state, model_selector],
            [textbox, upvote_btn, downvote_btn, flag_btn],
        )
        downvote_btn.click(
            downvote_last_response, [state, model_selector],
            [textbox, upvote_btn, downvote_btn, flag_btn],
        )
        flag_btn.click(
            flag_last_response, [state, model_selector],
            [textbox, upvote_btn, downvote_btn, flag_btn],
        )
        regenerate_btn.click(
            regenerate, [state],
            [state, chatbot, textbox, imagebox] + btn_list,
        ).then(
            bot, bot_inputs, [state, chatbot],
        ).then(lambda: [enable_btn] * 5, None, btn_list)
        clear_btn.click(
            clear_history, None,
            [state, chatbot, textbox, imagebox] + btn_list,
        )
    return demo


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--controller-url", type=str, default="http://localhost:10000")
    parser.add_argument("--concurrency-count", type=int, default=10)
    parser.add_argument("--share", action="store_true")
    args = parser.parse_args(argv)
    demo = build_demo(args.controller_url, args.concurrency_count)
    demo.queue().launch(server_name=args.host, server_port=args.port,
                        share=args.share)


if __name__ == "__main__":
    main()
