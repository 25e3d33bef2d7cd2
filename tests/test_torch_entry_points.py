"""The port's entry points against the JAX package's on one tiny HF-style
checkpoint (``helpers.make_tiny_checkpoint``: a real tokenizer, both
predictors), loaded in bf16 on the CPU: the VQA CLI's answers file
(greedy, plain and ``--spec_k 3``), the chat CLI's transcript over two
rounds (stdin fed from a list) and ``chat_loop``'s answers, and
``run_dynamic_llava``'s answer. Greedy tokens are exact, so the files and
transcripts must be equal. The JAX references run once, in a module
fixture."""

import builtins
import contextlib
import io
import json

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package below runs on the CPU, conftest)

from dynamic_llava_tpu.eval import model_vqa_loader as jvqa
from dynamic_llava_tpu.eval import run_dynamic_llava as jrun
from dynamic_llava_tpu.generation.generate import ChatSession as JChatSession
from dynamic_llava_tpu.serve import cli as jcli
from dynamic_llava_tpu_torch.eval import model_vqa_loader as tvqa
from dynamic_llava_tpu_torch.eval import run_dynamic_llava as trun
from dynamic_llava_tpu_torch.generation.generate import ChatSession as TChatSession
from dynamic_llava_tpu_torch.mm_utils import process_images
from dynamic_llava_tpu_torch.models.builder import load_pretrained_model
from dynamic_llava_tpu_torch.serve import cli as tcli

from helpers import make_tiny_checkpoint

TURNS = ["What is in the image ?", "Is there a dog ?"]
SPEC_K = ("0", "3")


def vqa_args(ckpt, images, questions, answers, spec_k):
    return ["--model-path", ckpt, "--image-folder", images, "--question-file", questions,
            "--answers-file", answers, "--temperature", "0", "--max_new_tokens", "4",
            "--spec_k", spec_k]


def chat_args(ckpt, image):
    return ["--model-path", ckpt, "--image-file", image, "--temperature", "0",
            "--max-new-tokens", "6"]


def run_cli(main, argv, turns=(), session_cls=None, asked=None):
    """``main(argv)``'s standard output, with ``input`` answered from
    ``turns`` (then end of file); with ``session_cls``, the token ids each
    ``session_cls.ask`` call was given are appended to ``asked``."""
    it = iter(turns)

    def fake_input(prompt=""):
        print(prompt, end="")
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(builtins, "input", fake_input)
        if session_cls is not None:
            ask = session_cls.ask

            def recording_ask(self, input_ids, *args, **kw):
                asked.append(np.asarray(input_ids).tolist())
                return ask(self, input_ids, *args, **kw)

            mp.setattr(session_cls, "ask", recording_ask)
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The checkpoint, two images, two questions, and the JAX CLIs' outputs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("entry")
    ckpt = make_tiny_checkpoint(str(root / "ckpt"))
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i, shape in enumerate([(48, 72, 3), (64, 40, 3)]):
        Image.fromarray(rng.integers(0, 255, shape).astype("uint8")).save(
            str(images / f"q{i}.jpg"))
    questions = root / "questions.jsonl"
    with open(questions, "w") as f:
        for i, q in enumerate(["Is there a dog ?", "What is in the image ?"]):
            f.write(json.dumps({"question_id": i, "image": f"q{i}.jpg", "text": q}) + "\n")
    ref = {"root": root, "ckpt": ckpt, "images": str(images), "questions": str(questions)}
    for k in SPEC_K:
        path = str(root / f"jax-{k}.jsonl")
        jvqa.main(vqa_args(ckpt, ref["images"], ref["questions"], path, k))
        with open(path) as f:
            ref[f"vqa-{k}"] = f.read()
    ref["asked"] = []
    ref["chat"] = run_cli(jcli.main, chat_args(ckpt, str(images / "q0.jpg")), TURNS,
                          JChatSession, ref["asked"])
    ref["run"] = run_cli(jrun.main, ["--model-path", ckpt, "--image-file",
                                     str(images / "q1.jpg"), "--query", TURNS[0],
                                     "--temperature", "0", "--max_new_tokens", "6"])
    return ref


@pytest.mark.parametrize("spec_k", SPEC_K)
def test_vqa_cli_writes_the_jax_answers(setup, spec_k):
    path = str(setup["root"] / f"port-{spec_k}.jsonl")
    tvqa.main(vqa_args(setup["ckpt"], setup["images"], setup["questions"], path, spec_k)
              + ["--device", "cpu"])
    with open(path) as f:
        got = f.read()
    assert got == setup[f"vqa-{spec_k}"]
    assert [json.loads(line)["text"] for line in got.splitlines()] == [
        json.loads(line)["text"] for line in setup["vqa-0"].splitlines()]


def test_chat_cli_transcript_matches_jax(setup):
    asked = []
    out = run_cli(tcli.main, chat_args(setup["ckpt"], str(setup["images"] + "/q0.jpg"))
                  + ["--device", "cpu"], TURNS, TChatSession, asked)
    # the same prompt ids each round: round 1 with BOS and the image token,
    # round 2 only the new text, without BOS
    assert asked == setup["asked"] and len(asked) == len(TURNS)
    assert asked[0][0] == 1 and -200 in asked[0] and asked[1][0] != 1
    assert out == setup["chat"]
    assert out.count("Assistant: ") == len(TURNS) and out.endswith("exit...\n")


def test_chat_loop_takes_turns_and_pixels(setup):
    tokenizer, runtime, processor, _ = load_pretrained_model(setup["ckpt"], device="cpu")
    from PIL import Image

    image = Image.open(setup["images"] + "/q0.jpg").convert("RGB")
    pixels = process_images([image], processor, runtime.cfg)
    kw = dict(conv_mode="llava_v0", temperature=0.0, max_new_tokens=6,
              echo=lambda *a, **k: None)
    answers = tcli.chat_loop(tokenizer, runtime, processor, pixels, TURNS, **kw)
    assert answers == tcli.chat_loop(tokenizer, runtime, processor, image, TURNS, **kw)
    assert answers == [line.split("\n")[0] for line in setup["chat"].split("Assistant: ")[1:]]


def test_run_dynamic_llava_matches_jax(setup):
    out = run_cli(trun.main, ["--model-path", setup["ckpt"], "--image-file",
                              setup["images"] + "/q1.jpg", "--query", TURNS[0],
                              "--temperature", "0", "--max_new_tokens", "6",
                              "--device", "cpu"])
    assert out == setup["run"] and out.strip()
