"""The port's offline eval generators and scorers against the JAX package's.

The five generators (``model_vqa``, ``model_vqa_science``,
``model_vqa_qbench``, ``model_qa``, ``model_vqa_mmbench``) on one tiny
HF-style checkpoint (``helpers.make_tiny_checkpoint``), loaded once in bf16
on the CPU, write the JAX generators' answers files: greedy tokens are
exact, so every record is equal but ``answer_id`` (a random uuid where the
generator writes one). mmbench reads a TSV with base64 images that the test
writes. The JAX ScienceQA generator fixes 1024 new tokens; its
``GenerationConfig`` is capped at ``MAX_NEW`` for the run, and the port's
takes ``--max_new_tokens``. The JAX generators run once, in a module
fixture.

The scorers: the cases of ``tests/test_eval_scorers.py`` (all but POPE,
which ``tests/test_torch_entry_points.py`` holds) and the ``eval_mme`` /
``eval_science_qa`` cases of ``tests/test_eval_surface.py``, on the port,
each result equal to the JAX scorer's on the same input; and
``eval_textvqa`` / ``eval_science_qa`` end to end over answers files."""

import base64
import io
import json
import os
import random

import numpy as np
import pytest
from PIL import Image

import jax  # noqa: F401  (the JAX package below runs on the CPU, conftest)

from dynamic_llava_tpu.eval import eval_mme as jmme
from dynamic_llava_tpu.eval import eval_science_qa as jsqa
from dynamic_llava_tpu.eval import eval_textvqa as jtextvqa
from dynamic_llava_tpu.eval import model_qa as jqa
from dynamic_llava_tpu.eval import model_vqa as jvqa
from dynamic_llava_tpu.eval import model_vqa_mmbench as jmmbench
from dynamic_llava_tpu.eval import model_vqa_qbench as jqbench
from dynamic_llava_tpu.eval import model_vqa_science as jscience
from dynamic_llava_tpu.eval import vqa_metrics as jmetrics
from dynamic_llava_tpu.generation import generate as jgenerate
from dynamic_llava_tpu_torch.eval import eval_mme as tmme
from dynamic_llava_tpu_torch.eval import eval_science_qa as tsqa
from dynamic_llava_tpu_torch.eval import eval_textvqa as ttextvqa
from dynamic_llava_tpu_torch.eval import model_qa as tqa
from dynamic_llava_tpu_torch.eval import model_vqa as tvqa
from dynamic_llava_tpu_torch.eval import model_vqa_mmbench as tmmbench
from dynamic_llava_tpu_torch.eval import model_vqa_qbench as tqbench
from dynamic_llava_tpu_torch.eval import model_vqa_science as tscience
from dynamic_llava_tpu_torch.eval import vqa_metrics as tmetrics
from dynamic_llava_tpu_torch.models.builder import load_pretrained_model

from helpers import make_tiny_checkpoint

MAX_NEW = 6
QUESTIONS = ["What is in the image ?", "Is there a dog ?", "describe briefly"]
# generator name -> (JAX module, port module)
GENERATORS = {"model_vqa": (jvqa, tvqa), "model_vqa_science": (jscience, tscience),
              "model_vqa_qbench": (jqbench, tqbench), "model_qa": (jqa, tqa),
              "model_vqa_mmbench": (jmmbench, tmmbench)}


def write_inputs(root):
    """Three images and each generator's question file: ``{name: argv}``
    without ``--answers-file``."""
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    encoded = []
    for i, (h, w) in enumerate([(48, 72), (64, 40), (56, 56)]):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        img.save(str(images / f"q{i}.png"))
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        encoded.append(base64.b64encode(buf.getvalue()).decode())

    def jsonl(name, rows):
        path = root / name
        path.write_text("".join(json.dumps(r) + "\n" for r in rows))
        return str(path)

    vqa = jsonl("vqa.jsonl", [{"question_id": i, "image": f"q{i}.png", "text": q}
                              for i, q in enumerate(QUESTIONS)])
    sqa = root / "sqa.json"
    sqa.write_text(json.dumps([
        {"id": "p0", "image": "q0.png", "conversations": [
            {"from": "human", "value": "<image>\nWhat is in the image ?\nA. a cat\nB. a dog"}]},
        {"id": "p1", "conversations": [{"from": "human", "value": "Is there a dog ?"}]},
        {"id": "p2", "image": "q2.png", "conversations": [
            {"from": "human", "value": "describe briefly <image>"}]},
    ]))
    qbench = root / "qbench.json"
    qbench.write_text(json.dumps([
        {"img_path": "q1.png", "question": "Is there a dog ?", "candidates": ["yes", "no"],
         "correct_ans": "no"},
        {"img_path": "q2.png", "question": "What is in the image ?",
         "candidates": ["a cat", "a dog", "the world"]},
    ]))
    qa = jsonl("qa.jsonl", [{"question_id": f"t{i}", "text": q, "category": "generic"}
                            for i, q in enumerate(QUESTIONS[:2])])
    tsv = root / "mmbench.tsv"
    tsv.write_text("index\tquestion\thint\tA\tB\tC\tD\timage\n"
                   f"0\tIs there a dog ?\t\tyes\tno\t\t\t{encoded[0]}\n"
                   f"1\tWhat is in the image ?\tthe picture\ta cat\ta dog\thello\t\t{encoded[1]}\n")
    short = ["--max_new_tokens", str(MAX_NEW)]
    return {
        "model_vqa": ["--image-folder", str(images), "--question-file", vqa] + short,
        "model_vqa_science": ["--image-folder", str(images), "--question-file", str(sqa),
                              "--single-pred-prompt"],
        "model_vqa_qbench": ["--image-folder", str(images), "--questions-file", str(qbench)]
                            + short,
        "model_qa": ["--question-file", qa, "--temperature", "0"] + short,
        "model_vqa_mmbench": ["--question-file", str(tsv), "--all-rounds",
                              "--single-pred-prompt"] + short,
    }


def read_records(path):
    """An answers file's records without their random ``answer_id``."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "answer_id"} for line in f]


def capped_generation_config(n):
    real = jgenerate.GenerationConfig

    def make(**kw):
        return real(**{**kw, "max_new_tokens": min(kw["max_new_tokens"], n)})

    return make


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("generators")
    ckpt = make_tiny_checkpoint(str(root / "ckpt"))
    argvs = write_inputs(root)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX ScienceQA generator fixes max_new_tokens=1024
        mp.setattr(jgenerate, "GenerationConfig", capped_generation_config(MAX_NEW))
        for name, (jmod, _) in GENERATORS.items():
            path = str(root / f"jax-{name}.jsonl")
            jmod.main(["--model-path", ckpt, "--answers-file", path] + argvs[name])
            want[name] = read_records(path)
    return {"root": root, "ckpt": ckpt, "argvs": argvs, "want": want,
            "loaded": load_pretrained_model(ckpt, device="cpu")}


def port_args(setup, name, tag, *extra):
    path = str(setup["root"] / f"port-{name}-{tag}.jsonl")
    argv = (["--model-path", setup["ckpt"], "--answers-file", path] + setup["argvs"][name]
            + ["--device", "cpu"] + list(extra))
    if name == "model_vqa_science":
        argv += ["--max_new_tokens", str(MAX_NEW)]
    return GENERATORS[name][1].parser().parse_args(argv), path


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_writes_the_jax_answers(setup, name):
    args, path = port_args(setup, name, "plain")
    GENERATORS[name][1].eval_model(args, loaded=setup["loaded"])
    got, want = read_records(path), setup["want"][name]
    assert got == want
    n = {"model_vqa_mmbench": 2 + 3, "model_qa": 2, "model_vqa_qbench": 2}.get(name, 3)
    assert len(got) == n
    texts = [r.get("text", r.get("response")) for r in got]
    assert all(isinstance(t, str) for t in texts) and any(texts)


@pytest.mark.parametrize("name", ["model_vqa", "model_vqa_science", "model_qa"])
def test_generator_spec_k_writes_the_same_answers(setup, name):
    args, path = port_args(setup, name, "spec", "--spec_k", "3")
    GENERATORS[name][1].eval_model(args, loaded=setup["loaded"])
    assert read_records(path) == setup["want"][name]


def test_generator_main_loads_its_own_checkpoint(setup):
    path = str(setup["root"] / "port-model_qa-main.jsonl")
    tqa.main(["--model-path", setup["ckpt"], "--answers-file", path]
             + setup["argvs"]["model_qa"] + ["--device", "cpu"])
    assert read_records(path) == setup["want"]["model_qa"]
    # text-only: the records carry no prompt and no image
    assert all(set(r) == {"question_id", "text", "model_id", "metadata"}
               for r in read_records(path))


def test_science_records_keep_the_image_tag_only_where_there_is_an_image(setup):
    got = setup["want"]["model_vqa_science"]
    assert [r["prompt"].startswith("<image>\n") for r in got] == [True, False, True]
    assert all(r["prompt"].endswith("directly.") for r in got)


def test_mmbench_rounds_rotate_the_options(setup):
    got = setup["want"]["model_vqa_mmbench"]
    assert [(r["question_id"], r["round_id"]) for r in got] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (1, 2)]
    assert [r["option_char"] for r in got[2:]] == [["A", "B", "C"], ["B", "C", "A"],
                                                   ["C", "A", "B"]]
    assert got[2]["prompt"].startswith("the picture\n")


# ------------------------------------------------------------------ scorers


def test_vqa_answer_processor():
    p, jp = tmetrics.VQAAnswerProcessor(), jmetrics.VQAAnswerProcessor()
    for text, want in (("A Red Cat!", "red cat"), ("two", "2"), ("isnt", "isn't"),
                       ("the answer, obviously", "answer obviously")):
        assert p(text) == jp(text) == want
    for text in ("It's 1,000 dollars.", "no; none", "Hes   here\tnow", "(a) 3.5 apples"):
        assert p(text) == jp(text)


def test_textvqa_accuracy():
    preds = [
        {"pred_answer": "red", "gt_answers": ["red"] * 10},
        {"pred_answer": "blue", "gt_answers": ["red"] * 10},
        {"pred_answer": "Red", "gt_answers": ["red"] * 5 + ["crimson"] * 5},
    ]
    acc = tmetrics.TextVQAAccuracyEvaluator().eval_pred_list(preds)
    assert 0.5 < acc < 0.8
    assert acc == jmetrics.TextVQAAccuracyEvaluator().eval_pred_list(preds)


def test_stvqa_accuracy():
    preds = [
        {"pred_answer": "A cat", "gt_answers": ["cat", "dog"]},
        {"pred_answer": "fish", "gt_answers": ["cat", "dog"]},
    ]
    assert tmetrics.STVQAAccuracyEvaluator().eval_pred_list(preds) == 0.5
    assert jmetrics.STVQAAccuracyEvaluator().eval_pred_list(preds) == 0.5


def test_sqa_answer_parsing():
    for text, want in (("The answer is B.", "B"), ("A.", "A"), ("(C) because...", "C"),
                       ("I don't know", "FAILED")):
        assert tsqa.parse_answer(text, "ABCDE") == jsqa.parse_answer(text, "ABCDE") == want


def test_score_sqa_end_to_end(tmp_path):
    problems = {
        "p1": {"choices": ["x", "y"], "answer": 1},
        "p2": {"choices": ["x", "y", "z"], "answer": 0},
        "p3": {"choices": ["x", "y"], "answer": 0},
    }
    predictions = {
        "p1": {"text": "The answer is B.", "prompt": "<image> q1"},
        "p2": {"text": "A. because", "prompt": "q2"},
    }
    random.seed(0)
    scores = tsqa.score_sqa(problems, predictions)
    random.seed(0)
    jscores = jsqa.score_sqa(problems, predictions)
    assert {k: v for k, v in scores.items() if k != "judgments"} == {
        k: v for k, v in jscores.items() if k != "judgments"}
    assert [tuple(j) for j in scores["judgments"]] == [tuple(j) for j in jscores["judgments"]]
    assert scores["count"] == 3
    assert scores["correct"] >= 2
    assert scores["img_count"] == 1 and scores["img_correct"] == 1
    by_id = {j.question_id: j for j in scores["judgments"]}
    assert by_id["p1"].parsed_ans == "B" and by_id["p1"].correct
    assert by_id["p2"].parsed_ans == "A" and by_id["p2"].correct
    assert by_id["p3"].parsed_ans == "FAILED"

    out_f, res_f = tmp_path / "out.json", tmp_path / "res.json"
    tsqa.write_outputs(scores, str(out_f), str(res_f))
    jsqa.write_outputs(jscores, str(tmp_path / "jout.json"), str(tmp_path / "jres.json"))
    res = json.loads(res_f.read_text())
    assert res == json.loads((tmp_path / "jres.json").read_text())
    assert out_f.read_text() == (tmp_path / "jout.json").read_text()
    assert res["count"] == 3 and res["results"]["p1"] == 1
    split = json.loads(out_f.read_text())
    assert {a["question_id"] for a in split["correct"]} >= {"p1", "p2"}


def test_parse_strict_answer():
    for text, want in (("Blah. The answer is B.", "B"),
                       ("The answer is B. The answer is C.", "FAILED"), ("B", "FAILED")):
        assert tsqa.parse_strict_answer(text) == jsqa.parse_strict_answer(text) == want


def test_parse_yes_no():
    for text, want in (("Yes, it is.", "yes"), ("No", "no"), ("nope", "no"),
                       ("maybe", "other")):
        assert tmme.parse_yes_no(text) == jmme.parse_yes_no(text) == want


def test_mme_scoring():
    records = [
        {"category": "existence", "image": "A", "question": "q1", "gt": "yes", "pred": "Yes"},
        {"category": "existence", "image": "A", "question": "q2", "gt": "no", "pred": "No."},
        {"category": "existence", "image": "B", "question": "q1", "gt": "yes", "pred": "Yes"},
        {"category": "existence", "image": "B", "question": "q2", "gt": "yes", "pred": "No"},
        {"category": "code_reasoning", "image": "C", "question": "q", "gt": "no",
         "pred": "no"},
    ]
    report = tmme.score_records(records)
    assert report == jmme.score_records(records)
    ex = report["subtasks"]["existence"]
    assert ex["acc"] == 75.0 and ex["acc_plus"] == 50.0 and ex["score"] == 125.0
    assert report["perception"] == 125.0
    assert report["cognition"] == 200.0
    assert report["total"] == 325.0


def _jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def test_mme_convert_with_dir_gt_and_annotations(tmp_path):
    qfile = _jsonl(tmp_path / "q.jsonl", [
        {"question_id": 0, "image": "existence/img1.jpg",
         "text": "Is there a dog? Please answer yes or no.", "category": "existence"},
    ])
    rfile = _jsonl(tmp_path / "r.jsonl", [{"question_id": 0, "text": "Yes"}])
    task_dir = tmp_path / "MME" / "existence"
    os.makedirs(task_dir)
    (task_dir / "img1.txt").write_text("Is there a dog? Please answer yes or no.\tYes\n")
    records = tmme.convert_answers(qfile, rfile, mme_dir=str(tmp_path / "MME"))
    assert records == jmme.convert_answers(qfile, rfile, mme_dir=str(tmp_path / "MME"))
    assert records[0]["gt"] == "yes"
    assert tmme.score_records(records)["subtasks"]["existence"]["score"] == 200.0
    ann = _jsonl(tmp_path / "ann.jsonl", [{"question_id": 0, "answer": "No"}])
    records = tmme.convert_answers(qfile, rfile, annotation_file=ann)
    assert records == jmme.convert_answers(qfile, rfile, annotation_file=ann)
    assert records[0]["gt"] == "no"


def test_textvqa_and_science_scorers_read_the_answers_files(setup, tmp_path, capsys):
    """``eval_textvqa.eval_single`` over the VQA answers and the ScienceQA
    CLI over the ScienceQA answers, each equal to the JAX scorer's."""
    answers = str(setup["root"] / "jax-model_vqa.jsonl")
    ann = tmp_path / "TextVQA_val.json"
    ann.write_text(json.dumps({"data": [
        {"image_id": i, "question": q, "answers": [a] * 10}
        for i, (q, a) in enumerate(zip(QUESTIONS, ["a red cat", "no", "hello"]))]}))
    acc = ttextvqa.eval_single(str(ann), answers)
    assert acc == jtextvqa.eval_single(str(ann), answers) and 0.0 <= acc <= 1.0
    assert ttextvqa.prompt_processor("OCR tokens: a b Question: Why? Short answer:") == "why?"

    base = tmp_path / "sqa"
    base.mkdir()
    (base / "problems.json").write_text(json.dumps(
        {f"p{i}": {"choices": ["a cat", "a dog"], "answer": i % 2} for i in range(3)}))
    (base / "pid_splits.json").write_text(json.dumps({"test": ["p0", "p1", "p2"]}))
    result = str(setup["root"] / "jax-model_vqa_science.jsonl")
    outs = {}
    for name, mod in (("port", tsqa), ("jax", jsqa)):
        random.seed(0)
        capsys.readouterr()
        mod.main(["--base-dir", str(base), "--result-file", result,
                  "--output-result", str(tmp_path / f"{name}.json")])
        outs[name] = (capsys.readouterr().out, (tmp_path / f"{name}.json").read_text())
    assert outs["port"] == outs["jax"]
    assert outs["port"][0].startswith("Total: 3, Correct: ")
