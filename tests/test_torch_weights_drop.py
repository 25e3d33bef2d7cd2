"""The weights-drop golden on the port
(``dynamic_llava_tpu_torch/run/weights_drop_check.py``: checkpoint dir ->
chunked ``model_vqa_loader`` -> merge -> ``convert_gqa_for_eval`` -> GQA
scores), on the CPU:

- its own ``make_tiny_checkpoint`` writes the files of the test suite's
  ``helpers.make_tiny_checkpoint`` (the same state dict, tensor for tensor;
  the same tokenizer and config files, byte for byte) and leaves the
  caller's global torch generator as it was;
- the twin on its hermetic fixture with ``--device cpu`` exits 0 with
  ``format_ok`` and 4 of 4 questions answered;
- it exits 1 when a chunk's answers are missing;
- ``chip_smoke.weights_drop`` (phase 5i) rehearsed on the CPU, with the
  fixture's checkpoint in the 7B checkpoint's place: every hold passes;
  a planted difference between the two fixture runs passes only where
  ``fixture_divergence`` finds a near tie;
- ``chip_smoke.fixture_divergence`` on a planted divergence: the first
  differing token and the tie verdict under a zero and an infinite
  near-tie bound;
- ``slow`` (as ``tests/test_weights_drop_golden.py``, which runs the JAX
  script for minutes): its predictions file equals the JAX script's on the
  same fixture (both load bf16 on the CPU; greedy answers are exact).
"""

import contextlib
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dynamic_llava_tpu_torch.eval import model_vqa_loader
from dynamic_llava_tpu_torch.generation import near_tie
from dynamic_llava_tpu_torch.generation.generate import Generator
from dynamic_llava_tpu_torch.run import weights_drop_check as wdc

import chip_smoke
from helpers import make_tiny_checkpoint

ROOT = Path(__file__).resolve().parent.parent
FILES = ("tokenizer.json", "tokenizer_config.json", "config.json")


def _run(argv):
    """The twin's ``main(argv)``: (exit code, the JSON line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as ex:
        wdc.main(argv)
    return ex.value.code, json.loads(out.getvalue().strip().splitlines()[-1])


def test_tiny_checkpoint_equals_the_test_helper(tmp_path):
    state = torch.get_rng_state()
    got = Path(wdc.make_tiny_checkpoint(str(tmp_path / "port")))
    assert torch.equal(torch.get_rng_state(), state)
    want = Path(make_tiny_checkpoint(str(tmp_path / "helper")))
    for name in FILES:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    a = torch.load(got / "pytorch_model.bin")
    b = torch.load(want / "pytorch_model.bin")
    assert list(a) == list(b)
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in b)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    work = tmp_path_factory.mktemp("weights_drop")
    code, result = _run(["--device", "cpu", "--work-dir", str(work)])
    return work, code, result


def test_golden_answers_every_question_on_the_cpu(golden):
    work, code, result = golden
    assert code == 0, result
    assert result["format_ok"] and result["answered"] == result["questions"] == 4
    assert result["accuracy"] is not None
    preds = json.loads(Path(result["predictions"]).read_text())
    assert [p["questionId"] for p in preds] == ["q0", "q1", "q2", "q3"]
    assert all(isinstance(p["prediction"], str) for p in preds)
    assert Path(result["predictions"]).parent == work


def test_golden_fails_when_a_chunk_is_missing(golden, tmp_path, monkeypatch):
    work = golden[0]
    real = model_vqa_loader.main

    def chunk_one_lost(argv):
        real(argv)
        if argv[argv.index("--chunk-idx") + 1] == "1":
            Path(argv[argv.index("--answers-file") + 1]).write_text("")

    monkeypatch.setattr(model_vqa_loader, "main", chunk_one_lost)
    code, result = _run(["--device", "cpu", "--work-dir", str(tmp_path),
                         "--model-path", str(work / "ckpt"),
                         "--question-file", str(work / "questions.jsonl"),
                         "--image-folder", str(work / "images")])
    assert code == 1
    assert result["questions"] == 4 and result["answered"] == 2 and result["format_ok"]
    assert result["accuracy"] is None  # no --answers-json with --model-path


def _phase_5i(golden, tmp_path):
    """Phase 5i's function on the CPU: the fixture's checkpoint (copied:
    the phase writes a word tokenizer beside it) and images in the place of
    phase 5e's."""
    work = golden[0]
    ckpt = shutil.copytree(work / "ckpt", tmp_path / "ckpt")
    images = sorted(p.name for p in (work / "images").iterdir())
    return chip_smoke.weights_drop(torch, str(ckpt), str(work / "images"), images, device="cpu")


@pytest.mark.parametrize("planted", [None, "a near tie", "no near tie"])
def test_chip_smoke_weights_drop_phase_on_the_cpu(golden, tmp_path, monkeypatch, planted):
    """Unplanted, the two fixture runs agree. Planted (the second run's
    first prediction rewritten), the phase asks ``fixture_divergence`` (here
    a stand-in with the given verdict) and goes on at a near tie, or raises."""
    if planted is not None:
        real = wdc.run

        def second_run_differs(argv):
            result, secs = real(argv)
            if argv[argv.index("--work-dir") + 1].endswith("fixture_card"):
                path = Path(result["predictions"])
                preds = json.loads(path.read_text())
                preds[0]["prediction"] += " planted"
                path.write_text(json.dumps(preds))
            return result, secs

        asked = []
        monkeypatch.setattr(wdc, "run", second_run_differs)
        monkeypatch.setattr(chip_smoke, "fixture_divergence", lambda *a, **k: asked.append(
            a[2]["question_id"]) or {"stands": planted == "a near tie"})
    if planted == "no near tie":
        with pytest.raises(RuntimeError, match="without a near tie"):
            _phase_5i(golden, tmp_path)
        assert asked == ["q0"]
        return
    r = _phase_5i(golden, tmp_path)
    fx = r["fixture"]
    assert fx["answered"] == fx["questions"] == 4 and fx["format_ok"]
    assert fx["equal"] is (planted is None)
    assert list(fx["near_ties"]) == ([] if planted is None else ["q0"])
    for chunks in ("chunks2", "chunks1"):
        run = r["ckpt_7b"][chunks]
        assert run["answered"] == run["questions"] == chip_smoke.WDROP_QUESTIONS
        assert run["format_ok"]
    assert r["ckpt_7b"]["equal"] and len(r["ckpt_7b"]["predictions"]) == chip_smoke.WDROP_QUESTIONS
    assert r["wrapper_calls"] == {"flash_fwd": 0, "decode_kernel": 0}


@pytest.mark.parametrize("bound, stands", [(0.0, False), (float("inf"), True)])
def test_fixture_divergence_finds_a_planted_divergence(golden, monkeypatch, bound, stands):
    """The second generation (the card's place) with its second token
    changed: the divergence is found at j = 1 on the first's token path, and
    it stands as a near tie exactly when the bound lets it."""
    work = golden[0]
    real, calls = Generator.generate, []

    def second_call_differs(self, *a, **k):
        out = real(self, *a, **k)
        calls.append(list(out[0]))
        if len(calls) == 2:
            out = [out[0][:1] + [out[0][1] + 1] + out[0][2:]] + out[1:]
        return out

    monkeypatch.setattr(Generator, "generate", second_call_differs)
    monkeypatch.setattr(near_tie, "near_tie_bound", lambda scale, roundings: bound)
    files = ["--model-path", str(work / "ckpt"),
             "--question-file", str(work / "questions.jsonl"),
             "--image-folder", str(work / "images")]
    args = wdc.parser().parse_args(files)
    question = json.loads((work / "questions.jsonl").read_text().splitlines()[0])
    r = chip_smoke.fixture_divergence(torch, args.model_path, question, args.image_folder,
                                      args, device="cpu")
    assert len(calls) == 2 and calls[0] == calls[1] and len(calls[0]) > 2
    assert r["j"] == 1 and r["cpu_tokens"] == calls[0]
    assert r["card_tokens"][1] == calls[0][1] + 1
    assert r["gap_bound"] == bound and r["gap"] >= 0.0
    assert r["stands"] is stands


@pytest.mark.slow
def test_predictions_equal_the_jax_script(golden, tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "run" / "weights_drop_check.py"),
         "--work-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stdout[-1500:] + out.stderr[-1500:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = golden[2]
    assert {k: v for k, v in got.items() if k != "predictions"} == {
        k: v for k, v in want.items() if k != "predictions"}
    assert Path(got["predictions"]).read_text() == Path(want["predictions"]).read_text()
