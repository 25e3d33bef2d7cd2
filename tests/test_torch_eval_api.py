"""The port's own copies of the scripts that call an external API
(``eval_gpt_review*``, ``eval_science_qa_gpt4*``, ``qa_baseline_gpt35``),
run offline as ``tests/test_eval_surface.py`` runs the JAX package's: a
judge or a client of the test's own in place of ``openai``. Each case runs
on both packages' modules and holds the port's outputs (the files written
and the values returned) equal to the original's."""

import importlib
import json
import random
import subprocess
import sys

import pytest

PACKAGES = ("dynamic_llava_tpu", "dynamic_llava_tpu_torch")


def _mods(name):
    return [importlib.import_module(f"{pkg}.eval.{name}") for pkg in PACKAGES]


def _jsonl(path, rows):
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return str(path)


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("review", ["8 7\nGood answers.", "8,7\nwith comma", "no scores here",
                                    "9\n", "1 2 3\n", ""])
def test_parse_score_matches(review):
    j, t = _mods("eval_gpt_review")
    assert t.parse_score(review) == j.parse_score(review)
    assert t.parse_score("8 7\nGood answers.") == [8.0, 7.0]


@pytest.mark.parametrize("variant,context_row,expected_snippet", [
    ("bench", {"image": "i.jpg", "caption": ["a cat", "on a mat"]}, "a cat\non a mat"),
    ("bench", {"image": "i.jpg", "caption": "one caption"}, "one caption"),
    ("visual", {"image": "i.jpg", "captions": ["a cat"],
                "instances": [{"category": "cat", "bbox": [1, 2, 3, 4]}]},
     "cat: [1, 2, 3, 4]"),
])
def test_run_review_variants_match(tmp_path, variant, context_row, expected_snippet):
    """Both engines write the same review rows from the same inputs and
    judge, and resume from an existing output without judging again."""
    q = _jsonl(tmp_path / "q.jsonl", [
        {"question_id": 0, "image": "i.jpg", "text": "What?", "category": "conv"},
        {"question_id": 1, "image": "i.jpg", "text": "Why?", "category": "conv"}])
    a1 = _jsonl(tmp_path / "a1.jsonl", [{"question_id": 0, "text": "ans one"},
                                        {"question_id": 1, "text": "ans three",
                                         "answer_id": "x1"}])
    a2 = _jsonl(tmp_path / "a2.jsonl", [{"question_id": 0, "text": "ans two"},
                                        {"question_id": 1, "text": "ans four"}])
    ctx = _jsonl(tmp_path / "ctx.jsonl", [context_row])
    rule_cat = "llava_bench_conv" if variant == "bench" else "conv"
    rule = tmp_path / "rule.json"
    rule.write_text(json.dumps({rule_cat: {"role": "Assistant", "prompt": "rate both"}}))
    rows, prompts = [], []
    for mod in _mods("eval_gpt_review"):
        seen = []
        out = tmp_path / f"review_{mod.__name__.split('.')[0]}.jsonl"

        def judge(content):
            seen.append(content)
            return "9 4\nfirst is better" if len(seen) == 1 else "no score"

        mod.run_review(q, ctx, str(rule), [a1, a2], str(out), variant=variant, judge=judge)
        mod.run_review(q, ctx, str(rule), [a1, a2], str(out), variant=variant, judge=judge)
        rows.append(_read(out))
        prompts.append(seen)
    assert rows[1] == rows[0] and prompts[1] == prompts[0]
    assert len(prompts[1]) == 2 and expected_snippet in prompts[1][0]
    assert "[Assistant 1]\nans one" in prompts[1][0]
    assert [r["tuple"] for r in rows[1]] == [[9.0, 4.0], [-1, -1]]
    assert rows[1][1]["answer1_id"] == "x1" and rows[1][0]["category"] == rule_cat


def test_run_review_limit_and_missing_rule_match(tmp_path):
    q = _jsonl(tmp_path / "q.jsonl", [
        {"question_id": i, "image": "i.jpg", "text": "q", "category": c}
        for i, c in enumerate(["conv", "detail"])])
    a = _jsonl(tmp_path / "a.jsonl", [{"question_id": i, "text": "a"} for i in range(2)])
    ctx = _jsonl(tmp_path / "ctx.jsonl", [{"image": "i.jpg", "caption": "c"}])
    rule = tmp_path / "rule.json"
    rule.write_text(json.dumps({"llava_bench_conv": {"role": "AI", "prompt": "p"}}))
    for mod in _mods("eval_gpt_review"):
        out = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        mod.run_review(q, ctx, str(rule), [a, a], str(out), judge=lambda c: "1 2", limit=1)
        assert len(_read(out)) == 1
        with pytest.raises(KeyError, match="llava_bench_detail"):
            mod.run_review(q, ctx, str(rule), [a, a], str(out), judge=lambda c: "1 2")


@pytest.mark.parametrize("name,variant", [("eval_gpt_review_bench", "bench"),
                                          ("eval_gpt_review_visual", "visual")])
def test_entry_points_pass_their_variant(monkeypatch, name, variant):
    """The two entry points call the engine's ``main`` with their variant;
    the engine's parser gives the same arguments in both packages."""
    for pkg in PACKAGES:
        engine = importlib.import_module(f"{pkg}.eval.eval_gpt_review")
        entry = importlib.import_module(f"{pkg}.eval.{name}")
        got = {}
        monkeypatch.setattr(engine, "run_review",
                            lambda *a, **kw: got.update(args=a, variant=kw["variant"]))
        monkeypatch.setattr(engine, "openai_judge", lambda **kw: "judge")
        entry.main(["-q", "q", "-c", "c", "-a", "a1", "a2", "-r", "r", "-o", "o"])
        assert got == {"args": ("q", "c", "r", ["a1", "a2"], "o"), "variant": variant}


def test_openai_is_imported_only_when_asked():
    """Importing the copies never imports ``openai``; calling the default
    judge or answerer does (and fails where it is not installed)."""
    code = ("import sys\n"
            "from dynamic_llava_tpu_torch.eval import eval_gpt_review, qa_baseline_gpt35, "
            "eval_gpt_review_bench, eval_gpt_review_visual, eval_science_qa_gpt4, "
            "eval_science_qa_gpt4_requery\n"
            "assert 'openai' not in sys.modules\n"
            "for f in (eval_gpt_review.openai_judge, qa_baseline_gpt35.openai_answerer):\n"
            "    try:\n"
            "        f()\n"
            "    except ImportError:\n"
            "        pass\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "ok"


def _sqa_fixture(tmp_path, our_texts, gpt4_texts, requery_texts=None):
    base = tmp_path / "sqa"
    base.mkdir(exist_ok=True)
    pids = [str(i) for i in range(len(our_texts))]
    problems = {pid: {"choices": ["x", "y", "z"], "answer": i % 2}
                for i, pid in enumerate(pids)}
    (base / "problems.json").write_text(json.dumps(problems))
    (base / "pid_splits.json").write_text(json.dumps({"test": pids}))
    our = _jsonl(tmp_path / "our.jsonl",
                 [{"question_id": pid, "text": t} for pid, t in zip(pids, our_texts)])
    gpt4 = tmp_path / "gpt4.json"
    gpt4.write_text(json.dumps({"outputs": dict(zip(pids, gpt4_texts))}))
    req = None
    if requery_texts is not None:
        req = _jsonl(tmp_path / "req.jsonl",
                     [{"question_id": pid, "text": t} for pid, t in zip(pids, requery_texts)])
    return str(base), our, str(gpt4), req


OURS = ["The answer is A.", "The answer is B.", "The answer is A.", "B", "The answer is C."]
GPT4 = ["The answer is A.", "The answer is A.", "dunno", "The answer is B.", "The answer is Z."]
REQUERY = ["The answer is A.", "The answer is C.", "eh", "The answer is B.", ""]


def test_sqa_gpt4_scorer_matches(tmp_path):
    base, our, gpt4, _ = _sqa_fixture(tmp_path, OURS, GPT4)
    j, t = _mods("eval_science_qa_gpt4")
    # an unparseable answer scores as a random choice: the same draws for both
    random.seed(0)
    got = t.evaluate(base, our, gpt4)
    random.seed(0)
    assert got == j.evaluate(base, our, gpt4)
    assert got["total"] == 5 and got["gpt4_failed"] >= 1


def test_sqa_gpt4_requery_scorer_matches(tmp_path):
    base, our, gpt4, req = _sqa_fixture(tmp_path, OURS, GPT4, REQUERY)
    j, t = _mods("eval_science_qa_gpt4_requery")
    random.seed(0)
    got = t.evaluate(base, our, gpt4, req, str(tmp_path / "port.json"))
    random.seed(0)
    want = j.evaluate(base, our, gpt4, req, str(tmp_path / "jax.json"))
    assert got == want and got["count"] == 5
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))


def test_sqa_gpt4_mains_match(tmp_path, capsys):
    base, our, gpt4, req = _sqa_fixture(tmp_path, OURS, GPT4, REQUERY)
    printed = []
    for pkg in PACKAGES:
        mod = importlib.import_module(f"{pkg}.eval.eval_science_qa_gpt4")
        random.seed(0)
        mod.main(["--base-dir", base, "--our-result", our, "--gpt4-result", gpt4])
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0] and printed[0]


def test_qa_baseline_offline_client_matches(tmp_path):
    q = _jsonl(tmp_path / "q.jsonl", [{"question_id": 2, "text": "second"},
                                      {"question_id": 1, "text": "first"},
                                      {"question_id": 3, "text": "third"}])
    rows = []
    for mod in _mods("qa_baseline_gpt35"):
        out = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        mod.generate_answers(q, str(out), client=lambda text: f"echo:{text}")
        rows.append(_read(out))
    strip = [[{k: v for k, v in r.items() if k != "answer_id"} for r in rs] for rs in rows]
    assert strip[1] == strip[0]
    assert [r["question_id"] for r in rows[1]] == [1, 2, 3]
    assert rows[1][0]["text"] == "echo:first" and rows[1][0]["model_id"].startswith("gpt-3.5")
