"""The port's launch counter (``dynamic_llava_tpu_torch/kernels/counts.py``)
on the CPU, where no kernel launches: ``chip_smoke.py`` counts the kernels'
launches on the card with it instead of ``torch.profiler`` traces, and holds
it equal to one trace there.

(a) ``launched`` counts one launch a call inside ``counting()``, and nothing
outside it; ``replayed`` adds nothing outside it either; counting blocks do
not nest.
(b) Every kernel wrapper of ``ops/`` counts its launch, under its C entry
point's name, in the statement right after it checks the entry's return
code, and the counted entries are the twelve of ``chip_smoke.py``'s
``kernels`` line.
(c) Each runner kind counts the launches its capture records apart from the
launches on the card, and those once a replay: the capture is faked here (a
fake ``CUDAGraph`` whose replay does nothing, the step a stand-in that
reports launches), so a chunk of C steps counts C steps' launches, the
first eager. A graph captured before counting began is counted in its
replays; the continuous engine's runner keeps each form's launches apart.
"""

import ast
import contextlib
from collections import Counter

import pytest
import torch

from dynamic_llava_tpu_torch import kernel_cases as kc
from dynamic_llava_tpu_torch import kernels
from dynamic_llava_tpu_torch.config import LlavaConfig
from dynamic_llava_tpu_torch.generation import generate as tgen
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, RunnerKey
from dynamic_llava_tpu_torch.kernels import counts

OPS = kernels.PACKAGE_DIR / "ops"
# the kernels line's names: every C entry point that launches a kernel
ENTRIES = {"flash_attention_fwd", "flash_attention_bwd_delta", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_policy_attention_fwd",
           "decode_attention_appended", "extend_attention_appended", "q8_gemv",
           "q8_gemv_group", "q4_gemv", "q4_gemv_group", "q4_mlp"}
K2 = "decode_attention_appended"
CHUNK, LAYERS = 4, 3


def test_a_launch_counts_once_and_nothing_when_off():
    with counts.counting() as got:
        counts.launched("q8_gemv")
        counts.launched("q8_gemv")
        counts.launched(K2)
    assert got == {"q8_gemv": 2, K2: 1} and not counts.CAPTURED
    counts.launched(K2)
    counts.replayed(Counter({K2: 5}))
    assert counts.COUNTS == {"q8_gemv": 2, K2: 1}
    with counts.counting() as got:
        with pytest.raises(RuntimeError, match="already counting"):
            with counts.counting():
                pass
        counts.replayed(Counter({K2: 5}))
        counts.replayed(Counter({K2: 5}))
    assert got == {K2: 10}


def _calls(node, owner, attr):
    return [c for c in ast.walk(node) if isinstance(c, ast.Call)
            and isinstance(c.func, ast.Attribute) and c.func.attr == attr
            and isinstance(c.func.value, ast.Name) and c.func.value.id == owner]


def _launch_names(tree):
    """The names ``_launch`` is called with (the GEMVs count ``what``)."""
    return {c.args[0].value for c in ast.walk(tree) if isinstance(c, ast.Call)
            and isinstance(c.func, ast.Name) and c.func.id == "_launch"}


def test_every_wrapper_counts_its_launch():
    counted = set()
    for path in sorted(OPS.glob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            checks, launched = _calls(fn, "kernels", "check"), _calls(fn, "counts", "launched")
            assert len(checks) == len(launched) <= 1, (path.name, fn.name)
            if not checks:
                continue
            body = [s for s in ast.walk(fn) if isinstance(s, ast.Expr)]
            i = next(j for j, s in enumerate(body) if s.value is checks[0])
            assert body[i + 1].value is launched[0], (path.name, fn.name)
            what, name = checks[0].args[1], launched[0].args[0]
            if isinstance(name, ast.Constant):  # the check names the entry first
                lead = what.values[0] if isinstance(what, ast.JoinedStr) else what
                assert lead.value.split(" ")[0] == name.value, (path.name, fn.name)
                counted.add(name.value)
            else:  # the GEMVs' ``_launch(what, ...)``: the f-string leads with ``what``
                lead = what.values[0].value
                assert isinstance(lead, ast.Name) and lead.id == name.id == "what"
                counted |= _launch_names(tree)
    assert counted == ENTRIES
    assert {e for entries in kc.COUNTED.values() for e in entries} <= ENTRIES
    assert set(kc.COUNTED) == set(kc.SERVING_KERNELS)


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def register_generator_state(self, generator):
        pass


class FakeEvent:
    def record(self):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA graphs faked on the CPU: a capture runs the step once, a replay
    runs nothing."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)


def _runner(monkeypatch, cls, **key):
    """A runner of a tiny config whose step reports ``LAYERS`` K2 launches
    (and, in the sampling form of the continuous engine's runner, one K5)."""
    gc = GenerationConfig(max_new_tokens=8, decode_chunk=CHUNK, eos_token_id=-1)
    runner = cls({}, LlavaConfig.tiny(), gc,
                 RunnerKey(2, 24, 16, False, chunk=CHUNK, **key), "cpu")
    runner.graphed = True

    def step():
        for _ in range(LAYERS):
            counts.launched(K2)
        if getattr(runner, "sampled", False):
            counts.launched("q8_gemv")

    monkeypatch.setattr(runner, "step", step)
    return runner


@pytest.mark.parametrize("cls, key", [
    (tgen.DecodeRunner, {}),
    (tgen.StopDecodeRunner, dict(stop=((2,),))),
    (tgen.SpecRunner, dict(m=3, ctx_cap=64)),
    (tgen.SlotSpecRunner, dict(m=3, ctx_cap=64, draft=(2, 1))),
], ids=lambda v: v.__name__ if isinstance(v, type) else None)
def test_captured_launches_count_once_a_replay(monkeypatch, fake_card, cls, key):
    runner = _runner(monkeypatch, cls, **key)
    with counts.counting() as got:
        runner.run_chunk()
    # the first step eager, its capture recorded apart, then CHUNK - 1 replays
    assert got == {K2: CHUNK * LAYERS} and counts.CAPTURED == {K2: LAYERS}
    assert runner.graph_launches == {K2: LAYERS} and runner.eager_steps == 1
    assert runner.replays == runner.graph.replays == CHUNK - 1
    with counts.counting() as got:  # the graph captured before this count
        runner.run_chunk()
        runner.run_chunk()
    assert got == {K2: 2 * CHUNK * LAYERS} and not counts.CAPTURED
    runner.run_chunk()  # counting off
    assert got == {K2: 2 * CHUNK * LAYERS} and runner.replays == 4 * CHUNK - 1


def test_each_form_of_the_slot_runner_counts_its_own_launches(monkeypatch, fake_card):
    runner = _runner(monkeypatch, tgen.SlotDecodeRunner, stop=((2,),))
    with counts.counting() as got:
        for sampled in (False, True, False, True):
            runner.run_chunk(sampled)
    assert got == {K2: 4 * CHUNK * LAYERS, "q8_gemv": 2 * CHUNK}
    assert counts.CAPTURED == {K2: 2 * LAYERS, "q8_gemv": 1}
    assert runner.forms_launches == {False: {K2: LAYERS}, True: {K2: LAYERS, "q8_gemv": 1}}
    assert runner.eager_steps == 2 and runner.replays == 4 * CHUNK - 2
