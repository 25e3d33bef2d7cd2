"""The launchers of the port (``run_torch/*.sh``, ``run_torch/dynamic_eval/*.sh``)
against the JAX package's (``run/*.sh``, ``run/dynamic_eval/*.sh``), read as
text on the CPU. Nothing is run: the scripts need the LLaVA data sets,
checkpoints and the benchmarks' own scorers under ``./playground``.

Each script is read as a shell would see it for the defaults: continuation
lines joined, comments dropped, ``${VAR:-default}`` taking its default, each
variable's first assignment substituted, a chunk loop's ``IDX`` at 0. Then
every line of a twin must equal its original's, but for the three
differences the port makes: a ``python -m dynamic_llava_tpu.<m>`` command
becomes ``python -m dynamic_llava_tpu_torch.<m>``, training runs under
``torchrun --nproc_per_node 1``, and the generators take ``--device cuda``.
Each port module's own parser then accepts the twin's arguments (parsed
only, never run).
"""

import argparse
import importlib
import re
import shlex
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
NAMES = sorted(str(p.relative_to(ROOT / "run")) for p in (ROOT / "run").rglob("*.sh"))
GENERATORS = {"model_vqa_loader", "model_vqa", "model_vqa_mmbench", "model_vqa_qbench",
              "model_vqa_science"}
TORCHRUN = ["torchrun", "--nproc_per_node", "1"]


def logical_lines(path: Path):
    """The script's command lines for its defaults: joined, expanded,
    comments and blank lines dropped."""
    text = path.read_text().replace("\\\n", " ")
    env = {"IDX": "0"}
    out = []

    def expand(s):
        s = re.sub(r"\$\{(\w+):-([^}]*)\}", lambda m: m.group(2), s)
        return re.sub(r"\$\{(\w+)\}|\$([A-Za-z_]\w*)",
                      lambda m: env.get(m.group(1) or m.group(2), m.group(0)), s)

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        line = re.sub(r"\s+", " ", expand(line))
        m = re.match(r"^([A-Za-z_]\w*)=(.*)$", line)
        if m and m.group(1) not in env:
            env[m.group(1)] = shlex.split(m.group(2))[0] if m.group(2) else ""
        out.append(line)
    return out


def module_command(line: str):
    """``(prefix, module, args)`` of a ``-m dynamic_llava_tpu...`` command,
    else None."""
    if not re.search(r"-m dynamic_llava_tpu", line):
        return None
    tokens = shlex.split(line)
    if tokens[-1] == "&":
        tokens = tokens[:-1]
    i = tokens.index("-m")
    return tokens[:i], tokens[i + 1], tokens[i + 2:]


def without_device(args):
    out, i = [], 0
    while i < len(args):
        if args[i] == "--device":
            i += 2
            continue
        out.append(args[i])
        i += 1
    return out


def test_every_launcher_has_a_twin():
    assert len(NAMES) == 22
    assert sorted(str(p.relative_to(ROOT / "run_torch"))
                  for p in (ROOT / "run_torch").rglob("*.sh")) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_twin_runs_the_original_commands_on_the_port(name):
    got = logical_lines(ROOT / "run_torch" / name)
    want = logical_lines(ROOT / "run" / name)
    assert len(got) == len(want)
    commands = 0
    for g, w in zip(got, want):
        wc = module_command(w)
        if wc is None:
            assert g == w
            continue
        commands += 1
        gc = module_command(g)
        assert gc is not None, g
        (gp, gm, ga), (wp, wm, wa) = gc, wc
        assert wp == ["python"] and wm.startswith("dynamic_llava_tpu.")
        assert gm == "dynamic_llava_tpu_torch." + wm[len("dynamic_llava_tpu."):]
        assert gp == (TORCHRUN if gm.endswith(".train.train_sparse") else ["python"])
        assert without_device(ga) == wa
        leaf = gm.rsplit(".", 1)[1]
        devices = [ga[i + 1] for i, a in enumerate(ga) if a == "--device"]
        assert devices == (["cuda"] if leaf in GENERATORS else [])
    assert commands >= 1


class _Parsed(Exception):
    def __init__(self, ns):
        self.ns = ns


def parsed(module: str, args):
    """``args`` through ``module``'s own parser: ``parse_args`` for the
    training CLI, ``parser()`` where the module has one, else its ``main``
    with ``ArgumentParser.parse_args`` stopped right after it parsed."""
    mod = importlib.import_module(module)
    if hasattr(mod, "parse_args"):
        return mod.parse_args(args)
    if hasattr(mod, "parser"):
        return mod.parser().parse_args(args)
    real = argparse.ArgumentParser.parse_args

    def stop(self, argv=None, namespace=None):
        raise _Parsed(real(self, argv, namespace))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as got:
            mod.main(args)
    return got.value.ns


@pytest.mark.parametrize("name", NAMES)
def test_port_parsers_accept_the_twin_commands(name):
    commands = [c for c in map(module_command, logical_lines(ROOT / "run_torch" / name)) if c]
    assert commands
    for _, module, args in commands:
        ns = parsed(module, args)
        if module.rsplit(".", 1)[1] in GENERATORS:
            assert ns.device == "cuda"
        if module.endswith(".train.train_sparse"):
            assert (ns.data_parallel, ns.fsdp_parallel, ns.tensor_parallel) == (1, -1, 1)
