"""What the measurement harnesses of ``tools/`` share (``long_gen_bench``,
``spec_bench``, ``spec_batch_bench``, ``serve_bench``, ``ladder_probe``):
the flags every one of them takes, the device a run asks for, the card's
name and power limit, the model of a run, and the child process in which a
measured side runs on a fresh allocator."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # the package, when a tool runs as a script
    sys.path.insert(0, str(ROOT))


def add_run_flags(p) -> None:
    """``--cpu`` (the plain versions on the CPU; default: the card) and
    ``--layers`` (the first N decoder layers; default: all)."""
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions); default: the card")
    p.add_argument("--layers", type=int, default=None,
                   help="decoder layers (default: the model's own)")


def run_flags(args) -> list:
    """``add_run_flags``' flags of ``args`` as a child's arguments."""
    return (["--cpu"] if args.cpu else []) + (
        ["--layers", str(args.layers)] if args.layers else [])


def device(args):
    """The run's device: the CPU with ``--cpu``, else the card
    (``weights.resolve_device``: raises where there is none)."""
    from dynamic_llava_tpu_torch.weights import resolve_device

    return resolve_device("cpu" if args.cpu else None)


def print_card(args) -> str:
    """Unless ``--cpu``: raises where there is no card (``device``), else
    prints and returns its name and power limit as ``nvidia-smi`` gives
    them. ``""`` on the CPU."""
    if args.cpu:
        return ""
    device(args)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def model_config(args, dense: bool = False):
    """``bench_cfg(args.model)`` cut to ``args.layers`` decoder layers, and
    with every predictor off for ``dense``."""
    from dynamic_llava_tpu_torch.eval.bench import bench_cfg, dense_config

    cfg = bench_cfg(args.model)
    if args.layers:
        cfg = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=args.layers))
    return dense_config(cfg) if dense else cfg


def run_child(argv, tag: str, timeout: float) -> dict:
    """This interpreter on ``argv`` (a tool and its child flags): the JSON
    of the last stdout line that starts with ``tag``, else ``{"error":
    ...}`` with the tail of its output. A child past ``timeout`` seconds is
    killed."""
    try:
        r = subprocess.run([sys.executable, *map(str, argv)], capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": f"timed out after {timeout:.0f}s"}
    rec = None
    for line in r.stdout.splitlines():
        if line.startswith(tag + " "):
            rec = json.loads(line[len(tag) + 1:])
    if rec is None:
        return {"error": (r.stdout[-800:] + r.stderr[-800:])[-1500:]}
    return rec
