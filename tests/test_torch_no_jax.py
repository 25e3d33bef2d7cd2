"""The port never loads jax: its sources import none of it, and a fresh
interpreter that imports the package (the quantized path included) and
generates on the CPU, with fp32 and then int4 weights, ends with
``'jax' not in sys.modules``."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "dynamic_llava_tpu_torch"

SCRIPT = r"""
import sys
import numpy as np
import torch
import dynamic_llava_tpu_torch
from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX, LlavaConfig
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
from dynamic_llava_tpu_torch.ops import quant, quant_matmul
from dynamic_llava_tpu_torch.weights import init_llava_params

cfg = LlavaConfig.tiny()
params = init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
ids = [np.array([5, 6, IMAGE_TOKEN_INDEX, 7, 8, 9]), np.array([10, 11, IMAGE_TOKEN_INDEX, 12])]
pix = np.random.default_rng(0).normal(size=(2, 56, 56, 3)).astype(np.float32)
out = Generator(params, cfg, GenerationConfig(max_new_tokens=4)).generate(ids, pix)
assert len(out) == 2 and all(1 <= len(o) <= 4 for o in out), out
quant.quantize_llm_params(params, bits=4)
out = Generator(params, cfg, GenerationConfig(max_new_tokens=4)).generate(ids, pix)
assert len(out) == 2 and all(1 <= len(o) <= 4 for o in out), out
print("jax loaded:", "jax" in sys.modules)
"""


def test_package_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    offenders = [str(p) for p in PACKAGE.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []


def test_generate_in_a_fresh_interpreter_never_loads_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "jax loaded: False"
