"""The port never loads jax nor the JAX package: its sources (the package,
``chip_smoke.py``, ``tools/*.py``) import neither, and a fresh
interpreter that imports the package (the quantized and the training paths,
the LoRA module, the quality harnesses, the checkpoint loader and the
entry points included), exports and loads a checkpoint, generates on the CPU
with fp32 (also speculatively, through the continuous-batching engine and
with LoRA adapters attached) and then
int4 weights (also with
the fused MLP, an int8 and an fp8 KV cache and the ring policy), and takes
a train step, ends with neither ``jax`` nor ``dynamic_llava_tpu`` in
``sys.modules``."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "dynamic_llava_tpu_torch"

SCRIPT = r"""
import os
import sys
import tempfile
import numpy as np
import torch
import dynamic_llava_tpu_torch
from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX, LlavaConfig
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
from dynamic_llava_tpu_torch.ops import flash_policy, gumbel, quant, quant_matmul
from dynamic_llava_tpu_torch.train.trainer import Trainer, TrainerConfig
from dynamic_llava_tpu_torch.weights import init_llava_params

cfg = LlavaConfig.tiny()
params = init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
ids = [np.array([5, 6, IMAGE_TOKEN_INDEX, 7, 8, 9]), np.array([10, 11, IMAGE_TOKEN_INDEX, 12])]
pix = np.random.default_rng(0).normal(size=(2, 56, 56, 3)).astype(np.float32)
gen = Generator(params, cfg, GenerationConfig(max_new_tokens=4))
out = gen.generate(ids, pix)
assert len(out) == 2 and all(1 <= len(o) <= 4 for o in out), out
assert gen.generate_speculative(ids, pix, draft_k=2) == out
assert gen.generate_speculative_device(ids, pix, draft_k=2) == out
from dynamic_llava_tpu_torch.generation.continuous import ContinuousEngine

engine = ContinuousEngine(params, cfg, GenerationConfig(max_new_tokens=4), slots=2,
                          prompt_bucket=64, max_new_cap=4, device="cpu")
rids = [engine.submit(i, p, max_new_tokens=4) for i, p in zip(ids, pix)]
engine.run_until_drained()
solo = [gen.generate([i], p[None], pad_to=64)[0] for i, p in zip(ids, pix)]
assert [engine.requests[r].output for r in rids] == solo, solo
from dynamic_llava_tpu_torch.generation import beam

rows = [np.concatenate([[3, IMAGE_TOKEN_INDEX], np.arange(4, 70)]) for _ in range(2)]
labels = [np.where(np.arange(len(r)) < 8, -100, r) for r in rows]
plan = plan_batch(rows, cfg.num_image_tokens, labels_list=labels)
with tempfile.TemporaryDirectory() as d:
    tc = TrainerConfig(output_dir=d, num_train_steps=4, logging_steps=1, save_steps=0,
                       warmup_ratio=0.25)
    trainer = Trainer(cfg, params, tc, device="cpu")
    metrics = trainer.train([(plan, pix), (plan, pix)])
    trainer.logger.close()
assert trainer.step == 2 and np.isfinite(metrics["loss"]), metrics
assert "image_mask_loss" in metrics and "output_text_mask_loss" in metrics, metrics
from dynamic_llava_tpu_torch.eval import eval_pope, model_vqa_loader, run_dynamic_llava
from dynamic_llava_tpu_torch.models import builder, export, tokenizer_init, weight_tools
from dynamic_llava_tpu_torch.serve import cli

with tempfile.TemporaryDirectory() as d:
    export.export_hf_checkpoint(params, cfg, d)
    _, runtime, _, _ = builder.load_pretrained_model(d, dtype=torch.float32, device="cpu")
assert runtime.cfg == cfg
assert Generator(runtime.params, cfg, GenerationConfig(max_new_tokens=4)).generate(ids, pix) \
    == gen.generate(ids, pix)
from dynamic_llava_tpu_torch.run import quant_quality, sparse_quality, text_sparse_quality
from dynamic_llava_tpu_torch.train import lora

adapted = lora.attach_lora(params, lora.init_lora_params(
    cfg.text, torch.Generator().manual_seed(1), rank=2, device="cpu"))
out = Generator(adapted, cfg, GenerationConfig(max_new_tokens=4)).generate(ids, pix)
assert len(out) == 2 and all(1 <= len(o) <= 4 for o in out), out

quant.quantize_llm_params(params, bits=4)
out = Generator(params, cfg, GenerationConfig(max_new_tokens=4)).generate(ids, pix)
assert len(out) == 2 and all(1 <= len(o) <= 4 for o in out), out

os.environ["DYNAMIC_LLAVA_Q4_MLP"] = "1"  # the fused int4 MLP, an int8 cache, the ring
lean = GenerationConfig(max_new_tokens=12, cache_dtype="int8", kv_overflow="ring", kv_window=2)
out = Generator(params, cfg, lean).generate(ids, pix)
assert len(out) == 2 and all(1 <= len(o) <= 12 for o in out), out
fp8 = GenerationConfig(max_new_tokens=4, cache_dtype="float8_e4m3fn")
out = Generator(params, cfg, fp8).generate(ids, pix)
assert len(out) == 2 and all(1 <= len(o) <= 4 for o in out), out
print("jax loaded:", "jax" in sys.modules)
print("jax package loaded:", "dynamic_llava_tpu" in sys.modules)
"""

SOURCES = (sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py")))
# `import jax`, `from jax...`, `import dynamic_llava_tpu[.x]`, `from dynamic_llava_tpu[.x] ...`:
# the word boundary keeps `dynamic_llava_tpu_torch` out
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|dynamic_llava_tpu)(?![\w])", re.MULTILINE)


def test_forbidden_pattern_sees_what_it_should():
    for line in ("import jax", "from jax import numpy", "  import jax.numpy as jnp",
                 "from dynamic_llava_tpu.config import LlavaConfig",
                 "import dynamic_llava_tpu", "from dynamic_llava_tpu import constants"):
        assert FORBIDDEN.search(line), line
    for line in ("import dynamic_llava_tpu_torch", "from dynamic_llava_tpu_torch.config import X",
                 "import jaxtyping", "# import jax"):
        assert not FORBIDDEN.search(line), line


def test_package_sources_import_no_jax():
    assert len(SOURCES) > 20 and all(p.is_file() for p in SOURCES)
    assert {"profile_decode.py", "profile_mlp.py", "profile_train.py"} <= {
        p.name for p in SOURCES}
    offenders = [str(p.relative_to(ROOT)) for p in SOURCES if FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_generate_in_a_fresh_interpreter_never_loads_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-2:] == [
        "jax loaded: False", "jax package loaded: False"]
