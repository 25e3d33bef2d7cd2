"""The port's training CLI (``dynamic_llava_tpu_torch/train/train_sparse.py``)
on ``helpers.make_tiny_checkpoint`` with a LLaVA-format JSON set (v1
conversations, four images of mixed aspect ratios as PNG, two text-only
records) and ``--device cpu``.

Against the JAX CLI, on the same checkpoint, data and flags, predictors off
(``--use_vision_predictor false --use_output_text_predictor false``, so no
Gumbel noise is drawn): ``parse_args`` gives the same flags and values,
``build_config`` the same config field by field, the trainers the same
config, and the first batch is equal (the plan field by field, the images
bit for bit), and so is the ``TrainerConfig`` the CLI builds. Steps 1
and 2's logged losses (before and after one update; both train in bf16:
the JAX ``--bf16`` cannot be turned off) agree within ``LOSS_RTOL``
relative. The JAX CLI runs once, in a module fixture.

The port alone: sparse steps are finite and leave a checkpoint; a second
run resumes; ``--lora_enable``, ``--lora_enable --bits 4`` and
``--tune_mm_mlp_adapter`` change only the leaves they should;
``--pretrain_mm_mlp_adapter`` loads the projector; the mesh flags reach
``TrainerConfig`` as in the JAX CLI, and a mesh whose product is not the
world size raises."""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax  # noqa: F401  (the JAX package below runs on the CPU, conftest)

from dynamic_llava_tpu.train import train_sparse as jcli
from dynamic_llava_tpu.train import trainer as jtrainer
from dynamic_llava_tpu_torch.models.builder import load_pretrained_model
from dynamic_llava_tpu_torch.ops.quant import quantize_llm_params
from dynamic_llava_tpu_torch.train import train_sparse as tcli
from dynamic_llava_tpu_torch.train import trainer as ttrainer
from dynamic_llava_tpu_torch.weights import named_leaves

from helpers import make_tiny_checkpoint
from test_torch_config import port_config
from test_torch_train_data import assert_plans_equal

# steps 1 and 2's losses, bf16 on both sides in another order of
# operations; the measured relative gaps on this set are 3.2e-5 (step 1)
# and 5.2e-5 (step 2)
LOSS_RTOL = 1e-3
DENSE = ["--use_vision_predictor", "false", "--use_output_text_predictor", "false"]


def write_set(root):
    """Four PNGs of mixed aspect ratios and six v1 records, four with an
    image. Returns ``(data_path, image_folder)``."""
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(40, 64), (72, 30), (50, 50), (28, 90)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            str(images / f"{i}.png"))
    turns = [("What is in the image ?", "The picture shows a red cat ."),
             ("Is there a dog ?", "no"), ("describe briefly", "hello world")]
    records = []
    for i in range(6):
        conv = []
        for j, (q, a) in enumerate(turns[: 1 + i % 3]):
            if j == 0 and i < 4:
                q = "<image>\n" + q
            conv += [{"from": "human", "value": q}, {"from": "gpt", "value": a}]
        rec = {"id": f"r{i}", "conversations": conv}
        if i < 4:
            rec["image"] = f"{i}.png"
        records.append(rec)
    data = root / "data.json"
    data.write_text(json.dumps(records))
    return str(data), str(images)


def record_first_batch(monkeypatch, trainer_cls, into: list):
    """Wrap ``trainer_cls.train`` so that the batches it takes are
    appended to ``into``."""
    train = trainer_cls.train

    def recording(self, batches):
        def seen():
            for batch in batches:
                into.append(batch)
                yield batch
        return train(self, seen())

    monkeypatch.setattr(trainer_cls, "train", recording)


def read_metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    ckpt = make_tiny_checkpoint(str(root / "ckpt"))
    data, images = write_set(root)
    base = ["--model_path", ckpt, "--data_path", data, "--image_folder", images,
            "--per_device_train_batch_size", "2", "--max_steps", "2", "--logging_steps", "1",
            "--learning_rate", "1e-3", "--seed", "3"]
    out = str(root / "jax")
    batches = []
    with pytest.MonkeyPatch.context() as mp:
        record_first_batch(mp, jtrainer.Trainer, batches)
        trainer = jcli.train(base + DENSE + ["--output_dir", out])
    return {"root": root, "ckpt": ckpt, "base": base, "jax_cfg": trainer.cfg,
            "jax_tc": trainer.tc, "jax_batch": batches[0], "jax_metrics": read_metrics(out)}


def run(setup, name, *flags, monkeypatch=None, batches=None):
    """The port's CLI on ``setup``'s set into ``<root>/<name>``: ``(trainer,
    standard output)``."""
    out = io.StringIO()
    argv = setup["base"] + list(flags) + ["--output_dir", str(setup["root"] / name),
                                          "--device", "cpu"]
    if batches is not None:
        record_first_batch(monkeypatch, ttrainer.Trainer, batches)
    with contextlib.redirect_stdout(out):
        trainer = tcli.train(argv)
    return trainer, out.getvalue()


ARGVS = [
    [],
    ["--model_size", "13b", "--vision_keep_rate", "0.3", "--sparse_layer", "3",
     "--use_instruct_predictor", "true", "--image_aspect_ratio", "square"],
    ["--model_size", "tiny", "--predictor_d_model", "64", "--predictor_nhead", "2",
     "--output_text_keep_rate", "0.25", "--mask_loss_weight", "10", "--model_max_length", "512",
     "--use_vision_predictor", "False", "--lora_enable", "--bits", "4", "--lora_r", "8"],
]


@pytest.mark.parametrize("extra", ARGVS, ids=["defaults", "13b", "tiny"])
def test_flags_and_build_config_match_jax(extra):
    argv = ["--data_path", "d.json"] + extra
    got, want = tcli.parse_args(argv), jcli.parse_args(argv)
    assert {k: v for k, v in vars(got).items() if k != "device"} == vars(want)
    assert got.device is None
    assert tcli.build_config(got) == port_config(jcli.build_config(want))


def test_dense_cli_matches_jax(setup, monkeypatch):
    batches = []
    trainer, _ = run(setup, "port_dense", *DENSE, monkeypatch=monkeypatch, batches=batches)
    assert trainer.cfg == port_config(setup["jax_cfg"])
    # the TrainerConfig the CLI builds: every field, the output directory
    # apart; the mesh fields at their defaults
    jtc = setup["jax_tc"]
    for f in dataclasses.fields(trainer.tc):
        if f.name != "output_dir":
            assert getattr(trainer.tc, f.name) == getattr(jtc, f.name), f.name
    assert (jtc.data_parallel, jtc.tensor_parallel, jtc.pipeline_parallel,
            jtc.pipeline_microbatches) == (1, 1, 1, 0)
    (plan, images), (jplan, jimages) = batches[0], setup["jax_batch"]
    assert_plans_equal(plan, jplan)
    assert images.dtype == jimages.dtype and np.array_equal(images, jimages)
    assert plan.spans.has_image.any()
    got, want = read_metrics(trainer.tc.output_dir), setup["jax_metrics"]
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    # step 1 before any update; step 2 after one AdamW update under the
    # schedule's warmup, on both sides
    for g, w in zip(got, want):
        gap = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        print(f"step-{w['step']} loss: port {g['loss']}, JAX {w['loss']}, relative gap {gap:.3e}")
        assert gap <= LOSS_RTOL, w["step"]
    assert all(np.isfinite(m["loss"]) for m in got)


def test_sparse_steps_are_finite_and_a_second_run_resumes(setup):
    flags = ["--output_text_len_for_training", "2"]
    trainer, out = run(setup, "port_sparse", *flags)
    metrics = read_metrics(trainer.tc.output_dir)
    assert [m["step"] for m in metrics] == [1, 2]
    for m in metrics:
        assert all(np.isfinite(m[k]) for k in ("loss", "lm_loss", "output_text_mask_loss"))
    assert "image_mask_loss" in metrics[0]
    assert os.path.isfile(os.path.join(trainer.tc.output_dir, "ckpt", "step_2.pt"))
    assert "resumed" not in out
    again, out = run(setup, "port_sparse", *flags)
    assert "resumed from step 2" in out and again.step == 2
    for (name, a), (_, b) in zip(named_leaves(again.params), named_leaves(trainer.params)):
        assert torch.equal(a, b), name


def leaves(tree):
    return {name: t.clone() for name, t in named_leaves(tree)}


def changed(before, after):
    assert sorted(before) == sorted(after)
    return {name for name in before if not torch.equal(before[name], after[name])}


@pytest.mark.parametrize("flags", [["--lora_enable", "--lora_r", "4"],
                                   ["--lora_enable", "--lora_r", "4", "--bits", "4"],
                                   ["--tune_mm_mlp_adapter", "true"]],
                         ids=["lora", "qlora_int4", "tune_mm_mlp_adapter"])
def test_adapted_training_changes_only_its_leaves(setup, flags):
    _, runtime, _, _ = load_pretrained_model(setup["ckpt"], device="cpu")
    base = dict(runtime.params)
    if "--bits" in flags:
        base = quantize_llm_params(base, bits=4)
    before = leaves(base)
    trainer, _ = run(setup, "port_" + "_".join(f.strip("-") for f in flags), *DENSE, *flags)
    after = leaves(trainer.params)
    if "--tune_mm_mlp_adapter" in flags:
        moved = changed(before, after)
        assert moved and all(n.startswith("mm_projector/") for n in moved), moved
        return
    adapters = {n for n in after if "_lora/" in n}
    assert len(adapters) == 7 * 3  # a, b, s for each of q, k, v, o, gate, up, down
    moved = changed(before, {n: t for n, t in after.items() if n not in adapters})
    # in lora_mode the base decoder and the tower are frozen; the projector
    # trains (the predictors too, which are off here)
    assert all(n.startswith("mm_projector/") for n in moved), moved
    for target in ("q", "k", "v", "o", "gate", "up", "down"):
        assert after[f"llm/layers/{target}_lora/b"].abs().sum() > 0, target
        assert float(after[f"llm/layers/{target}_lora/s"]) == 256.0 / 4  # alpha / rank


def test_pretrain_mm_mlp_adapter_loads_the_projector(setup, tmp_path):
    """A stage-1 projector file replaces the checkpoint's projector (lr 0:
    the step leaves it as loaded)."""
    gen = torch.Generator().manual_seed(5)
    sd = {f"model.mm_projector.{i}.{k}": torch.randn(shape, generator=gen)
          for i, (w, b) in ((0, ((64, 24), (64,))), (2, ((64, 64), (64,))))
          for k, shape in (("weight", w), ("bias", b))}
    path = tmp_path / "mm_projector.bin"
    torch.save(sd, path)
    trainer, _ = run(setup, "port_adapter", *DENSE, "--pretrain_mm_mlp_adapter", str(path),
                     "--learning_rate", "0", "--predictor_lr", "0")
    proj = trainer.params["mm_projector"]
    for i, layer in enumerate(proj):
        w, b = sd[f"model.mm_projector.{2 * i}.weight"], sd[f"model.mm_projector.{2 * i}.bias"]
        assert torch.equal(layer["w"], w.t().to(torch.bfloat16)), i
        assert torch.equal(layer["b"], b.to(torch.bfloat16)), i


class _Captured(Exception):
    """Raised by a stand-in ``Trainer`` once it has the CLI's config."""


def capture_trainer_config(monkeypatch, trainer_module, cli, argv):
    """The ``TrainerConfig`` the CLI's ``train(argv)`` builds, taken from a
    stand-in for ``trainer_module.Trainer`` before anything trains."""
    seen = []

    def stand_in(cfg, params, tc, *args, **kwargs):
        seen.append(tc)
        raise _Captured

    monkeypatch.setattr(trainer_module, "Trainer", stand_in)
    with pytest.raises(_Captured):
        cli.train(argv)
    return seen[0]


@pytest.mark.parametrize("flag", ["--data_parallel", "--fsdp_parallel", "--tensor_parallel",
                                  "--pipeline_parallel", "--pipeline_microbatches"])
def test_a_mesh_flag_above_one_raises_naming_a14(setup, flag, monkeypatch):
    """A mesh flag reaches ``TrainerConfig`` field for field as in the JAX
    CLI, and a mesh whose product is not the world size raises before
    anything is loaded. (The name is kept from the single-device CLI, which
    refused every mesh flag until the parallel layer, ROADMAP A14, was
    ported.) ``--fsdp_parallel -1`` takes the ranks the other axes leave, so
    ``--pipeline_microbatches 2`` alone fits any world."""
    out = str(setup["root"] / "mesh")
    argv = setup["base"] + [flag, "2", "--output_dir", out]
    with monkeypatch.context() as mp:
        jtc = capture_trainer_config(mp, jtrainer, jcli, argv)
    args = tcli.parse_args(argv + ["--device", "cpu"])
    tc = tcli.trainer_config(args, jtc.num_train_steps)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jtc)
    assert getattr(tc, flag.lstrip("-")) == 2
    if flag == "--pipeline_microbatches":
        for world in (1, 3):
            tcli.check_mesh(args, world)
    else:
        tcli.check_mesh(args, 2)
        with pytest.raises(SystemExit, match="does not cover the 5 ranks"):
            tcli.check_mesh(args, 5)
        with pytest.raises(SystemExit, match="does not cover the 1 ranks"):
            tcli.train(argv + ["--device", "cpu"])
    assert not (setup["root"] / "mesh").exists()
