"""The port's training data pipeline (``dynamic_llava_tpu_torch/train/data.py``)
and native image ops against the JAX package's: every case of
``tests/test_data_pipeline.py`` run against the port, with the outputs held
equal to the JAX functions' on the same records. The preprocess dialects
(v1, mpt, llama_2, plain, the multimodal tag move) give equal ids and
labels; ``LazySupervisedDataset`` items give equal ids and labels and
bit-equal images (native path and PIL path); the ``Collator``'s
``FusionPlan`` is equal field by field; ``GroupedLengthSampler`` and
``data_loader`` give the same order for a seed. The port's native library
(built into ``_build/``) computes the JAX library's bits and stays within
``tests/test_native_image_ops.py``'s tolerance of PIL; processes that build
it at once all load a whole library."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import jax  # noqa: F401  (the JAX package below runs on the CPU, conftest)

from dynamic_llava_tpu import conversation as jconv
from dynamic_llava_tpu import native as jnative
from dynamic_llava_tpu.mm_utils import ClipImagePreprocessor as JProcessor
from dynamic_llava_tpu.train import data as jdata
from dynamic_llava_tpu_torch import conversation as tconv
from dynamic_llava_tpu_torch import native as tnative
from dynamic_llava_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from dynamic_llava_tpu_torch.mm_utils import (
    OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, ClipImagePreprocessor, expand2square)
from dynamic_llava_tpu_torch.train import data as tdata

from helpers import WordTokenizer, tiny_mix_dataset
from test_data_pipeline import MptWordTokenizer, _sources

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _v1_template():
    """Both packages' default template is v1 for each test, as in
    ``tests/test_data_pipeline.py``."""
    old = jconv.default_conversation, tconv.default_conversation
    jconv.default_conversation = jconv.conv_templates["v1"]
    tconv.default_conversation = tconv.conv_templates["v1"]
    yield
    jconv.default_conversation, tconv.default_conversation = old


def _template(name):
    jconv.default_conversation = jconv.conv_templates[name]
    tconv.default_conversation = tconv.conv_templates[name]


def assert_out_equal(got, want):
    """Equal ``{"input_ids", "labels"}`` lists of a preprocess function."""
    assert sorted(got) == sorted(want)
    for key in want:
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            assert g.dtype == w.dtype and np.array_equal(g, w), key


def assert_plans_equal(got, want):
    for field in want._fields:
        if field == "spans":
            for sf in want.spans._fields:
                np.testing.assert_array_equal(getattr(got.spans, sf), getattr(want.spans, sf),
                                              err_msg=sf)
        else:
            g, w = getattr(got, field), getattr(want, field)
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)


def both(name, *args, tokenizer=WordTokenizer, **kw):
    """``name`` of the port and of the JAX package on the same sources, each
    with a fresh tokenizer: ``(port's output, JAX's output, port's
    tokenizer)``."""
    ttok, jtok = tokenizer(), tokenizer()
    got = getattr(tdata, name)(_sources() if not args else args[0], ttok, **kw)
    want = getattr(jdata, name)(_sources() if not args else args[0], jtok, **kw)
    return got, want, ttok


def test_preprocess_v1_masks_instructions_supervises_answers():
    out, want, tok = both("preprocess_v1", has_image=True)
    assert_out_equal(out, want)
    ids, labels = out["input_ids"][0], out["labels"][0]
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    assert (labels != IGNORE_INDEX).any()
    text = tok.decode(labels[labels != IGNORE_INDEX])
    assert "cat" in text and "red" in text
    assert "curious" not in text
    assert "color" not in text.replace("red", "")
    assert "</s>" in text


def test_preprocess_v1_text_only_matches_jax():
    src = [[{"from": "human", "value": "Say hello ."},
            {"from": "gpt", "value": "hello there friend ."}]]
    out, want, _ = both("preprocess_v1", src, has_image=False)
    assert_out_equal(out, want)
    assert (out["input_ids"][0] != IMAGE_TOKEN_INDEX).all()


@pytest.mark.parametrize("start_end", [False, True])
@pytest.mark.parametrize("template", ["v1", "v1_mmtag"])
def test_preprocess_multimodal_moves_image_tag(template, start_end):
    _template(template)
    src = [[{"from": "human", "value": "tell me <image> please"},
            {"from": "gpt", "value": "ok"}]]
    got = tdata.preprocess_multimodal(json.loads(json.dumps(src)), mm_use_im_start_end=start_end)
    want = jdata.preprocess_multimodal(json.loads(json.dumps(src)), mm_use_im_start_end=start_end)
    assert got == want
    assert "please" in got[0][0]["value"]
    if not start_end and template == "v1":
        assert got[0][0]["value"].startswith("<image>\n")


def test_preprocess_mpt_masks_instructions_supervises_answers():
    out, want, tok = both("preprocess_mpt", has_image=True, tokenizer=MptWordTokenizer)
    assert_out_equal(out, want)
    ids, labels = out["input_ids"][0], out["labels"][0]
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    sup = tok.decode(labels[labels != IGNORE_INDEX])
    assert sup == "The picture shows a red cat . <|im_end|> It is red . <|im_end|>"
    mask = labels != IGNORE_INDEX
    np.testing.assert_array_equal(labels[mask], ids[mask])


def test_preprocess_llama_2_masks_instructions_supervises_answers():
    out, want, tok = both("preprocess_llama_2", has_image=True)
    assert_out_equal(out, want)
    ids, labels = out["input_ids"][0], out["labels"][0]
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    assert (labels != IGNORE_INDEX).any()
    sup = tok.decode(labels[labels != IGNORE_INDEX])
    assert "cat" in sup and "red" in sup
    assert "What" not in sup
    mask = labels != IGNORE_INDEX
    np.testing.assert_array_equal(labels[mask], ids[mask])


def test_preprocess_plain_supervises_caption_only():
    _template("plain")
    src = [[{"from": "human", "value": "<image>"},
            {"from": "gpt", "value": "a red cat on a mat"}]]
    out, want, tok = both("preprocess_plain", src)
    assert_out_equal(out, want)
    ids, labels = out["input_ids"][0], out["labels"][0]
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    assert labels[0] == IGNORE_INDEX
    sup = tok.decode(labels[labels != IGNORE_INDEX])
    assert "cat" in sup and "mat" in sup


@pytest.mark.parametrize("template", ["v1", "plain", "llama_2", "mpt"])
def test_preprocess_dispatch_matches_jax(template):
    _template(template)
    src = ([[{"from": "human", "value": "<image>"}, {"from": "gpt", "value": "a red cat"}]]
           if template == "plain" else None)
    tokenizer = MptWordTokenizer if template == "mpt" else WordTokenizer
    kw = {} if template == "plain" else {"has_image": True}
    out, want, _ = both("preprocess", *([src] if src else []), tokenizer=tokenizer, **kw)
    assert_out_equal(out, want)


def datasets(tmp_path, **kw):
    """The port's and the JAX package's ``LazySupervisedDataset`` over
    ``tiny_mix_dataset`` at a 56-pixel crop, each with its own tokenizer."""
    data_path, folder = tiny_mix_dataset(tmp_path)
    args = dict(data_path=data_path, image_folder=folder, image_aspect_ratio="pad", **kw)
    tds = tdata.LazySupervisedDataset(data_path, WordTokenizer(), tdata.DataArguments(**args),
                                      ClipImagePreprocessor(size=56, crop_size=56))
    jds = jdata.LazySupervisedDataset(data_path, WordTokenizer(), jdata.DataArguments(**args),
                                      JProcessor(size=56, crop_size=56))
    return tds, jds


def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_dataset_and_collator(tmp_path, monkeypatch, native):
    if not native:  # both packages take the PIL path
        monkeypatch.setattr(tnative, "native_available", lambda: False)
        monkeypatch.setattr(jnative, "native_available", lambda: False)
    ds, jds = datasets(tmp_path)
    assert len(ds) == len(jds) == 4
    assert ds.lengths == jds.lengths
    ml = ds.modality_lengths
    assert ml == jds.modality_lengths and ml[2] < 0 and ml[0] > 0

    calls = tnative.clip_preprocess_batch_native.calls
    items = [ds[i] for i in range(len(ds))]
    assert (tnative.clip_preprocess_batch_native.calls - calls) == (3 if native else 0)
    for i, item in enumerate(items):
        assert_items_equal(item, jds[i])
    item = items[0]
    assert item["image"].shape == (56, 56, 3)
    assert (item["input_ids"] == IMAGE_TOKEN_INDEX).sum() == 1
    # the text-only sample carries a zero image and no image token
    assert not items[2]["image"].any() and (items[2]["input_ids"] != IMAGE_TOKEN_INDEX).all()

    coll = tdata.Collator(num_image_tokens=16, model_max_length=256, pad_bucket=32)
    jcoll = jdata.Collator(num_image_tokens=16, model_max_length=256, pad_bucket=32)
    plan, images = coll([items[0], items[2]])
    jplan, jimages = jcoll([jds[0], jds[2]])
    assert_plans_equal(plan, jplan)
    assert images.dtype == jimages.dtype and np.array_equal(images, jimages)
    assert plan.batch == 2
    assert plan.seq_len % 32 == 0
    assert images.shape[0] == 2
    assert plan.spans.has_image.tolist() == [True, False]
    assert plan.spans.answer_end[0] > plan.spans.answer_start[0]

    ds2, jds2 = datasets(tmp_path, requires_image=True)
    assert len(ds2) == len(jds2) == 3


def test_collator_buckets_and_caps_like_jax(tmp_path):
    """The fused length rounds up to ``pad_bucket`` and is capped at
    ``model_max_length + num_image_tokens`` rounded up, as in JAX."""
    ds, jds = datasets(tmp_path)
    for kw in (dict(num_image_tokens=16, model_max_length=256, pad_bucket=128),
               dict(num_image_tokens=16, model_max_length=20, pad_bucket=32),
               dict(num_image_tokens=64, model_max_length=2048)):
        plan, _ = tdata.Collator(**kw)([ds[i] for i in range(4)])
        jplan, _ = jdata.Collator(**kw)([jds[i] for i in range(4)])
        assert_plans_equal(plan, jplan)


@pytest.mark.parametrize("seed", [0, 3])
def test_grouped_length_sampler_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lengths = [int(v) * (1 if rng.random() < 0.7 else -1)
               for v in rng.integers(1, 400, 300)]
    for bs, world in ((4, 1), (3, 2)):
        got = list(tdata.GroupedLengthSampler(lengths, bs, world_size=world, seed=seed))
        want = list(jdata.GroupedLengthSampler(lengths, bs, world_size=world, seed=seed))
        assert got == want and sorted(got) == list(range(len(lengths)))


@pytest.mark.parametrize("group,shuffle,drop_last",
                         [(True, True, True), (False, True, True), (False, False, False)])
def test_data_loader_order_matches_jax(tmp_path, group, shuffle, drop_last):
    ds, jds = datasets(tmp_path)
    coll = tdata.Collator(num_image_tokens=16, model_max_length=128, pad_bucket=32)
    jcoll = jdata.Collator(num_image_tokens=16, model_max_length=128, pad_bucket=32)
    kw = dict(batch_size=3, seed=5, group_by_modality_length=group, shuffle=shuffle,
              drop_last=drop_last)
    got = list(tdata.data_loader(ds, coll, **kw))
    want = list(jdata.data_loader(jds, jcoll, **kw))
    assert len(got) == len(want) == (1 if drop_last else 2)
    for (plan, images), (jplan, jimages) in zip(got, want):
        assert_plans_equal(plan, jplan)
        assert np.array_equal(images, jimages)


def test_data_loader_and_trainer_e2e(tmp_path):
    """Two optimizer steps over the port's pipeline on a tiny model (CPU),
    then a save and a resume that restores the step counter."""
    import torch

    from dynamic_llava_tpu_torch.config import (
        ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig)
    from dynamic_llava_tpu_torch.train.trainer import Trainer, TrainerConfig
    from dynamic_llava_tpu_torch.weights import init_llava_params

    ds, _ = datasets(tmp_path)
    cfg = LlavaConfig(
        text=LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                         num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4),
        vision=ClipVisionConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                                num_attention_heads=2, image_size=56, patch_size=14),
        sparse=SparseConfig(use_vision_predictor=True, use_output_text_predictor=True,
                            output_text_len_for_training=2, d_model=24, nhead=2,
                            dim_feedforward=48, num_layers=1),
    )
    params = init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    tc = TrainerConfig(output_dir=str(tmp_path / "out"), num_train_steps=2, logging_steps=1,
                       save_steps=0, learning_rate=1e-4, predictor_lr=1e-3,
                       gradient_checkpointing=False)
    trainer = Trainer(cfg, params, tc, device="cpu")
    coll = tdata.Collator(num_image_tokens=cfg.num_image_tokens, model_max_length=128,
                          pad_bucket=32)
    metrics = trainer.train(tdata.data_loader(ds, coll, batch_size=2, seed=0))
    assert np.isfinite(metrics["loss"])
    assert "image_mask_loss" in metrics and "output_text_mask_loss" in metrics
    assert (tmp_path / "out" / "metrics.jsonl").exists()
    trainer.save()
    trainer.logger.close()
    trainer2 = Trainer(cfg, params, tc, device="cpu")
    assert trainer2.maybe_resume()
    assert trainer2.step == 2
    trainer2.logger.close()


def _pil_reference(arr: np.ndarray, size: int) -> np.ndarray:
    proc = ClipImagePreprocessor(size=size, crop_size=size)
    return proc(expand2square(Image.fromarray(arr), proc.background_color))


def _native(mod, imgs, size):
    proc = ClipImagePreprocessor(size=size)
    return mod.clip_preprocess_batch_native(imgs, size, proc.background_color,
                                           OPENAI_CLIP_MEAN, OPENAI_CLIP_STD)


@pytest.mark.parametrize("h,w", [(100, 160), (64, 64), (250, 100), (30, 300)])
def test_native_matches_jax_bits_and_pil(h, w):
    assert tnative.native_available() and jnative.native_available()
    rng = np.random.default_rng(h * 1000 + w)
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = _native(tnative, [arr], 112)[0]
    assert np.array_equal(got.view(np.uint32), _native(jnative, [arr], 112)[0].view(np.uint32))
    # test_native_image_ops.py's tolerance of PIL: ~2 uint8 steps after
    # normalization (PIL's int16 fixed-point coefficients against doubles)
    err = np.abs(got - _pil_reference(arr, 112))
    assert np.mean(err) < 0.01, np.mean(err)
    assert np.quantile(err, 0.999) < 0.05, np.quantile(err, 0.999)


def test_native_batch_ragged():
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in [(40, 80), (96, 48), (56, 56)]]
    out = _native(tnative, imgs, 56)
    assert out.shape == (3, 56, 56, 3)
    assert np.array_equal(out.view(np.uint32), _native(jnative, imgs, 56).view(np.uint32))
    for i, im in enumerate(imgs):
        assert np.mean(np.abs(out[i] - _pil_reference(im, 56))) < 0.01
    with pytest.raises(ValueError, match="uint8"):
        _native(tnative, [imgs[0].astype(np.float32)], 56)


BUILD = r"""
import sys
from pathlib import Path
from dynamic_llava_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
path = native.BUILD_DIR / native.library_path().name
assert native._build(path)
import ctypes
lib = ctypes.CDLL(str(path))
print(lib.image_ops_version())
"""


def test_native_builds_at_once_into_one_whole_library(tmp_path):
    """Processes that build the library into one directory at once each
    write a file of their own and rename it into place: every one loads a
    whole library, and no temporary file is left behind."""
    build = tmp_path / "_build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(build)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    assert [out.strip() for out, _ in outs] == ["1"] * 4
    assert sorted(p.name for p in build.iterdir()) == [tnative.library_path().name]
    # the library sits in the port's _build/, not beside the source
    assert tnative.library_path().parent == ROOT / "dynamic_llava_tpu_torch" / "_build"
    assert tnative.library_path().name.startswith("libimage_ops_")
