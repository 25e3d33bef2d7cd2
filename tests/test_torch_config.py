"""The port's own copies of the framework-free host code against the JAX
package's: the config dataclasses (same fields, same defaults, same derived
values), the constants, the numpy fusion planner (equal ``FusionPlan``s
on seeded inputs), and the conversation templates (every template renders
the same prompt from the same messages). ``port_config`` is the helper the other port tests use to
build the port's config from the JAX package's field values."""

import dataclasses

import numpy as np
import pytest

from dynamic_llava_tpu import config as jconfig
from dynamic_llava_tpu import constants as jconstants
from dynamic_llava_tpu import conversation as jconversation
from dynamic_llava_tpu.multimodal import fusion as jfusion
from dynamic_llava_tpu_torch import config as tconfig
from dynamic_llava_tpu_torch import constants as tconstants
from dynamic_llava_tpu_torch import conversation as tconversation
from dynamic_llava_tpu_torch.multimodal import fusion as tfusion


def port_config(cfg):
    """The port's dataclass with the field values of a JAX-package config
    (any of its dataclasses, nested ones included)."""
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{
        f.name: port_config(v) if dataclasses.is_dataclass(v) else v
        for f in dataclasses.fields(cfg)
        for v in [getattr(cfg, f.name)]
    })


CLASSES = ["SparseConfig", "RopeScalingConfig", "LlamaConfig", "ClipVisionConfig",
           "LlavaConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_and_defaults_match(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert tf == jf
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_tiny_and_derived_values_match():
    j, t = jconfig.LlavaConfig.tiny(), tconfig.LlavaConfig.tiny()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert port_config(j) == t
    assert t.num_image_tokens == j.num_image_tokens
    assert t.vision_keep_budget == j.vision_keep_budget
    assert t.text.head_dim == j.text.head_dim
    assert t.vision.num_positions == j.vision.num_positions
    assert t.sparse.any_predictor == j.sparse.any_predictor
    assert (dataclasses.asdict(tconfig.DENSE_SPARSE_CONFIG)
            == dataclasses.asdict(jconfig.DENSE_SPARSE_CONFIG))
    for n in (16, 576, 3):
        assert t.sparse.vision_keep_budget(n) == j.sparse.vision_keep_budget(n)
    assert tconfig.LlavaConfig.from_json(t.to_json()) == t
    assert dataclasses.asdict(tconfig.LlamaConfig.mistral_7b()) == dataclasses.asdict(
        jconfig.LlamaConfig.mistral_7b())


def test_sliding_window_with_predictors_raises_in_both():
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError, match="sliding_window"):
            mod.LlavaConfig(text=mod.LlamaConfig.tiny(sliding_window=8))


def test_constants_match():
    for name in ("IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "DEFAULT_IMAGE_TOKEN",
                 "DEFAULT_IMAGE_PATCH_TOKEN", "DEFAULT_IM_START_TOKEN",
                 "DEFAULT_IM_END_TOKEN", "IMAGE_PLACEHOLDER"):
        assert getattr(tconstants, name) == getattr(jconstants, name)
    assert tconfig.IMAGE_TOKEN_INDEX == jconstants.IMAGE_TOKEN_INDEX
    assert tfusion.VICUNA_USER_TOKENS == jfusion.VICUNA_USER_TOKENS


def _samples(seed, with_labels):
    rng = np.random.default_rng(seed)
    ids, labels = [], []
    for i, n in enumerate((30, 17, 41, 12)):
        row = rng.integers(3, 500, size=(n,)).astype(np.int64)
        if i != 1:  # sample 1 is text-only
            row[int(rng.integers(1, 6))] = jconstants.IMAGE_TOKEN_INDEX
        if i == 2:  # a "USER:" marker for the last-instruct scan
            row[20:22] = jfusion.VICUNA_USER_TOKENS
        lab = row.copy()
        lab[: n // 2] = jconstants.IGNORE_INDEX
        ids.append(row)
        labels.append(lab)
    return ids, (labels if with_labels else None)


@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("kwargs", [{}, {"pad_multiple": 16}, {"max_length": 40},
                                    {"pad_to": 64}])
def test_plan_batch_matches(with_labels, kwargs):
    ids, labels = _samples(0, with_labels)
    want = jfusion.plan_batch(ids, 16, labels_list=labels, **kwargs)
    got = tfusion.plan_batch(ids, 16, labels_list=labels, **kwargs)
    assert type(got).__name__ == "FusionPlan" and got._fields == want._fields
    assert got.spans._fields == want.spans._fields
    for name in want._fields:
        if name == "spans":
            continue
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    for name in want.spans._fields:
        g, w = getattr(got.spans, name), getattr(want.spans, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert (got.batch, got.seq_len) == (want.batch, want.seq_len)


def test_conversation_templates_are_the_same_set():
    assert sorted(tconversation.conv_templates) == sorted(jconversation.conv_templates)
    assert [m.name for m in tconversation.SeparatorStyle] == \
        [m.name for m in jconversation.SeparatorStyle]
    for name in ("default_conversation", "conv_vicuna_v1", "conv_llava_v1"):
        t, j = getattr(tconversation, name), getattr(jconversation, name)
        assert t.get_prompt() == j.get_prompt() and t.version == j.version


@pytest.mark.parametrize("image", [True, False], ids=["image", "text"])
@pytest.mark.parametrize("name", sorted(jconversation.conv_templates))
def test_conversation_prompts_match(name, image):
    """Two rounds (the first with an image tuple, as the serving UI sends
    it) and an open assistant turn: the same prompt and ``dict``, or the
    same error (the ``plain`` style has no second separator and renders one
    exchange only)."""
    prompts = []
    for mod in (jconversation, tconversation):
        conv = mod.conv_templates[name].copy()
        first = "<image>\nWhat is in the picture?"
        conv.append_message(conv.roles[0], (first, "an image", "Pad") if image else first)
        conv.append_message(conv.roles[1], "A cat on a mat.")
        conv.append_message(conv.roles[0], "And its colour?")
        conv.append_message(conv.roles[1], None)
        try:
            prompts.append((conv.get_prompt(), conv.dict(), conv.sep_style.name))
        except TypeError as e:
            prompts.append(str(e))
    assert prompts[1] == prompts[0]
