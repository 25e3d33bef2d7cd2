"""The port's own copies of the framework-free host code against the JAX
package's: the config dataclasses (same fields, same defaults, same derived
values), the constants, the numpy fusion planner (equal ``FusionPlan``s
on seeded inputs), the conversation templates (every template renders
the same prompt from the same messages), the HF ``config.json``
constructors (``from_hf_dict``, and the builder's
``llava_config_from_hf_dict`` where the dict has no ``vision_config``) and
``mm_utils`` (prompt tokenization, image preprocessing, anyres geometry,
the keyword stop). ``port_config`` is the helper the other port tests use to
build the port's config from the JAX package's field values."""

import ast
import dataclasses
from pathlib import Path

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
                 "DEFAULT_IM_END_TOKEN", "IMAGE_PLACEHOLDER", "LOGDIR",
                 "CONTROLLER_HEART_BEAT_EXPIRATION", "WORKER_HEART_BEAT_INTERVAL"):
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


POPE_ANSWERS = ["Yes, there is.", "No.", "There is not a dog.", "yes", "No, there is no cat",
                "Maybe. No.", "", "no, not at all", "It is, no doubt", "NO", "I see one, not two.",
                "none"]
POPE_LABELS = ["yes", "no", "no", "yes", "no", "yes", "no", "no", "yes", "no", "yes", "no"]


def test_pope_scorer_matches():
    """The port's own copy of ``eval/eval_pope.py``: the same decision per
    answer and the same metrics on a fixed list (and the same error on a
    length mismatch)."""
    from dynamic_llava_tpu.eval import eval_pope as jpope
    from dynamic_llava_tpu_torch.eval import eval_pope as tpope

    assert [tpope.normalize_answer(a) for a in POPE_ANSWERS] == \
        [jpope.normalize_answer(a) for a in POPE_ANSWERS]
    assert tpope.score_pope(POPE_ANSWERS, POPE_LABELS) == \
        jpope.score_pope(POPE_ANSWERS, POPE_LABELS)
    assert tpope.score_pope([], []) == jpope.score_pope([], [])
    for mod in (tpope, jpope):
        with pytest.raises(ValueError, match="predictions"):
            mod.score_pope(POPE_ANSWERS, POPE_LABELS[:3])


HF_DICTS = {
    "defaults": {},
    "gqa_rope_type_tied_window": {
        "vocab_size": 100, "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 3, "num_attention_heads": 8, "num_key_value_heads": 2,
        "max_position_embeddings": 8192, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
        "rope_scaling": {"type": "linear", "factor": 2}, "tie_word_embeddings": True,
        "sliding_window": 4096, "attention_bias": True},
    "mha_rope_type_key": {"num_attention_heads": 8, "rope_scaling": {"rope_type": "dynamic",
                                                                     "factor": 4.0}},
    "clip_b16": {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
                 "num_attention_heads": 12, "image_size": 224, "patch_size": 16,
                 "layer_norm_eps": 1e-6, "projection_dim": 512},
}


@pytest.mark.parametrize("name", sorted(HF_DICTS))
def test_from_hf_dict_matches(name):
    d = HF_DICTS[name]
    assert tconfig.LlamaConfig.from_hf_dict(d) == port_config(jconfig.LlamaConfig.from_hf_dict(d))
    for args in ((), (-1, "cls_patch")):
        assert tconfig.ClipVisionConfig.from_hf_dict(d, *args) == port_config(
            jconfig.ClipVisionConfig.from_hf_dict(d, *args))


LLAVA_DICTS = [
    {},
    {"mm_vision_tower": "openai/clip-vit-large-patch14", "mm_projector_type": "mlp2x_gelu",
     "mm_vision_select_layer": -1, "mm_vision_select_feature": "cls_patch",
     "image_aspect_ratio": "pad", "mm_use_im_start_end": True, "max_length": 1024,
     "model_max_length": 4096, "num_key_value_heads": 8,
     "sparse_config": {"vision_keep_rate": 0.3, "sparse_layer": 3, "unknown_key": 1}},
    {"mm_vision_tower": "openai/clip-vit-large-patch14-336", "model_max_length": 512,
     "mm_use_im_patch_token": False, "sparse_config": {}},
]


@pytest.mark.parametrize("i", range(len(LLAVA_DICTS)))
def test_llava_config_from_hf_dict_matches(i):
    from dynamic_llava_tpu.models import builder as jbuilder
    from dynamic_llava_tpu_torch.models import builder as tbuilder

    d = LLAVA_DICTS[i]
    assert tbuilder.llava_config_from_hf_dict(d) == port_config(
        jbuilder.llava_config_from_hf_dict(d))


def _pil_images():
    from PIL import Image

    rng = np.random.default_rng(1)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype("uint8"))
            for h, w in ((40, 64), (64, 40), (50, 50), (336, 500), (21, 13))]


@pytest.mark.parametrize("aspect", ["pad", "square"])
def test_process_images_matches(aspect):
    from dynamic_llava_tpu import mm_utils as jmm
    from dynamic_llava_tpu_torch import mm_utils as tmm

    for size in (56, 336):
        jp, tp = jmm.ClipImagePreprocessor(size), tmm.ClipImagePreprocessor(size)
        assert tp.background_color == jp.background_color
        images = _pil_images()
        want = jmm.process_images(images, jp, image_aspect_ratio=aspect)
        got = tmm.process_images(images, tp, image_aspect_ratio=aspect)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
        cfg = tconfig.LlavaConfig(image_aspect_ratio=aspect)
        assert np.array_equal(tmm.process_images(images, tp, cfg), want)


def test_anyres_and_name_helpers_match():
    from dynamic_llava_tpu import mm_utils as jmm
    from dynamic_llava_tpu_torch import mm_utils as tmm

    grid = [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]]
    for size in ((500, 300), (300, 900), (336, 336), (1000, 10)):
        assert tmm.select_best_resolution(size, grid) == jmm.select_best_resolution(size, grid)
        for g in (grid, str(grid)):
            assert tmm.get_anyres_image_grid_shape(size, g, 336) == \
                jmm.get_anyres_image_grid_shape(size, g, 336)
    image = _pil_images()[0]
    small = [[28, 56], [56, 28], [56, 56]]
    assert np.array_equal(
        tmm.process_anyres_image(image, tmm.ClipImagePreprocessor(28), small),
        jmm.process_anyres_image(image, jmm.ClipImagePreprocessor(28), small))
    for path in ("/a/b/llava-v1.5-7b", "ckpts/run/checkpoint-500/", "model"):
        assert tmm.get_model_name_from_path(path) == jmm.get_model_name_from_path(path)


PROMPTS = ["USER: <image>\nWhat is it? ASSISTANT:", "no image here </s>",
           "<image> first and <image> second", "<image>", ""]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_tokenizer_image_token_matches(prompt):
    from dynamic_llava_tpu import mm_utils as jmm
    from dynamic_llava_tpu_torch import mm_utils as tmm
    from helpers import WordTokenizer

    tok = WordTokenizer()
    want = jmm.tokenizer_image_token(prompt, tok)
    assert tmm.tokenizer_image_token(prompt, tok) == want
    assert np.array_equal(tmm.tokenizer_image_token(prompt, tok, return_tensors="np"),
                          jmm.tokenizer_image_token(prompt, tok, return_tensors="np"))
    assert tmm.tokenizer_image_token(prompt, tok, return_tensors="pt").tolist() == want
    with pytest.raises(ValueError, match="Unsupported"):
        tmm.tokenizer_image_token(prompt, tok, return_tensors="jax")


def test_keywords_stopping_criteria_matches():
    from dynamic_llava_tpu import mm_utils as jmm
    from dynamic_llava_tpu_torch import mm_utils as tmm
    from helpers import WordTokenizer

    tok = WordTokenizer()
    words = [tok.convert_tokens_to_ids(w) for w in ("a", "b", "</s>", "###", "c")]
    j = jmm.KeywordsStoppingCriteria(["</s>", "### c"], tok, 2)
    t = tmm.KeywordsStoppingCriteria(["</s>", "### c"], tok, 2)
    assert t.keyword_ids == j.keyword_ids and t.max_keyword_len == j.max_keyword_len
    rng = np.random.default_rng(2)
    for n in range(0, 9):
        seq = [int(x) for x in rng.choice(words, size=n)]
        assert t(seq) == j(seq), seq
    assert t([7, 7, words[3], words[4]]) and not t([7, 7])


SERVE_COPIES = ["http_compat", "controller", "register_worker", "test_message",
                "gradio_web_server"]
ROOT = Path(__file__).resolve().parent.parent


class _DropImportsOf(ast.NodeTransformer):
    def __init__(self, module):
        self.module = module

    def visit_Import(self, node):
        return None if [a.name for a in node.names] == [self.module] else node


def _code(path: Path, drop_requests_imports: bool) -> str:
    """The module's code without its docstring (and, if asked, without its
    ``import requests`` statements), as an AST dump."""
    tree = ast.parse(path.read_text())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    if drop_requests_imports:
        tree = _DropImportsOf("requests").visit(tree)
    return ast.dump(tree)


@pytest.mark.parametrize("name", SERVE_COPIES)
def test_serve_copies_match_their_originals(name):
    """The port's own copies of the framework-free serving modules: the same
    code as the JAX package's but for the docstring. The Gradio front end
    imports ``requests`` inside the functions that post instead of at the
    top (it then imports where ``requests`` is missing); that is the one
    difference allowed."""
    port = ROOT / "dynamic_llava_tpu_torch" / "serve" / f"{name}.py"
    orig = ROOT / "dynamic_llava_tpu" / "serve" / f"{name}.py"
    lazy = name == "gradio_web_server"
    assert _code(port, lazy) == _code(orig, lazy)
    if lazy:
        tree = ast.parse(port.read_text())
        assert not [n for n in tree.body if isinstance(n, ast.Import)
                    and n.names[0].name == "requests"]
        posting = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)
                   and any(isinstance(s, ast.Import) and s.names[0].name == "requests"
                           for s in n.body)}
        assert posting == {"get_model_list", "http_bot"}
