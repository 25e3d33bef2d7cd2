"""The port's checkpoint loading against the JAX package's: the converter
and ``load_pretrained_model`` leaf for leaf (``torch.equal`` against
``np.asarray``, bf16 compared by bits), the loaded configs equal, for every
checkpoint form: fp32 / fp16 / bf16 ``.bin``, ``.safetensors``, two
``.bin`` shards with an index, GQA, tied embeddings, ``rope_scaling``, a
projector-only checkpoint over ``model_base``, a separate tower directory.
Export both ways (the port's exporter read by the JAX builder, and the
port's exact config round trip where the JAX one loses fields), the weight
tools' outputs against the JAX tools', and the vision tokenizer's growth.
The checkpoints are written from one JAX-initialised tiny model."""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import (
    ClipVisionConfig, LlamaConfig, LlavaConfig, RopeScalingConfig, SparseConfig)
from dynamic_llava_tpu.models import builder as jbuilder
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.models import export as jexport
from dynamic_llava_tpu.models import tokenizer_init as jtok
from dynamic_llava_tpu.models import weight_tools as jtools
from dynamic_llava_tpu_torch.models import builder as tbuilder
from dynamic_llava_tpu_torch.models import convert as tconvert
from dynamic_llava_tpu_torch.models import export as texport
from dynamic_llava_tpu_torch.models import tokenizer_init as ttok
from dynamic_llava_tpu_torch.models import weight_tools as ttools
from dynamic_llava_tpu_torch.weights import named_leaves, params_from_numpy

from helpers import WordTokenizer
from test_torch_config import port_config

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
FILE_DTYPES = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


def tiny_cfg(**text) -> LlavaConfig:
    """Two decoder layers, a two-layer tower, all three predictors."""
    return LlavaConfig(
        text=LlamaConfig(**{**dict(vocab_size=96, hidden_size=64, intermediate_size=96,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=4), **text}),
        vision=ClipVisionConfig(hidden_size=64, intermediate_size=48, num_hidden_layers=2,
                                num_attention_heads=2, image_size=28, patch_size=14),
        sparse=SparseConfig(use_instruct_predictor=True, sparse_layer=1, d_model=32, nhead=2,
                            dim_feedforward=64, num_layers=1),
    )


def jax_state_dict(params, cfg):
    """The JAX exporter's reference-named state dict of ``params`` (fp32
    numpy)."""
    sd = jexport.llama_state_dict(params["llm"])
    sd.update(jexport.clip_state_dict(params["vision_tower"], cfg.vision))
    sd.update(jexport.projector_state_dict(params["mm_projector"]))
    preds = params["predictors"]
    sd.update(jexport.vision_predictor_state_dict(preds["image_score_predictor"]))
    for name in ("output_text_score_predictor", "instruct_score_predictor"):
        sd.update(jexport.text_predictor_state_dict(preds[name], f"model.{name}."))
    return sd


def write_dir(path, sd, config, dtype=torch.float32, form="bin"):
    """A checkpoint directory of ``sd`` in ``dtype``: one ``.bin``, one
    ``.safetensors``, or two ``.bin`` shards with an index."""
    os.makedirs(path, exist_ok=True)
    tensors = {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in sd.items()}
    if form == "safetensors":
        from safetensors.torch import save_file

        save_file(tensors, os.path.join(path, "model.safetensors"))
    elif form == "shards":
        names = sorted(tensors)
        halves = {"pytorch_model-00001-of-00002.bin": names[::2],
                  "pytorch_model-00002-of-00002.bin": names[1::2]}
        for fname, keys in halves.items():
            torch.save({k: tensors[k] for k in keys}, os.path.join(path, fname))
        with open(os.path.join(path, "pytorch_model.bin.index.json"), "w") as f:
            json.dump({"weight_map": {k: fname for fname, keys in halves.items()
                                      for k in keys}}, f)
    else:
        torch.save(tensors, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return str(path)


def jax_config_json(cfg):
    """The JAX exporter's ``config.json`` of ``cfg`` plus the HF fields it
    does not write (tied embeddings, RoPE scaling), as an HF checkpoint
    carries them."""
    d = {
        "model_type": "dynamic_llava_llama", "vocab_size": cfg.text.vocab_size,
        "hidden_size": cfg.text.hidden_size, "intermediate_size": cfg.text.intermediate_size,
        "num_hidden_layers": cfg.text.num_hidden_layers,
        "num_attention_heads": cfg.text.num_attention_heads,
        "num_key_value_heads": cfg.text.num_key_value_heads,
        "mm_projector_type": cfg.mm_projector_type,
        "mm_vision_tower": "openai/clip-vit-large-patch14-336",
        "mm_vision_select_layer": -2, "image_aspect_ratio": "pad",
        "model_max_length": 512, "sparse_config": cfg.sparse.to_dict(),
        "tie_word_embeddings": cfg.text.tie_word_embeddings,
    }
    if cfg.text.rope_scaling is not None:
        d["rope_scaling"] = {"type": cfg.text.rope_scaling.rope_type,
                             "factor": cfg.text.rope_scaling.factor}
    return d


VARIANTS = {
    "base": {},
    "gqa": dict(num_key_value_heads=2),
    "tied": dict(tie_word_embeddings=True),
    "rope_scaling": dict(rope_scaling=RopeScalingConfig(rope_type="linear", factor=2.0)),
}


@pytest.fixture(scope="module")
def models():
    """One JAX-initialised model a variant: (cfg, params, state dict)."""
    out = {}
    for i, (name, text) in enumerate(VARIANTS.items()):
        cfg = tiny_cfg(**text)
        params = jax.tree.map(np.asarray, jdyn.init_llava_params(jax.random.key(i), cfg))
        out[name] = (cfg, params, jax_state_dict(params, cfg))
    return out


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpts")


def assert_trees_equal(port_params, jax_params):
    """Leaf for leaf bit equality of a port tree and a JAX / numpy tree."""
    tl = dict(named_leaves(port_params))
    jl = dict(named_leaves(jax.tree.map(np.asarray, jax_params)))
    assert sorted(tl) == sorted(jl)
    for k, t in tl.items():
        j = np.asarray(jl[k])
        if t.dtype == torch.bfloat16:
            assert str(j.dtype) == "bfloat16", k
            assert torch.equal(t.view(torch.int16), torch.from_numpy(np.array(j).view(np.int16))), k
        else:
            assert t.dtype == torch.from_numpy(j).dtype, k
            assert torch.equal(t, torch.from_numpy(np.array(j))), k


def load_both(path, dtype, **kw):
    tdt, jdt = DTYPES[dtype]
    _, jr, jproc, jctx = jbuilder.load_pretrained_model(path, dtype=jdt, **kw)
    _, tr, tproc, tctx = tbuilder.load_pretrained_model(path, dtype=tdt, device="cpu", **kw)
    assert tr.cfg == port_config(jr.cfg)
    assert (tproc.size, tctx) == (jproc.size, jctx)
    return tr, jr


FORMS = [("fp32", "bin"), ("fp16", "bin"), ("bf16", "bin"), ("fp16", "safetensors"),
         ("bf16", "safetensors"), ("fp16", "shards"), ("bf16", "shards")]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("file_dtype,form", FORMS)
def test_load_pretrained_model_matches_jax(models, ckpt_root, file_dtype, form, dtype):
    cfg, _, sd = models["base"]
    path = ckpt_root / f"{file_dtype}-{form}"
    if not path.exists():
        write_dir(path, sd, jax_config_json(cfg), FILE_DTYPES[file_dtype], form)
    tr, jr = load_both(str(path), dtype)
    assert_trees_equal(tr.params, jr.params)
    assert {t.dtype for _, t in named_leaves(tr.params)} == {DTYPES[dtype][0]}


@pytest.mark.parametrize("variant", ["gqa", "tied", "rope_scaling"])
def test_decoder_variants_match_jax(models, ckpt_root, variant):
    cfg, _, sd = models[variant]
    path = write_dir(ckpt_root / variant, sd, jax_config_json(cfg), torch.float16)
    tr, jr = load_both(path, "bfloat16")
    assert_trees_equal(tr.params, jr.params)
    assert tr.cfg.text == port_config(cfg.text)
    assert ("lm_head" in tr.params["llm"]) == (not cfg.text.tie_word_embeddings)


def test_projector_only_over_model_base_and_a_tower_dir_match_jax(models, tmp_path):
    cfg, _, sd = models["base"]
    tower_prefix = "model.vision_tower.vision_tower.vision_model."
    tower = {"vision_model." + k[len(tower_prefix):]: v for k, v in sd.items()
             if k.startswith(tower_prefix)}
    rest = {k: v for k, v in sd.items() if not k.startswith(tower_prefix)}
    proj = {k: v for k, v in rest.items() if "mm_projector" in k}
    # the base holds a different projector: the projector-only checkpoint's wins
    base_sd = {k: (v + 1.0 if "mm_projector" in k else v) for k, v in rest.items()}
    config = jax_config_json(cfg)
    base = write_dir(tmp_path / "base", base_sd, config, torch.float16)
    stage1 = write_dir(tmp_path / "proj", proj, config, torch.float16)
    tower_dir = write_dir(tmp_path / "tower", tower, {}, torch.float16)
    tr, jr = load_both(stage1, "float32", model_base=base, tower_path=tower_dir)
    assert_trees_equal(tr.params, jr.params)
    assert torch.equal(tr.params["mm_projector"][0]["w"],
                       torch.from_numpy(proj["model.mm_projector.0.weight"].T).half().float())
    assert "vision_tower" in tr.params


def test_the_port_export_loads_in_jax_and_round_trips_its_config(models, tmp_path):
    cfg, params, _ = models["gqa"]
    tcfg = port_config(cfg)
    tp = params_from_numpy(params, "cpu", torch.float32)
    texport.export_hf_checkpoint(tp, tcfg, str(tmp_path / "port"))
    _, jr, _, _ = jbuilder.load_pretrained_model(str(tmp_path / "port"), dtype=jnp.float32)
    assert_trees_equal(tp, jr.params)
    _, tr, _, _ = tbuilder.load_pretrained_model(str(tmp_path / "port"), dtype=torch.float32,
                                                 device="cpu")
    assert_trees_equal(tr.params, jr.params)
    assert tr.cfg == tcfg


def test_bf16_export_is_written_and_read_back_in_bf16(models, tmp_path):
    cfg, params, _ = models["base"]
    tp = params_from_numpy(params, "cpu", torch.bfloat16)
    texport.export_hf_checkpoint(tp, port_config(cfg), str(tmp_path))
    sd = tconvert.load_state_dict_from_dir(str(tmp_path))
    assert {v.dtype for v in sd.values()} == {torch.bfloat16}
    _, tr, _, _ = tbuilder.load_pretrained_model(str(tmp_path), device="cpu")
    for (path, a), (_, b) in zip(named_leaves(tr.params), named_leaves(tp)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), path


@pytest.mark.parametrize("variant", ["tied", "rope_scaling"])
def test_jax_round_trip_loses_what_the_port_keeps(models, tmp_path, variant):
    """ROADMAP §C21: the JAX exporter writes no ``tie_word_embeddings``, no
    ``rope_scaling`` and no tower config, so its own builder fails on a
    tied model, drops the RoPE scaling, and reads a tower of 2 heads of 32
    as 1 head of 64. The port's export -> load gives back the config."""
    cfg, params, _ = models[variant]
    jexport.export_hf_checkpoint(params, cfg, str(tmp_path / "jax"))
    if variant == "tied":
        with pytest.raises(KeyError, match="lm_head"):
            jbuilder.load_pretrained_model(str(tmp_path / "jax"), dtype=jnp.float32)
    else:
        _, jr, _, _ = jbuilder.load_pretrained_model(str(tmp_path / "jax"), dtype=jnp.float32)
        assert jr.cfg.text.rope_scaling is None and cfg.text.rope_scaling is not None
        assert jr.cfg.vision.num_attention_heads == 1 != cfg.vision.num_attention_heads
    tcfg = port_config(cfg)
    texport.export_hf_checkpoint(params_from_numpy(params, "cpu", torch.float32), tcfg,
                                 str(tmp_path / "port"))
    _, tr, _, _ = tbuilder.load_pretrained_model(str(tmp_path / "port"), dtype=torch.float32,
                                                 device="cpu")
    assert tr.cfg == tcfg


def test_load_pretrained_model_defaults_to_the_card_and_refuses_mpt(models, tmp_path):
    """The card by default. An ``mpt`` model type or model name takes the
    MPT route (since the MPT family was ported it no longer raises; the
    route itself is held in ``tests/test_torch_mpt.py``): on a directory of
    LLaMA weights it looks for the MPT decoder's and finds none."""
    cfg, _, sd = models["base"]
    path = write_dir(tmp_path / "m", {}, jax_config_json(cfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tbuilder.load_pretrained_model(path)
    with pytest.raises(KeyError, match="transformer.wte.weight"):
        tbuilder.load_pretrained_model(path, model_name="llava-mpt-7b", device="cpu")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "mpt", "d_model": 64}, f)
    with pytest.raises(KeyError, match="transformer.wte.weight"):
        tbuilder.load_pretrained_model(path, device="cpu")


def test_a_tokenizer_that_cannot_load_gives_none_as_in_jax(tmp_path):
    """ROADMAP C25: a LLaVA-1.5-style directory (``"tokenizer_class":
    "LlamaTokenizer"`` and a ``tokenizer.model``) on a machine without
    ``sentencepiece``: both loaders return tokenizer None and equal params;
    the port warns with the exception's type, before any weight is read."""
    try:
        import sentencepiece  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("sentencepiece imports here, so a LlamaTokenizer loads and the "
                    "failure this case holds cannot happen")
    from helpers import make_tiny_checkpoint

    path = make_tiny_checkpoint(str(tmp_path / "llava-1.5-style"))
    with open(os.path.join(path, "tokenizer_config.json")) as f:
        tok_cfg = json.load(f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(dict(tok_cfg, tokenizer_class="LlamaTokenizer"), f)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(b"not a sentencepiece model")
    jtok, jr, _, _ = jbuilder.load_pretrained_model(path, dtype=jnp.bfloat16)
    reads = []
    load = tconvert.load_state_dict_from_dir
    with pytest.MonkeyPatch.context() as mp, pytest.warns(UserWarning, match="ImportError"):
        mp.setattr(tconvert, "load_state_dict_from_dir",
                   lambda d: reads.append(d) or load(d))
        mp.setattr(tbuilder, "load_tokenizer", lambda d, f=tbuilder.load_tokenizer: (
            reads.append("tokenizer"), f(d))[1])
        ttok, tr, _, _ = tbuilder.load_pretrained_model(path, dtype=torch.bfloat16,
                                                        device="cpu")
    assert jtok is None and ttok is None
    assert reads == ["tokenizer", path]
    assert tr.cfg == port_config(jr.cfg)
    assert_trees_equal(tr.params, jr.params)


def test_weight_files_read_the_index_and_safetensors_need_their_package(models, tmp_path,
                                                                       monkeypatch):
    cfg, _, sd = models["base"]
    path = write_dir(tmp_path / "s", sd, jax_config_json(cfg), form="shards")
    # a file the index does not name (a trainer's pickle) is not read
    torch.save({"not": torch.zeros(1)}, os.path.join(path, "training_args.bin"))
    assert [os.path.basename(p) for p in tconvert.weight_files(path)] == [
        "pytorch_model-00001-of-00002.bin", "pytorch_model-00002-of-00002.bin"]
    st = write_dir(tmp_path / "st", {"a": np.ones(2, np.float32)}, {}, form="safetensors")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(ImportError, match="model.safetensors"):
        tconvert.load_state_dict_from_dir(st)


# ---------------------------------------------------------------------------
# Weight tools
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tool_dirs(tmp_path_factory):
    """Base and target checkpoints (the target's embedding grown by two
    rows), in fp32 and fp16, and a peft-style LoRA adapter directory."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(3)
    base = {"model.embed_tokens.weight": rng.normal(size=(10, 8)),
            "model.layers.0.self_attn.q_proj.weight": rng.normal(size=(8, 8)),
            "model.norm.weight": rng.normal(size=8)}
    target = {k: v + rng.normal(scale=0.1, size=v.shape) for k, v in base.items()}
    target["model.embed_tokens.weight"] = rng.normal(size=(12, 8))
    target["model.mm_projector.0.weight"] = rng.normal(size=(8, 4))
    dirs = {}
    for name, dt in (("fp32", torch.float32), ("fp16", torch.float16)):
        dirs[name] = (write_dir(root / f"base-{name}", base, {"a": 1}, dt),
                      write_dir(root / f"target-{name}", target, {"a": 1}, dt), dt)
    lora = {"base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight":
            rng.normal(size=(4, 8)),
            "base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight":
            rng.normal(size=(8, 4)),
            "base_model.model.model.mm_projector.0.weight": rng.normal(size=(8, 4))}
    lora_dir = write_dir(root / "lora", lora, {"a": 1})
    with open(os.path.join(lora_dir, "adapter_config.json"), "w") as f:
        json.dump({"lora_alpha": 8, "r": 4}, f)
    return root, dirs, lora_dir


def assert_dirs_match(port_dir, jax_dir, dtype):
    """The port tool's output equals the JAX tool's (fp32) rounded to the
    file's dtype."""
    p = tconvert.load_state_dict_from_dir(port_dir)
    j = tconvert.load_state_dict_from_dir(jax_dir)
    assert sorted(p) == sorted(j)
    for k in p:
        assert p[k].dtype == dtype, k
        assert torch.equal(p[k], j[k].to(dtype)), k


@pytest.mark.parametrize("file_dtype", ["fp32", "fp16"])
def test_apply_and_make_delta_match_jax(tool_dirs, file_dtype):
    root, dirs, _ = tool_dirs
    base, target, dt = dirs[file_dtype]
    out = root / file_dtype
    jtools.make_delta(base, target, str(out / "jax-delta"))
    ttools.make_delta(base, target, str(out / "port-delta"))
    assert_dirs_match(str(out / "port-delta"), str(out / "jax-delta"), dt)
    jtools.apply_delta(base, str(out / "jax-target"), str(out / "port-delta"))
    ttools.apply_delta(base, str(out / "port-target"), str(out / "port-delta"))
    assert_dirs_match(str(out / "port-target"), str(out / "jax-target"), dt)


def test_merge_lora_extract_and_consolidate_match_jax(tool_dirs):
    root, dirs, lora_dir = tool_dirs
    base = dirs["fp32"][0]
    jtools.merge_lora_dirs(lora_dir, base, str(root / "jax-merged"))
    ttools.merge_lora_dirs(lora_dir, base, str(root / "port-merged"))
    assert_dirs_match(str(root / "port-merged"), str(root / "jax-merged"), torch.float32)
    shards = write_dir(root / "shards", {k: v.numpy() for k, v in
                                         tconvert.load_state_dict_from_dir(base).items()},
                       {"a": 1}, form="shards")
    ttools.consolidate(shards, str(root / "one"))
    assert_dirs_match(str(root / "one"), base, torch.float32)
    jtools.extract_mm_projector(dirs["fp32"][1], str(root / "jax-proj.bin"))
    ttools.extract_mm_projector(dirs["fp32"][1], str(root / "port-proj.bin"))
    j = torch.load(str(root / "jax-proj.bin"))
    p = torch.load(str(root / "port-proj.bin"))
    assert sorted(p) == sorted(j) == ["model.mm_projector.0.weight"]
    assert all(torch.equal(p[k], j[k]) for k in p)


# ---------------------------------------------------------------------------
# Vision tokenizer growth
# ---------------------------------------------------------------------------


class GrowingTokenizer(WordTokenizer):
    def add_tokens(self, tokens, special_tokens=False):
        new = [t for t in tokens if t not in self.vocab]
        for t in new:
            self._id(t)
        return len(new)


@pytest.mark.parametrize("variant", ["base", "tied"])
def test_initialize_vision_tokenizer_matches_jax(models, variant):
    cfg, params, _ = models[variant]
    jt, tt = GrowingTokenizer(), GrowingTokenizer()
    jp, jcfg, jn = jtok.initialize_vision_tokenizer(
        jax.tree.map(jnp.asarray, params), cfg.text, jt, True, True)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    tp, tcfg, tn = ttok.initialize_vision_tokenizer(tparams, port_config(cfg.text), tt, True,
                                                    True)
    assert (tn, tcfg, tt.vocab) == (jn, port_config(jcfg), jt.vocab) and tn == 3
    for name, dim in (("embed", 0), ("lm_head", 1)):
        if name not in tp["llm"]:
            assert name not in jp["llm"]
            continue
        t, j = tp["llm"][name], np.asarray(jp["llm"][name])
        n = params["llm"][name].shape[dim]
        old = t.narrow(dim, 0, n)
        assert torch.equal(old, torch.from_numpy(j).narrow(dim, 0, n))
        assert old is not tparams["llm"][name] and torch.equal(tparams["llm"][name], old)
        # the new entries are an fp32 mean: the two packages sum in other
        # orders, so they agree within the sum's rounding bound, n * eps * mean|x|
        new, jnew = t.narrow(dim, n, 3), torch.from_numpy(j).narrow(dim, n, 3)
        bound = n * torch.finfo(torch.float32).eps * old.abs().mean(dim=dim, keepdim=True)
        assert bool(((new - jnew).abs() <= bound).all())
        assert torch.equal(new, new.narrow(dim, 0, 1).expand_as(new))
