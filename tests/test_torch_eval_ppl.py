"""The port's generation-quality probes against the JAX package's.

``run_llava_for_ppl``, ``model_vqa_science_for_ppl``,
``model_lvis_for_ppl`` (sparse and dense), ``model_lvis_for_meteor``,
``model_lvis_multi_round`` (``--mode ppl`` and ``meteor``) and
``visualize`` on one tiny HF-style checkpoint (``helpers.make_tiny_checkpoint``),
loaded once a package in fp32 on the CPU. The JAX tools run once, in a
module fixture, through their ``main`` with the JAX loader patched to hand
them the fp32 load; the port's take it through ``loaded=``. Greedy tokens,
texts and cache lengths are exact; ``ppl`` / ``self_ppl`` within
``PPL_RTOL`` relative; ``meteor`` is None in both (no ``nltk``); the
visualizer's keep grid and masked image are equal. Memory fields: the
model's bytes equal the JAX ``tree_bytes``; the others are each package's
own accounting (present, finite).

The multi-round tool refuses rounds past its cache's room before it runs
anything, where the JAX tool writes on past its capacity (ROADMAP).
"""

import json
import math

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp
import torch

from dynamic_llava_tpu.eval import bench as jbench
from dynamic_llava_tpu.eval import model_lvis_for_meteor as jmeteor
from dynamic_llava_tpu.eval import model_lvis_for_ppl as jlvis
from dynamic_llava_tpu.eval import model_lvis_multi_round as jmulti
from dynamic_llava_tpu.eval import model_vqa_science_for_ppl as jsci
from dynamic_llava_tpu.eval import run_llava_for_ppl as jrun
from dynamic_llava_tpu.eval import visualize as jvis
from dynamic_llava_tpu.models import builder as jbuilder
from dynamic_llava_tpu_torch.eval import bench as tbench
from dynamic_llava_tpu_torch.eval import model_lvis_for_meteor as tmeteor
from dynamic_llava_tpu_torch.eval import model_lvis_for_ppl as tlvis
from dynamic_llava_tpu_torch.eval import model_lvis_multi_round as tmulti
from dynamic_llava_tpu_torch.eval import model_vqa_science_for_ppl as tsci
from dynamic_llava_tpu_torch.eval import run_llava_for_ppl as trun
from dynamic_llava_tpu_torch.eval import visualize as tvis
from dynamic_llava_tpu_torch.models.builder import LlavaRuntime, load_pretrained_model

from helpers import make_tiny_checkpoint

PPL_RTOL = 1e-4
# one question throughout and answers of 4-60 tokens: one prompt shape and one
# pair of cache capacities (128, 128 at the tiny size: gen_cache_sizes of 8-64
# new tokens, bucket 64), so the JAX tools compile their programs once
MAX_NEW = 8
QUESTION = "What is in the image ?"
ANSWERS = ["The picture shows a red cat . It is red and small .", "yes no yes no",
           "A dog . hello"]
LVIS = [{"question_id": i, "image": f"x{i}.png", "text": QUESTION, "answer": a}
        for i, a in enumerate(ANSWERS)]
MULTI = [{"question_id": 0, "image": "x0.png", "rounds": [
    {"text": QUESTION, "answer": "The picture shows a red cat ."},
    {"text": "What color ?", "answer": "It is red ."},
    {"text": "Is there a dog ?", "answer": "no"}]},
    {"question_id": 1, "image": "x1.png", "text": QUESTION, "answer": "hello world"}]
# the tools' memory fields: each package's own accounting
MEMORY = {"live_bytes_gb", "model_bytes_gb", "non_model_live_gb", "peak_est_gb"}


def jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("ppl")
    ckpt = make_tiny_checkpoint(str(root / "ckpt"))
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(48, 72), (64, 40), (56, 56)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            str(images / f"x{i}.png"))
    files = {
        "sqa": root / "sqa.json",
        "lvis": jsonl(root / "lvis.jsonl", LVIS),
        "multi": jsonl(root / "multi.jsonl", MULTI),
    }
    files["sqa"].write_text(json.dumps([
        {"id": "s0", "image": "x0.png", "conversations": [{"value": "<image>\nDescribe."}]},
        {"id": "s1", "conversations": [{"value": "Describe."}]},  # no image: skipped
        {"id": "s2", "image": "x2.png", "conversations": [{"value": "<image>\nDescribe."}]},
    ]))
    files["sqa"] = str(files["sqa"])
    jloaded = jbuilder.load_pretrained_model(ckpt, dtype=jnp.float32)
    jtok, jrt, jproc, jctx = jloaded
    jdense = (jtok, jrt._replace(cfg=jbench.dense_config(jrt.cfg)), jproc, jctx)
    argvs = {
        "run": ["--image-file", str(images / "x0.png"), "--query", QUESTION,
                "--conv-mode", "vicuna_v1", "--max_new_tokens", str(MAX_NEW)],
        "sqa": ["--image-folder", str(images), "--question-file", files["sqa"],
                "--conv-mode", "vicuna_v1", "--temperature", "0",
                "--max_new_tokens", str(MAX_NEW)],
        "lvis": ["--image-folder", str(images), "--question-file", files["lvis"]],
        "meteor": ["--image-folder", str(images), "--question-file", files["lvis"],
                   "--max_new_tokens", str(MAX_NEW)],
        "multi-ppl": ["--image-folder", str(images), "--question-file", files["multi"],
                      "--mode", "ppl", "--max_new_tokens", "8"],
        "multi-meteor": ["--image-folder", str(images), "--question-file", files["multi"],
                         "--mode", "meteor", "--max_new_tokens", "8"],
        "vis": ["--image-file", str(images / "x2.png")],
    }
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        current = {"loaded": jloaded}
        mp.setattr(jbuilder, "load_pretrained_model", lambda *a, **k: current["loaded"])
        common = ["--model-path", ckpt]
        want["run"] = jrun.eval_model(jrun_args(ckpt, argvs["run"]))
        for name, mod in (("sqa", jsci), ("lvis", jlvis), ("meteor", jmeteor),
                          ("multi-ppl", jmulti), ("multi-meteor", jmulti)):
            path = str(root / f"jax-{name}.jsonl")
            mod.main(common + ["--answers-file", path] + argvs[name])
            want[name] = read(path)
        current["loaded"] = jdense
        path = str(root / "jax-lvis-dense.jsonl")
        jlvis.main(common + ["--answers-file", path] + argvs["lvis"])
        want["lvis-dense"] = read(path)
        current["loaded"] = jloaded
        out = str(root / "jax-vis.png")
        jvis.main(common + argvs["vis"] + ["--output", out])
        want["vis"] = np.asarray(Image.open(out))
    tloaded = load_pretrained_model(ckpt, dtype=torch.float32, device="cpu")
    return dict(root=root, ckpt=ckpt, images=images, argvs=argvs, want=want,
                jloaded=jloaded, loaded=tloaded)


def jrun_args(ckpt, argv):
    """The JAX ``run_llava_for_ppl`` parses inside ``main`` and returns
    nothing: its namespace, for ``eval_model``."""
    import argparse

    p = argparse.ArgumentParser()
    for flag in ("--image-file", "--query", "--conv-mode", "--max_new_tokens"):
        p.add_argument(flag)
    a = p.parse_args(argv)
    return argparse.Namespace(model_path=ckpt, model_base=None, image_file=a.image_file,
                              query=a.query, conv_mode=a.conv_mode, sep=",",
                              temperature=0.0, max_new_tokens=int(a.max_new_tokens))


def port_args(setup, mod, name, *extra, answers=True):
    argv = ["--model-path", setup["ckpt"]] + setup["argvs"][name] + ["--device", "cpu"]
    path = str(setup["root"] / f"port-{name}.jsonl")
    if answers:
        argv += ["--answers-file", path]
    return mod.parser().parse_args(argv + list(extra)), path


def close(got, want):
    return math.isclose(float(got), float(want), rel_tol=PPL_RTOL)


def test_run_llava_for_ppl_matches_jax(setup, capsys):
    args, _ = port_args(setup, trun, "run", answers=False)
    got = trun.eval_model(args, loaded=setup["loaded"])
    want = setup["want"]["run"]
    assert got["tokens"] == want["tokens"] and got["text"] == want["text"]
    assert got["answer_token_len"] == want["answer_token_len"] == len(got["tokens"]) > 0
    assert close(got["self_ppl"], want["self_ppl"]) and got["self_ppl"] >= 1.0
    assert "mean perplexity" in capsys.readouterr().out


def test_model_vqa_science_for_ppl_matches_jax(setup):
    args, path = port_args(setup, tsci, "sqa")
    mean = tsci.eval_model(args, loaded=setup["loaded"])
    got, want = read(path), setup["want"]["sqa"]
    assert len(got) == len(want) == 3  # two images (s1 skipped) and the summary
    for g, w in zip(got[:-1], want[:-1]):
        assert close(g.pop("self_ppl"), w.pop("self_ppl"))
        g.pop("answer_id"), w.pop("answer_id")
        assert g == w
    assert close(got[-1]["mean_self_ppl"], want[-1]["mean_self_ppl"])
    assert close(mean, want[-1]["mean_self_ppl"])
    assert got[-1]["mean_gpt4o_ppl"] == want[-1]["mean_gpt4o_ppl"] == "0.0"


def check_lvis_records(got, want, params):
    from dynamic_llava_tpu.profiling import tree_bytes as jtree_bytes

    assert len(got) == len(want) == len(LVIS)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert close(g["ppl"], w["ppl"]) and g["ppl"] > 1.0
        for k in MEMORY:
            assert math.isfinite(g[k]) and (k == "non_model_live_gb" or g[k] > 0), k
        assert g["model_bytes_gb"] == w["model_bytes_gb"] == round(
            jtree_bytes(params) / 2**30, 4)
        assert g["peak_est_gb"] >= g["live_bytes_gb"]
        assert ({k: v for k, v in g.items() if k not in MEMORY | {"ppl"}}
                == {k: v for k, v in w.items() if k not in MEMORY | {"ppl"}})
        assert 0 <= g["output_cache_length"] <= g["output_token_length"]
        assert g["output_full_length"] == g["output_token_length"]


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_model_lvis_for_ppl_matches_jax(setup, mode):
    tok, rt, proc, ctx = setup["loaded"]
    loaded = setup["loaded"] if mode == "sparse" else (
        tok, LlavaRuntime(rt.params, tbench.dense_config(rt.cfg)), proc, ctx)
    args, path = port_args(setup, tlvis, "lvis")
    records = tlvis.eval_model(args, loaded=loaded)
    got = read(path)
    assert got == json.loads(json.dumps(records))
    want = setup["want"]["lvis" if mode == "sparse" else "lvis-dense"]
    check_lvis_records(got, want, setup["jloaded"][1].params)
    n_img = rt.cfg.num_image_tokens
    pruned = n_img - rt.cfg.sparse.vision_keep_budget(n_img)
    for g in got:  # the vision prune: the post tier holds the kept image tokens
        assert g["prefill_cache_length"] == g["prefill_full_length"] - (
            pruned if mode == "sparse" else 0)


def test_model_lvis_for_meteor_matches_jax(setup):
    args, path = port_args(setup, tmeteor, "meteor")
    tmeteor.eval_model(args, loaded=setup["loaded"])
    got, want = read(path), setup["want"]["meteor"]
    assert got == want and len(got) == len(LVIS)
    assert all(0 <= r["output_token_length"] <= MAX_NEW for r in got)


@pytest.mark.parametrize("pred,ref", [("a red cat", "a cat"), ("", "a cat"), ("dog", "")])
def test_try_meteor_matches_jax(pred, ref):
    # None where nltk or its wordnet data is absent, as on both machines here
    assert tmeteor.try_meteor(pred, ref) == jmeteor.try_meteor(pred, ref)


@pytest.mark.parametrize("mode", ["ppl", "meteor"])
def test_model_lvis_multi_round_matches_jax(setup, mode):
    args, path = port_args(setup, tmulti, f"multi-{mode}")
    tmulti.eval_model(args, loaded=setup["loaded"])
    got, want = read(path), setup["want"][f"multi-{mode}"]
    assert [len(g["rounds"]) for g in got] == [len(w["rounds"]) for w in want] == [3, 1]
    for g, w in zip(got, want):
        assert g["question_id"] == w["question_id"]
        for gr, wr in zip(g["rounds"], w["rounds"]):
            if mode == "ppl":
                assert close(gr.pop("ppl"), wr.pop("ppl"))
            assert gr == wr
    rounds = got[0]["rounds"]
    # the continuation grows the live cache round by round
    assert rounds[0]["pre_cache_length"] < rounds[1]["pre_cache_length"] < rounds[2][
        "pre_cache_length"]
    assert rounds[0]["post_cache_length"] <= rounds[1]["post_cache_length"]


def test_multi_round_refuses_rounds_past_the_cache_room(setup):
    """Teacher-forced answers past ``(rounds + 1) * max_new_tokens``: the
    port refuses before anything runs; the JAX tool runs on, its pre tier's
    length past the tier's capacity (its writes clamp into the last slot)."""
    tok, rt, proc, _ = setup["loaded"]
    jtok, jrt, jproc, _ = setup["jloaded"]
    image = Image.open(setup["images"] / "x0.png").convert("RGB")
    long = " ".join(["the red cat"] * 40)
    rounds = [{"text": "What is in the image ?", "answer": long},
              {"text": "What color ?", "answer": "red"}]
    from dynamic_llava_tpu.mm_utils import process_images as jprocess
    from dynamic_llava_tpu_torch.mm_utils import process_images

    with pytest.raises(ValueError, match="cache slots past the prompt"):
        tmulti.run_rounds(rt, tok, rounds, process_images([image], proc, rt.cfg),
                          "vicuna_v1", 8, teacher_forced=True)
    recs = jmulti.run_rounds(jrt, jtok, rounds, jprocess([image], jproc, jrt.cfg),
                             "vicuna_v1", 8, teacher_forced=True)
    n_prompt = 56  # the tiny checkpoint's fused prompt (16 image tokens)
    capacity = -(-(n_prompt + 3 * 8 + 8) // 64) * 64  # gen_cache_sizes, bucket 64
    assert recs[0]["pre_cache_length"] > capacity


def test_visualize_matches_jax(setup):
    out = str(setup["root"] / "port-vis.png")
    args = tvis.parser().parse_args(["--model-path", setup["ckpt"]] + setup["argvs"]["vis"]
                                    + ["--output", out, "--device", "cpu"])
    grid, masked = tvis.visualize(args, loaded=setup["loaded"])
    want = setup["want"]["vis"]
    assert np.array_equal(masked, want)
    assert np.array_equal(np.asarray(Image.open(out)), want)
    side = setup["loaded"][1].cfg.vision.num_patches_per_side
    assert grid.shape == (side, side) and 0 < grid.sum() < grid.size
    # the dropped patches are black, the kept ones not all
    p = setup["loaded"][1].cfg.vision.patch_size
    r, c = np.argwhere(~grid)[0]
    assert not masked[r * p:(r + 1) * p, c * p:(c + 1) * p].any()


def test_keep_mask_to_grid_and_apply_patch_mask_match_jax():
    from dynamic_llava_tpu.multimodal.fusion import plan_batch as jplan
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    rng = np.random.default_rng(3)
    ids = [np.concatenate([rng.integers(3, 50, 2 + i), [-200], rng.integers(3, 50, 3)])
           for i in range(2)]
    tplan, jp = plan_batch(ids, 9), jplan(ids, 9)
    mask = rng.random((2, tplan.seq_len)) > 0.5

    class Info:
        image_keep_mask = torch.from_numpy(mask)

    class JInfo:
        image_keep_mask = jnp.asarray(mask)

    grids = tvis.keep_mask_to_grid(Info, tplan, 3)
    assert np.array_equal(grids, jvis.keep_mask_to_grid(JInfo, jp, 3))
    assert grids.shape == (2, 3, 3)
    image = rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
    assert np.array_equal(tvis.apply_patch_mask(image, grids[1], 4),
                          jvis.apply_patch_mask(image, grids[1], 4))


@pytest.mark.parametrize("name", ["run_llava_for_ppl", "model_vqa_science_for_ppl",
                                  "model_lvis_for_ppl", "model_lvis_for_meteor",
                                  "model_lvis_multi_round", "visualize"])
def test_entry_points_default_to_the_card(setup, name, tmp_path):
    """Without ``--device`` an entry point asks for the card, and with no
    card it raises before it loads anything; ``--device cpu`` is the CPU."""
    import importlib

    mod = importlib.import_module(f"dynamic_llava_tpu_torch.eval.{name}")
    key = {"run_llava_for_ppl": "run", "model_vqa_science_for_ppl": "sqa",
           "model_lvis_for_ppl": "lvis", "model_lvis_for_meteor": "meteor",
           "model_lvis_multi_round": "multi-ppl", "visualize": "vis"}[name]
    argv = ["--model-path", setup["ckpt"]] + setup["argvs"][key]
    if name != "run_llava_for_ppl":
        argv += ["--output" if name == "visualize" else "--answers-file",
                 str(tmp_path / "out")]
    assert mod.parser().parse_args(argv).device is None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main(argv)
