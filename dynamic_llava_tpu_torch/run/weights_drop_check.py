"""Weights-drop golden on the port: HF checkpoint dir -> eval answers -> GQA
scores, ported from the repo's ``run/weights_drop_check.py``.

One command proving the whole evaluation chain on a checkpoint directory:
builder load (safetensors or .bin), chunked ``model_vqa_loader``
generation, JSONL merge, ``convert_gqa_for_eval`` format conversion, and
exact-match scoring in the GQA prediction format. With no --model-path it
builds a tiny HF fixture checkpoint (a real fast tokenizer, both
predictors; ``make_tiny_checkpoint``) and a 4-question GQA-format set, so
the golden runs hermetically; pointing --model-path at a downloaded
Dynamic-LLaVA / LLaVA-1.5 directory runs the identical chain at scale.

    python -m dynamic_llava_tpu_torch.run.weights_drop_check --device cpu   # hermetic golden
    python -m dynamic_llava_tpu_torch.run.weights_drop_check --model-path $CKPT \\
        --question-file my_gqa.jsonl --image-folder imgs/                    # on the card

Prints one JSON line: {"questions", "answered", "format_ok", "accuracy",
"predictions"}. Exit code 0 iff every question was answered and the
converted predictions parse in GQA format.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def make_tiny_checkpoint(out_dir: str) -> str:
    """Write a reference-style HF checkpoint dir with a real fast tokenizer
    and both predictors (the fixture of the CLI-level tests; the same files
    as the test suite's ``helpers.make_tiny_checkpoint``). The weights come
    from ``torch.manual_seed(0)`` inside a forked RNG state, so the caller's
    global generator is left as it was."""
    import torch
    import torch.nn as nn
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from tokenizers.processors import TemplateProcessing

    os.makedirs(out_dir, exist_ok=True)
    tok = Tokenizer(models.WordLevel(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    corpus = [
        "A chat between a curious human and an artificial intelligence "
        "assistant . The assistant gives helpful , detailed , and polite "
        "answers to the human ' s questions . USER : ASSISTANT : What is in "
        "the image ? Is there a dog ? yes no The picture shows a red cat . "
        "hello world describe briefly"
    ] * 5
    trainer = trainers.WordLevelTrainer(special_tokens=["<unk>", "<s>", "</s>"])
    tok.train_from_iterator(corpus, trainer)
    tok.post_processor = TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", tok.token_to_id("<s>"))])
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>", "model_max_length": 512}, f)
    vocab_size = max(tok.get_vocab_size(), 64)

    from transformers import CLIPVisionConfig as HFC
    from transformers import CLIPVisionModel
    from transformers import LlamaConfig as HFL
    from transformers import LlamaForCausalLM

    hidden, d_model = 64, 32
    sd = {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        lm = LlamaForCausalLM(HFL(
            vocab_size=vocab_size, hidden_size=hidden, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        ))
        sd.update(lm.state_dict())
        tower = CLIPVisionModel(HFC(
            hidden_size=24, intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=2, image_size=56, patch_size=14,
        ))
        for k, v in tower.state_dict().items():
            sd[f"model.vision_tower.vision_tower.{k}"] = v
        proj = nn.Sequential(nn.Linear(24, hidden), nn.GELU(), nn.Linear(hidden, hidden))
        for k, v in proj.state_dict().items():
            sd[f"model.mm_projector.{k}"] = v
        out_mlp = nn.Sequential(
            nn.LayerNorm(hidden), nn.Linear(hidden, d_model), nn.GELU(),
            nn.Linear(d_model, d_model // 2), nn.GELU(),
            nn.Linear(d_model // 2, d_model // 4), nn.GELU(),
            nn.Linear(d_model // 4, 2),
        )
        for k, v in out_mlp.state_dict().items():
            sd[f"model.output_text_score_predictor.output_mlp.{k}"] = v
        vp_down = nn.Sequential(nn.LayerNorm(hidden), nn.Linear(hidden, d_model), nn.GELU())
        for k, v in vp_down.state_dict().items():
            sd[f"model.image_score_predictor.down_mlp.{k}"] = v

        class Blk(nn.Module):
            def __init__(self):
                super().__init__()
                self.norm1 = nn.LayerNorm(d_model)
                self.attn = nn.Module()
                self.attn.qkv = nn.Linear(d_model, d_model * 3, bias=False)
                self.attn.proj = nn.Linear(d_model, d_model)
                self.norm2 = nn.LayerNorm(d_model)
                self.mlp = nn.Module()
                self.mlp.fc1 = nn.Linear(d_model, 64)
                self.mlp.fc2 = nn.Linear(64, d_model)

        for k, v in Blk().state_dict().items():
            sd[f"model.image_score_predictor.transformer.0.{k}"] = v
        vp_out = nn.Sequential(
            nn.Linear(d_model, d_model // 2), nn.GELU(),
            nn.Linear(d_model // 2, d_model // 4), nn.GELU(),
            nn.Linear(d_model // 4, 2),
        )
        for k, v in vp_out.state_dict().items():
            sd[f"model.image_score_predictor.output_mlp.{k}"] = v
    torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))

    config = {
        "model_type": "dynamic_llava_llama",
        "vocab_size": vocab_size, "hidden_size": hidden,
        "intermediate_size": 96, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "mm_projector_type": "mlp2x_gelu",
        "mm_vision_tower": "tiny-clip",
        "mm_vision_select_layer": -2, "image_aspect_ratio": "pad",
        "model_max_length": 512,
        "sparse_config": {
            "use_vision_predictor": True, "vision_keep_rate": 0.25,
            "use_text_predictor": True,
            "use_output_text_predictor": True, "output_text_keep_rate": 0.5,
            "use_instruct_predictor": False, "sparse_layer": 1,
            "d_model": d_model, "nhead": 2, "dim_feedforward": 64,
            "num_layers": 1, "mask_loss_weight": 100.0,
        },
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f)
    return out_dir


def build_fixture(work: str):
    """Tiny HF checkpoint + 4-question GQA-format set with known answers."""
    import numpy as np
    from PIL import Image

    ckpt = make_tiny_checkpoint(os.path.join(work, "ckpt"))
    img_dir = os.path.join(work, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    qfile = os.path.join(work, "questions.jsonl")
    answers = {}
    with open(qfile, "w") as f:
        for i in range(4):
            name = f"im{i}.png"
            Image.fromarray(
                rng.integers(0, 255, (48, 48, 3)).astype("uint8")
            ).save(os.path.join(img_dir, name))
            qid = f"q{i}"
            f.write(json.dumps({
                "question_id": qid, "image": name,
                "text": "Is there a dog ?" if i % 2 else "What is in the image ?",
            }) + "\n")
            answers[qid] = "no" if i % 2 else "cat"
    with open(os.path.join(work, "golden_answers.json"), "w") as f:
        json.dump(answers, f)
    return ckpt, qfile, img_dir, answers


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", default=None,
                    help="HF checkpoint dir; default builds the tiny fixture")
    ap.add_argument("--question-file", default=None)
    ap.add_argument("--image-folder", default=None)
    ap.add_argument("--answers-json", default=None,
                    help="optional {question_id: answer} for accuracy")
    ap.add_argument("--work-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "weights_drop_check"))
    ap.add_argument("--chunks", type=int, default=2,
                    help="exercise the chunk/merge protocol with N chunks")
    ap.add_argument("--conv-mode", default="vicuna_v1")
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return ap


def run(argv=None):
    """The chain for ``argv``. Returns ``(result, chunk_seconds)``: the JSON
    line's dict and each chunk's generation seconds (its load included)."""
    from ..eval import convert_gqa_for_eval, model_vqa_loader

    args = parser().parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    gold = None
    if args.model_path is None:
        ckpt, qfile, img_dir, gold = build_fixture(args.work_dir)
    else:
        ckpt, qfile, img_dir = args.model_path, args.question_file, args.image_folder
        if args.answers_json:
            with open(args.answers_json) as f:
                gold = json.load(f)

    # chunked generation + merge: the per-process protocol of
    # run_torch/dynamic_eval/eval_for_gqa.sh, in-process
    chunk_files, chunk_s = [], []
    for idx in range(args.chunks):
        out = os.path.join(args.work_dir, f"chunk{idx}.jsonl")
        chunk_files.append(out)
        t0 = time.perf_counter()
        model_vqa_loader.main([
            "--model-path", ckpt,
            "--question-file", qfile,
            "--image-folder", img_dir,
            "--answers-file", out,
            "--num-chunks", str(args.chunks), "--chunk-idx", str(idx),
            "--temperature", "0",
            "--conv-mode", args.conv_mode,
            "--max_new_tokens", str(args.max_new_tokens),
            "--device", args.device,
        ])
        chunk_s.append(time.perf_counter() - t0)
    merged = os.path.join(args.work_dir, "merge.jsonl")
    with open(merged, "w") as out_f:
        for cf in chunk_files:
            with open(cf) as in_f:
                out_f.write(in_f.read())

    preds_path = os.path.join(args.work_dir, "testdev_balanced_predictions.json")
    convert_gqa_for_eval.main(["--src", merged, "--dst", preds_path])

    with open(preds_path) as f:
        preds = json.load(f)
    with open(qfile) as f:
        n_questions = sum(1 for _ in f)
    format_ok = (isinstance(preds, list)
                 and all(set(p) == {"questionId", "prediction"} for p in preds))
    answered = len(preds)
    accuracy = None
    if gold:
        by_id = {p["questionId"]: p["prediction"] for p in preds}
        hits = sum(1 for qid, ans in gold.items() if ans.lower() in by_id.get(qid, ""))
        accuracy = round(100.0 * hits / len(gold), 2)
    return {
        "questions": n_questions,
        "answered": answered,
        "format_ok": format_ok,
        "accuracy": accuracy,
        "predictions": preds_path,
    }, chunk_s


def main(argv=None):
    result, _ = run(argv)
    print(json.dumps(result))
    ok = result["format_ok"] and result["answered"] == result["questions"]
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
