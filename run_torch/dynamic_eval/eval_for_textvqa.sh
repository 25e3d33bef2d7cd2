#!/bin/bash
# TextVQA: generation + scoring (the PyTorch / CUDA twin of
# run/dynamic_eval/eval_for_textvqa.sh).
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
python -m dynamic_llava_tpu_torch.eval.model_vqa_loader \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --question-file ./playground/data/eval/textvqa/llava_textvqa_val_v051_ocr.jsonl \
    --image-folder ./playground/data/eval/textvqa/train_images \
    --answers-file ./playground/data/eval/textvqa/answers/dynamic-llava.jsonl \
    --temperature 0 --conv-mode vicuna_v1
python -m dynamic_llava_tpu_torch.eval.eval_textvqa \
    --annotation-file ./playground/data/eval/textvqa/TextVQA_0.5.1_val.json \
    --result-file ./playground/data/eval/textvqa/answers/dynamic-llava.jsonl
