#!/bin/bash
# POPE: generation + scoring (the PyTorch / CUDA twin of
# run/dynamic_eval/eval_for_pope.sh).
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
python -m dynamic_llava_tpu_torch.eval.model_vqa_loader \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --question-file ./playground/data/eval/pope/llava_pope_test.jsonl \
    --image-folder ./playground/data/eval/pope/val2014 \
    --answers-file ./playground/data/eval/pope/answers/dynamic-llava.jsonl \
    --temperature 0 --conv-mode vicuna_v1
python -m dynamic_llava_tpu_torch.eval.eval_pope \
    --annotation-dir ./playground/data/eval/pope/coco \
    --question-file ./playground/data/eval/pope/llava_pope_test.jsonl \
    --result-file ./playground/data/eval/pope/answers/dynamic-llava.jsonl
