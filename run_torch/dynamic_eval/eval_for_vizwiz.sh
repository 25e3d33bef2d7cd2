#!/bin/bash
# VizWiz: generation + submission converter
# (the PyTorch / CUDA twin of run/dynamic_eval/eval_for_vizwiz.sh).
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
python -m dynamic_llava_tpu_torch.eval.model_vqa_loader \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --question-file ./playground/data/eval/vizwiz/llava_test.jsonl \
    --image-folder ./playground/data/eval/vizwiz/test \
    --answers-file ./playground/data/eval/vizwiz/answers/dynamic-llava.jsonl \
    --temperature 0 --conv-mode vicuna_v1
python -m dynamic_llava_tpu_torch.eval.convert_vizwiz_for_submission \
    --annotation-file ./playground/data/eval/vizwiz/llava_test.jsonl \
    --result-file ./playground/data/eval/vizwiz/answers/dynamic-llava.jsonl \
    --result-upload-file ./playground/data/eval/vizwiz/answers_upload/dynamic-llava.json
