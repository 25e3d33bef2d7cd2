#!/bin/bash
# ScienceQA: generation + scoring (the PyTorch / CUDA twin of
# run/dynamic_eval/eval_for_sqa.sh).
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
python -m dynamic_llava_tpu_torch.eval.model_vqa_science \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --question-file ./playground/data/eval/scienceqa/llava_test_CQM-A.json \
    --image-folder ./playground/data/eval/scienceqa/images/test \
    --answers-file ./playground/data/eval/scienceqa/answers/dynamic-llava.jsonl \
    --single-pred-prompt --temperature 0 --conv-mode vicuna_v1
python -m dynamic_llava_tpu_torch.eval.eval_science_qa \
    --base-dir ./playground/data/eval/scienceqa \
    --result-file ./playground/data/eval/scienceqa/answers/dynamic-llava.jsonl \
    --output-file ./playground/data/eval/scienceqa/answers/dynamic-llava_output.jsonl \
    --output-result ./playground/data/eval/scienceqa/answers/dynamic-llava_result.json
