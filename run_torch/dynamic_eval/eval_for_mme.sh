#!/bin/bash
# MME: generate answers, then self-contained conversion + scoring in eval_mme
# (the PyTorch / CUDA twin of run/dynamic_eval/eval_for_mme.sh).
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
python -m dynamic_llava_tpu_torch.eval.model_vqa_loader \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --question-file ./playground/data/eval/MME/llava_mme.jsonl \
    --image-folder ./playground/data/eval/MME/MME_Benchmark_release_version \
    --answers-file ./playground/data/eval/MME/answers/dynamic-llava.jsonl \
    --temperature 0 --conv-mode vicuna_v1
python -m dynamic_llava_tpu_torch.eval.eval_mme \
    --question-file ./playground/data/eval/MME/llava_mme.jsonl \
    --result-file ./playground/data/eval/MME/answers/dynamic-llava.jsonl \
    --mme-dir ./playground/data/eval/MME/MME_Benchmark_release_version \
    --output-file ./playground/data/eval/MME/answers/dynamic-llava-scores.json
