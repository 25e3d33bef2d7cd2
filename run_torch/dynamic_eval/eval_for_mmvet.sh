#!/bin/bash
# MM-Vet: generation + eval-format conversion
# (the PyTorch / CUDA twin of run/dynamic_eval/eval_for_mmvet.sh).
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
python -m dynamic_llava_tpu_torch.eval.model_vqa \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --question-file ./playground/data/eval/mm-vet/llava-mm-vet.jsonl \
    --image-folder ./playground/data/eval/mm-vet/images \
    --answers-file ./playground/data/eval/mm-vet/answers/dynamic-llava.jsonl \
    --temperature 0 --conv-mode vicuna_v1
mkdir -p ./playground/data/eval/mm-vet/results
python -m dynamic_llava_tpu_torch.eval.convert_mmvet_for_eval \
    --src ./playground/data/eval/mm-vet/answers/dynamic-llava.jsonl \
    --dst ./playground/data/eval/mm-vet/results/dynamic-llava.json
