#!/bin/bash
# Q-Bench LLVisionQA (the PyTorch / CUDA twin of run/dynamic_eval/eval_for_qbench.sh).
# Usage: eval_for_qbench.sh [dev|test]
SPLIT=${1:-dev}
if [ "$SPLIT" != "dev" ] && [ "$SPLIT" != "test" ]; then
    echo "Unknown split, please choose between 'dev' and 'test'."
    exit 1
fi
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
python -m dynamic_llava_tpu_torch.eval.model_vqa_qbench \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --image-folder ./playground/data/eval/qbench/images_llvisionqa/ \
    --questions-file ./playground/data/eval/qbench/llvisionqa_$SPLIT.json \
    --answers-file ./playground/data/eval/qbench/llvisionqa_${SPLIT}_answers.jsonl \
    --conv-mode llava_v1 --lang en
