#!/bin/bash
# Q-Bench LLVisionQA, Chinese (the PyTorch / CUDA twin of
# run/dynamic_eval/eval_for_qbench_zh.sh).
# Usage: eval_for_qbench_zh.sh [dev|test]
SPLIT=${1:-dev}
if [ "$SPLIT" = "dev" ]; then
    ZH_SPLIT="验证集"
elif [ "$SPLIT" = "test" ]; then
    ZH_SPLIT="测试集"
else
    echo "Unknown split, please choose between 'dev' and 'test'."
    exit 1
fi
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
python -m dynamic_llava_tpu_torch.eval.model_vqa_qbench \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --image-folder ./playground/data/eval/qbench/images_llvisionqa/ \
    --questions-file "./playground/data/eval/qbench/质衡-问答-$ZH_SPLIT.json" \
    --answers-file ./playground/data/eval/qbench/llvisionqa_zh_${SPLIT}_answers.jsonl \
    --conv-mode llava_v1 --lang zh
