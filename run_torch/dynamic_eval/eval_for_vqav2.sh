#!/bin/bash
# VQAv2 test-dev: chunked generation + merge + submission converter (the
# PyTorch / CUDA twin of run/dynamic_eval/eval_for_vqav2.sh). The
# generators run on DEVICE (default cuda); the chunks share it.
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
SPLIT="llava_vqav2_mscoco_test-dev2015"
CHUNKS=${CHUNKS:-1}
for IDX in $(seq 0 $((CHUNKS-1))); do
    python -m dynamic_llava_tpu_torch.eval.model_vqa_loader \
        --device ${DEVICE:-cuda} \
        --model-path "$CKPT" \
        --question-file ./playground/data/eval/vqav2/$SPLIT.jsonl \
        --image-folder ./playground/data/eval/vqav2/test2015 \
        --answers-file ./playground/data/eval/vqav2/answers/$SPLIT/chunk${IDX}.jsonl \
        --num-chunks $CHUNKS --chunk-idx $IDX \
        --temperature 0 --conv-mode vicuna_v1 &
done
wait
output_file=./playground/data/eval/vqav2/answers/$SPLIT/merge.jsonl
> "$output_file"
for IDX in $(seq 0 $((CHUNKS-1))); do
    cat ./playground/data/eval/vqav2/answers/$SPLIT/chunk${IDX}.jsonl >> "$output_file"
done
python -m dynamic_llava_tpu_torch.eval.convert_vqav2_for_submission \
    --split $SPLIT --ckpt dynamic-llava
