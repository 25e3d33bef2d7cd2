#!/bin/bash
# GQA eval: N parallel chunk processes + JSONL merge + format conversion,
# then the GQA scorer's own eval/eval.py (the PyTorch / CUDA twin of
# run/dynamic_eval/eval_for_gqa.sh). The generators run on DEVICE (default
# cuda); the chunks share it.

CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
SPLIT="llava_gqa_testdev_balanced"
GQADIR="./playground/data/eval/gqa/data"
CHUNKS=${CHUNKS:-1}

for IDX in $(seq 0 $((CHUNKS-1))); do
    python -m dynamic_llava_tpu_torch.eval.model_vqa_loader \
        --device ${DEVICE:-cuda} \
        --model-path "$CKPT" \
        --question-file ./playground/data/eval/gqa/$SPLIT.jsonl \
        --image-folder ./playground/data/eval/gqa/data/images \
        --answers-file ./playground/data/eval/gqa/answers/$SPLIT/chunk${IDX}.jsonl \
        --num-chunks $CHUNKS --chunk-idx $IDX \
        --temperature 0 --conv-mode vicuna_v1 &
done
wait

output_file=./playground/data/eval/gqa/answers/$SPLIT/merge.jsonl
> "$output_file"
for IDX in $(seq 0 $((CHUNKS-1))); do
    cat ./playground/data/eval/gqa/answers/$SPLIT/chunk${IDX}.jsonl >> "$output_file"
done

python -m dynamic_llava_tpu_torch.eval.convert_gqa_for_eval \
    --src "$output_file" --dst "$GQADIR/testdev_balanced_predictions.json"
cd "$GQADIR" && python eval/eval.py --tier testdev_balanced
