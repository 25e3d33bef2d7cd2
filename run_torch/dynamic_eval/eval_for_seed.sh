#!/bin/bash
# SEED-Bench: chunked generation + merge + submission converter
# (the PyTorch / CUDA twin of run/dynamic_eval/eval_for_seed.sh). The
# generators run on DEVICE (default cuda); the chunks share it.
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
CHUNKS=${CHUNKS:-1}
ANSDIR=./playground/data/eval/seed_bench/answers/dynamic-llava

for IDX in $(seq 0 $((CHUNKS-1))); do
    python -m dynamic_llava_tpu_torch.eval.model_vqa_loader \
        --device ${DEVICE:-cuda} \
        --model-path "$CKPT" \
        --question-file ./playground/data/eval/seed_bench/llava-seed-bench.jsonl \
        --image-folder ./playground/data/eval/seed_bench \
        --answers-file $ANSDIR/chunk${IDX}.jsonl \
        --num-chunks $CHUNKS --chunk-idx $IDX \
        --temperature 0 --conv-mode vicuna_v1 &
done
wait

output_file=$ANSDIR/merge.jsonl
> "$output_file"
for IDX in $(seq 0 $((CHUNKS-1))); do
    cat $ANSDIR/chunk${IDX}.jsonl >> "$output_file"
done

python -m dynamic_llava_tpu_torch.eval.convert_seed_for_submission \
    --annotation-file ./playground/data/eval/seed_bench/SEED-Bench.json \
    --result-file "$output_file" \
    --result-upload-file ./playground/data/eval/seed_bench/answers_upload/dynamic-llava.jsonl
