#!/bin/bash
# Chunked ScienceQA eval: N parallel generator chunks + merge + scorer
# (the PyTorch / CUDA twin of run/dynamic_eval/eval_for_sqa_chunked.sh).
# The generators run on DEVICE (default cuda); the chunks share it.
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
SQA=${SQA:-./playground/data/eval/scienceqa}
CHUNKS=${CHUNKS:-1}
ANSDIR=./playground/data/eval/scienceqa/answers

for IDX in $(seq 0 $((CHUNKS-1))); do
    python -m dynamic_llava_tpu_torch.eval.model_vqa_science \
        --device ${DEVICE:-cuda} \
        --model-path "$CKPT" \
        --question-file "$SQA/llava_test_CQM-A.json" \
        --image-folder "$SQA/images/test" \
        --answers-file "$ANSDIR/chunk${IDX}.jsonl" \
        --num-chunks $CHUNKS --chunk-idx $IDX \
        --single-pred-prompt --temperature 0 --conv-mode vicuna_v1 &
done
wait

output_file=$ANSDIR/merge.jsonl
> "$output_file"
for IDX in $(seq 0 $((CHUNKS-1))); do
    cat "$ANSDIR/chunk${IDX}.jsonl" >> "$output_file"
done

python -m dynamic_llava_tpu_torch.eval.eval_science_qa \
    --base-dir "$SQA" \
    --result-file "$output_file" \
    --output-file "$ANSDIR/output.json" \
    --output-result "$ANSDIR/result.json"
