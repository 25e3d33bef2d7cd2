#!/bin/bash
# MMBench-CN dev split (the PyTorch / CUDA twin of
# run/dynamic_eval/eval_for_mmbench_cn.sh).
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
SPLIT=${SPLIT:-mmbench_dev_cn_20231003}
python -m dynamic_llava_tpu_torch.eval.model_vqa_mmbench \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --question-file ./playground/data/eval/mmbench_cn/$SPLIT.tsv \
    --answers-file ./playground/data/eval/mmbench_cn/answers/$SPLIT/dynamic-llava.jsonl \
    --lang cn --single-pred-prompt \
    --temperature 0 --conv-mode vicuna_v1
mkdir -p ./playground/data/eval/mmbench_cn/answers_upload/$SPLIT
python -m dynamic_llava_tpu_torch.eval.convert_mmbench_for_submission \
    --annotation-file ./playground/data/eval/mmbench_cn/$SPLIT.tsv \
    --result-dir ./playground/data/eval/mmbench_cn/answers/$SPLIT \
    --upload-dir ./playground/data/eval/mmbench_cn/answers_upload/$SPLIT \
    --experiment dynamic-llava
