#!/bin/bash
# LLaVA-Bench-in-the-Wild: generation + GPT-4 pairwise review + summary
# (the PyTorch / CUDA twin of run/dynamic_eval/eval_for_llavabench.sh). The
# review step needs OPENAI_API_KEY, same as the reference.
CKPT=${CKPT:-./checkpoints/dynamic-llava-v1.5-7b}
BENCH=./playground/data/eval/llava-bench-in-the-wild
python -m dynamic_llava_tpu_torch.eval.model_vqa \
    --device ${DEVICE:-cuda} \
    --model-path "$CKPT" \
    --question-file $BENCH/questions.jsonl \
    --image-folder $BENCH/images \
    --answers-file $BENCH/answers/dynamic-llava.jsonl \
    --temperature 0 --conv-mode vicuna_v1
mkdir -p $BENCH/reviews
python -m dynamic_llava_tpu_torch.eval.eval_gpt_review_bench \
    --question $BENCH/questions.jsonl \
    --context $BENCH/context.jsonl \
    --rule $BENCH/rule.json \
    --answer-list $BENCH/answers_gpt4.jsonl $BENCH/answers/dynamic-llava.jsonl \
    --output $BENCH/reviews/dynamic-llava.jsonl
python -m dynamic_llava_tpu_torch.eval.summarize_gpt_review \
    -f $BENCH/reviews/dynamic-llava.jsonl
