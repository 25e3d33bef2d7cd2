#!/bin/bash
# ScienceQA task finetune: full model on the SQA train conversations
# (QCM-LEPA prompts from convert_sqa_to_llava), lr 2e-5, 12 epochs.
# The PyTorch / CUDA twin of run/finetune_sqa.sh, run by torchrun on NPROC cards.

BASE=${BASE:-./checkpoints/llava-v1.5-7b}
DATA=${DATA:-./playground/data/scienceqa/llava_train_QCM-LEPA.json}
IMAGES=${IMAGES:-./playground/data/scienceqa/images/train}
OUT=${OUT:-./checkpoints/llava-v1.5-7b-sqa}

torchrun --nproc_per_node ${NPROC:-1} -m dynamic_llava_tpu_torch.train.train_sparse \
    --model_path "$BASE" \
    --model_size ${SIZE:-7b} \
    --version v1 \
    --data_path "$DATA" \
    --image_folder "$IMAGES" \
    --output_dir "$OUT" \
    --per_device_train_batch_size 16 \
    --gradient_accumulation_steps ${GA:-1} \
    --num_train_epochs 12 \
    --learning_rate 2e-5 \
    --weight_decay 0. \
    --warmup_ratio 0.03 \
    --logging_steps 1 \
    --save_steps 5000 \
    --model_max_length 2048 \
    --gradient_checkpointing \
    --bf16 \
    --use_vision_predictor false \
    --use_output_text_predictor false \
    --use_instruct_predictor false \
    --data_parallel ${DP:-1} --fsdp_parallel ${FSDP:--1} --tensor_parallel ${TP:-1}
