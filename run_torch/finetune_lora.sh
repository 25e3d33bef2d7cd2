#!/bin/bash
# LoRA instruction finetune: adapters r=128 alpha=256 at lr 2e-4, projector
# at its own 2e-5 lr, base frozen.
# The PyTorch / CUDA twin of run/finetune_lora.sh, run by torchrun on NPROC cards.

BASE=${BASE:-./checkpoints/vicuna-7b-v1.5-llava}
PROJ=${PROJ:-./checkpoints/llava-v1.5-7b-pretrain/mm_projector.bin}
DATA=${DATA:-./playground/data/llava_v1_5_mix665k.json}
IMAGES=${IMAGES:-./playground/data}
OUT=${OUT:-./checkpoints/llava-v1.5-7b-lora}

torchrun --nproc_per_node ${NPROC:-1} -m dynamic_llava_tpu_torch.train.train_sparse \
    --model_path "$BASE" \
    --model_size ${SIZE:-7b} \
    --version v1 \
    --data_path "$DATA" \
    --image_folder "$IMAGES" \
    --image_aspect_ratio pad \
    --group_by_modality_length \
    --pretrain_mm_mlp_adapter "$PROJ" \
    --lora_enable --lora_r 128 --lora_alpha 256 \
    --mm_projector_lr 2e-5 \
    --output_dir "$OUT" \
    --per_device_train_batch_size 16 \
    --gradient_accumulation_steps ${GA:-1} \
    --num_train_epochs 1 \
    --learning_rate 2e-4 \
    --weight_decay 0. \
    --warmup_ratio 0.03 \
    --logging_steps 1 \
    --save_steps 50000 \
    --model_max_length 2048 \
    --gradient_checkpointing \
    --bf16 \
    --use_vision_predictor false \
    --use_output_text_predictor false \
    --use_instruct_predictor false \
    --data_parallel ${DP:-1} --fsdp_parallel ${FSDP:--1} --tensor_parallel ${TP:-1}
