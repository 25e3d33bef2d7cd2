#!/bin/bash
# Stage-1 projector alignment (LLaVA-1.5 recipe): train ONLY the mm_projector
# on the 558k caption set, prompt version "plain", lr 1e-3, predictors off.
# The PyTorch / CUDA twin of run/pretrain.sh: the same variables, flags and
# hyperparameters, run by torchrun on NPROC cards of one host (DeepSpeed
# ZeRO-2 -> the (data x fsdp) mesh of the port's parallel layer).

BASE=${BASE:-./checkpoints/vicuna-7b-v1.5-llava}
DATA=${DATA:-./playground/data/LLaVA-Pretrain/blip_laion_cc_sbu_558k.json}
IMAGES=${IMAGES:-./playground/data/LLaVA-Pretrain/images}
OUT=${OUT:-./checkpoints/llava-v1.5-7b-pretrain}

torchrun --nproc_per_node ${NPROC:-1} -m dynamic_llava_tpu_torch.train.train_sparse \
    --model_path "$BASE" \
    --model_size ${SIZE:-7b} \
    --version plain \
    --data_path "$DATA" \
    --image_folder "$IMAGES" \
    --requires_image \
    --tune_mm_mlp_adapter true \
    --output_dir "$OUT" \
    --per_device_train_batch_size 32 \
    --gradient_accumulation_steps ${GA:-1} \
    --num_train_epochs 1 \
    --learning_rate 1e-3 \
    --weight_decay 0. \
    --warmup_ratio 0.03 \
    --logging_steps 1 \
    --save_steps 24000 \
    --model_max_length 2048 \
    --gradient_checkpointing \
    --bf16 \
    --use_vision_predictor false \
    --use_output_text_predictor false \
    --use_instruct_predictor false \
    --data_parallel ${DP:-1} --fsdp_parallel ${FSDP:--1} --tensor_parallel ${TP:-1}
