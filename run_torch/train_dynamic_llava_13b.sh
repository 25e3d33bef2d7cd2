#!/bin/bash
# Sparse fine-tune of Dynamic-LLaVA-13B on NVIDIA cards: the PyTorch / CUDA twin
# of run/train_dynamic_llava_13b.sh, the reference recipe's hyperparameters,
# DeepSpeed ZeRO-3 replaced by the (data x fsdp) mesh of the port's parallel
# layer over torchrun's NPROC ranks (--fsdp_parallel -1 takes what DP and TP
# leave). Set DATA/IMAGES/BASE to your local paths.

BASE=${BASE:-./checkpoints/llava-v1.5-13b}
DATA=${DATA:-./playground/data/llava_v1_5_mix665k.json}
IMAGES=${IMAGES:-./playground/data}
OUT=${OUT:-./checkpoints/dynamic-llava-v1.5-13b}

torchrun --nproc_per_node ${NPROC:-1} -m dynamic_llava_tpu_torch.train.train_sparse \
    --model_path "$BASE" \
    --model_size 13b \
    --version v1 \
    --data_path "$DATA" \
    --image_folder "$IMAGES" \
    --image_aspect_ratio pad \
    --group_by_modality_length \
    --requires_image \
    --output_dir "$OUT" \
    --per_device_train_batch_size 8 \
    --gradient_accumulation_steps ${GA:-1} \
    --num_train_epochs 1 \
    --learning_rate 5e-6 \
    --predictor_lr 2e-4 \
    --weight_decay 0. \
    --warmup_ratio 0.03 \
    --logging_steps 1 \
    --save_steps 500 \
    --model_max_length 2048 \
    --gradient_checkpointing \
    --bf16 \
    --gumbel_start_tau 1.0 \
    --gumbel_end_tau 0.1 \
    --use_vision_predictor true \
    --vision_keep_rate 0.2 \
    --use_output_text_predictor true \
    --output_text_keep_rate 0.5 \
    --output_text_len_for_training 50 \
    --use_instruct_predictor false \
    --sparse_layer 2 \
    --mask_loss_weight 100.0 \
    --data_parallel ${DP:-1} --fsdp_parallel ${FSDP:--1} --tensor_parallel ${TP:-1}
