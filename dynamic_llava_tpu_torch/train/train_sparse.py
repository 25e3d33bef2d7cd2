"""Sparse fine-tuning entry point: the port's counterpart of
``dynamic_llava_tpu/train/train_sparse.py`` (the reference's
``llava/train/train_sparse.py:940-1198``).

Loads (or randomly initializes) a LLaVA model, sets the sparse config,
builds the mix665k data pipeline (``train.data``) and trains the
predictors and the decoder with the Gumbel policy path through
``Trainer``. It runs on the card unless ``--device`` names another.

    python -m dynamic_llava_tpu_torch.train.train_sparse \\
        --model_path /path/to/llava-v1.5-7b \\
        --data_path .../llava_v1_5_mix665k.json --image_folder .../data \\
        --output_dir ./checkpoints/dynamic-llava-7b \\
        --vision_keep_rate 0.2 --output_text_keep_rate 0.5 \\
        --learning_rate 5e-6 --predictor_lr 2e-4 --mask_loss_weight 100

The flags are the JAX CLI's, faults included: ``--bf16`` and
``--group_by_modality_length`` are ``store_true`` with a default of True,
so neither can be turned off (ROADMAP C27). Across several cards it runs
under ``torchrun``, one rank a card, sharded over the mesh flags
(``parallel.sharding``); their product must be the number of ranks:

    torchrun --nproc_per_node=8 -m dynamic_llava_tpu_torch.train.train_sparse \
        ... --data_parallel 2 --tensor_parallel 2   # fsdp takes the other 2

Every rank reads the same global batch of ``per_device_train_batch_size x
data_parallel x gradient_accumulation_steps`` rows and computes on its
``data`` share of them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Dynamic-LLaVA sparse fine-tuning (H100)")
    # model
    p.add_argument("--model_path", type=str, default=None,
                   help="HF LLaVA checkpoint dir; omit for random init (testing)")
    p.add_argument("--model_size", type=str, default="7b", choices=["7b", "13b", "tiny"])
    p.add_argument("--version", type=str, default="v1",
                   help="conversation template (v1 | plain | mpt | llama_2)")
    # data
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--image_folder", type=str, default="")
    p.add_argument("--image_aspect_ratio", type=str, default="pad")
    p.add_argument("--requires_image", action="store_true")
    p.add_argument("--group_by_modality_length", action="store_true", default=True)
    p.add_argument("--model_max_length", type=int, default=2048)
    # training
    p.add_argument("--output_dir", type=str, default="./checkpoints/run")
    p.add_argument("--per_device_train_batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--learning_rate", type=float, default=5e-6)
    p.add_argument("--predictor_lr", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gradient_checkpointing",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--remat_policy", type=str, default="nothing",
                   choices=["nothing", "dots"],
                   help="gradient-checkpoint policy: nothing=min memory, "
                        "dots=save projection outputs (faster backward)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--gumbel_start_tau", type=float, default=1.0)
    p.add_argument("--gumbel_end_tau", type=float, default=0.1)
    p.add_argument("--report_to", type=str, default="jsonl")
    # mesh
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--fsdp_parallel", type=int, default=-1)
    p.add_argument("--tensor_parallel", type=int, default=1)
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="GPipe stages over the layer stack (1 = off); "
                        "must divide num_hidden_layers")
    p.add_argument("--pipeline_microbatches", type=int, default=0,
                   help="microbatches per pipelined sweep (0 -> = stages); "
                        "must divide the per-step batch size")
    # sparse flags (reference SparseArguments, train_sparse.py:145-165)
    p.add_argument("--use_vision_predictor", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--vision_keep_rate", type=float, default=0.2)
    p.add_argument("--use_output_text_predictor", type=lambda s: s.lower() != "false",
                   default=True)
    p.add_argument("--output_text_keep_rate", type=float, default=0.5)
    p.add_argument("--output_text_len_for_training", type=int, default=50)
    p.add_argument("--use_instruct_predictor", type=lambda s: s.lower() != "false",
                   default=False)
    p.add_argument("--instruct_keep_rate", type=float, default=0.7)
    p.add_argument("--instruct_len_for_training", type=int, default=25)
    p.add_argument("--sparse_layer", type=int, default=2)
    p.add_argument("--predictor_d_model", type=int, default=512)
    p.add_argument("--predictor_nhead", type=int, default=8)
    p.add_argument("--predictor_dim_feedforward", type=int, default=2048)
    p.add_argument("--predictor_num_layers", type=int, default=2)
    p.add_argument("--mask_loss_weight", type=float, default=100.0)
    p.add_argument("--tokenizer_path", type=str, default=None)
    # lora (reference train_sparse.py lora_enable path)
    p.add_argument("--lora_enable", action="store_true")
    p.add_argument("--lora_r", type=int, default=128)
    p.add_argument("--lora_alpha", type=float, default=256.0)
    # dense-stage recipes (reference scripts/pretrain.sh, finetune*.sh)
    p.add_argument("--tune_mm_mlp_adapter",
                   type=lambda s: s.lower() != "false", default=False,
                   help="stage-1 alignment: train ONLY the projector")
    p.add_argument("--pretrain_mm_mlp_adapter", type=str, default=None,
                   help="mm_projector.bin from a stage-1 run to load")
    p.add_argument("--mm_projector_lr", type=float, default=0.0,
                   help="separate projector lr (lora recipes use 2e-5)")
    p.add_argument("--bits", type=int, default=16, choices=[4, 8, 16],
                   help="quantize frozen base weights (qlora, with --lora_enable)")
    p.add_argument("--device", type=str, default=None,
                   help="default: the card; 'cpu' runs the plain PyTorch versions")
    return p.parse_args(argv)


def check_mesh(args, world_size: int) -> None:
    """The mesh the flags describe must cover the ranks: its product, with
    ``--fsdp_parallel -1`` taking what the other axes leave, must be the
    world size (one rank, the default flags)."""
    from ..parallel.sharding import mesh_shape

    try:
        mesh_shape(world_size, args.data_parallel, args.fsdp_parallel, args.tensor_parallel,
                   max(args.pipeline_parallel, 1))
    except ValueError as e:
        raise SystemExit(f"train_sparse: {e}") from None


def trainer_config(args, num_steps: int):
    """The ``TrainerConfig`` of the flags (the JAX CLI's, field for field)."""
    from .trainer import TrainerConfig

    return TrainerConfig(
        output_dir=args.output_dir,
        learning_rate=args.learning_rate,
        predictor_lr=args.predictor_lr,
        weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio,
        num_train_steps=num_steps,
        gumbel_start_tau=args.gumbel_start_tau,
        gumbel_end_tau=args.gumbel_end_tau,
        logging_steps=args.logging_steps,
        save_steps=args.save_steps,
        seed=args.seed,
        gradient_checkpointing=args.gradient_checkpointing,
        remat_policy=args.remat_policy,
        grad_accum_steps=args.gradient_accumulation_steps,
        report_to=args.report_to,
        data_parallel=args.data_parallel,
        fsdp_parallel=args.fsdp_parallel,
        tensor_parallel=args.tensor_parallel,
        pipeline_parallel=args.pipeline_parallel,
        pipeline_microbatches=args.pipeline_microbatches,
        lora_mode=args.lora_enable,
        tune_mm_mlp_adapter=args.tune_mm_mlp_adapter,
        mm_projector_lr=args.mm_projector_lr,
    )


def build_config(args):
    from ..config import LlamaConfig, LlavaConfig, SparseConfig

    sparse = SparseConfig(
        use_vision_predictor=args.use_vision_predictor,
        vision_keep_rate=args.vision_keep_rate,
        use_output_text_predictor=args.use_output_text_predictor,
        output_text_keep_rate=args.output_text_keep_rate,
        output_text_len_for_training=args.output_text_len_for_training,
        use_instruct_predictor=args.use_instruct_predictor,
        instruct_keep_rate=args.instruct_keep_rate,
        instruct_len_for_training=args.instruct_len_for_training,
        sparse_layer=args.sparse_layer,
        d_model=args.predictor_d_model,
        nhead=args.predictor_nhead,
        dim_feedforward=args.predictor_dim_feedforward,
        num_layers=args.predictor_num_layers,
        mask_loss_weight=args.mask_loss_weight,
    )
    if args.model_size == "7b":
        text = LlamaConfig.llama_7b()
    elif args.model_size == "13b":
        text = LlamaConfig.llama_13b()
    else:
        text = LlamaConfig.tiny()
    return LlavaConfig(
        text=text, sparse=sparse,
        image_aspect_ratio=args.image_aspect_ratio,
        model_max_length=args.model_max_length,
    )


def train(argv=None):
    """Parse ``argv``, train, save, and return the ``Trainer``."""
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    check_mesh(args, world)
    from .. import conversation as conversation_lib
    from ..mm_utils import ClipImagePreprocessor
    from ..models.builder import load_pretrained_model
    from ..parallel import sharding
    from ..weights import init_llava_params, init_predictors, resolve_device
    from .data import Collator, DataArguments, LazySupervisedDataset, data_loader
    from .trainer import Trainer

    conversation_lib.default_conversation = conversation_lib.conv_templates[args.version]

    device = resolve_device(args.device)
    if world > 1:  # under torchrun: one card a rank, the group from its environment
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        if not torch.distributed.is_initialized():
            torch.distributed.init_process_group("nccl" if device.type == "cuda" else "gloo")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    generator = torch.Generator(device=device).manual_seed(args.seed)
    tokenizer = None
    if args.model_path:
        tokenizer, runtime, image_processor, _ = load_pretrained_model(
            args.model_path, dtype=dtype, device=device)
        cfg = dataclasses.replace(build_config(args), text=runtime.cfg.text,
                                  vision=runtime.cfg.vision)
        params = dict(runtime.params)
        # fresh predictors if the checkpoint has none
        if "predictors" not in params and cfg.sparse.any_predictor:
            params["predictors"] = init_predictors(cfg, generator, device, dtype)
    else:
        cfg = build_config(args)
        params = init_llava_params(cfg, generator, device, dtype)
        image_processor = ClipImagePreprocessor(size=cfg.vision.image_size)
    if tokenizer is None and args.tokenizer_path:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer_path, use_fast=False)
    if tokenizer is None:
        raise SystemExit("need --model_path or --tokenizer_path for a tokenizer")
    tokenizer.model_max_length = args.model_max_length

    if args.pretrain_mm_mlp_adapter:
        from ..models import convert

        path = args.pretrain_mm_mlp_adapter
        proj_sd = (convert.load_state_dict_file(path)
                   if path.endswith((".bin", ".pt", ".safetensors"))
                   else convert.load_state_dict_from_dir(path))
        params["mm_projector"] = convert.projector_params_from_state_dict(
            proj_sd, cfg.mm_projector_type, device=device, dtype=dtype)

    if args.bits in (4, 8):
        if not args.lora_enable:
            raise SystemExit("--bits 4/8 requires --lora_enable (qlora)")
        from ..ops.quant import quantize_llm_params

        params = quantize_llm_params(params, bits=args.bits)

    if args.lora_enable:
        from .lora import attach_lora, init_lora_params

        adapters = init_lora_params(
            cfg.text, torch.Generator(device=device).manual_seed(args.seed + 1),
            rank=args.lora_r, alpha=args.lora_alpha, dtype=dtype, device=device)
        params = attach_lora(params, adapters)

    data_args = DataArguments(
        data_path=args.data_path,
        image_folder=args.image_folder,
        image_aspect_ratio=args.image_aspect_ratio,
        requires_image=args.requires_image,
    )
    dataset = LazySupervisedDataset(args.data_path, tokenizer, data_args, image_processor)
    global_batch = (args.per_device_train_batch_size * max(args.data_parallel, 1)
                    * args.gradient_accumulation_steps)
    steps_per_epoch = max(1, len(dataset) // global_batch)
    num_steps = (args.max_steps if args.max_steps > 0
                 else int(steps_per_epoch * args.num_train_epochs))

    tc = trainer_config(args, num_steps)
    trainer = Trainer(cfg, params, tc, device=device, use_mesh=world > 1)
    if trainer.maybe_resume() and sharding.rank() == 0:
        print(f"resumed from step {trainer.step}")

    collator = Collator(num_image_tokens=cfg.num_image_tokens,
                        model_max_length=args.model_max_length)

    def batches():
        epoch = 0
        while True:
            yield from data_loader(
                dataset, collator, global_batch, seed=args.seed + epoch,
                group_by_modality_length=args.group_by_modality_length,
            )
            epoch += 1

    metrics = trainer.train(batches())
    trainer.save()
    trainer.logger.close()
    if sharding.rank() == 0:
        print("final:", metrics)
    return trainer


if __name__ == "__main__":
    train()
