"""GRPO post-training from the command line (port of `time_r1_tpu/cli/train.py`).

    python -m time_r1_tpu_torch.cli.train --model_name_or_path CKPT \
        --output_dir OUT --train_data_path train.json [flags of the recipes]

Flag names and defaults follow the reference recipes
(scripts/posttrain/train_rl.sh), as the JAX package's do, so a recipe moves
over by changing only its launcher. The TimeRFT dataset loader
(load_json_dataset_tg, main.py:431-494) and the resume max_steps arithmetic
(main.py:589-618) are reproduced here.

The run: `load_checkpoint` (HF safetensors or the port's native format) for
the policy and, with beta != 0 and no LoRA, again for the reference;
`GRPOTrainer`; `train()`; the final `save_checkpoint`. One process on one card,
or the ranks of a torchrun launch (`build_train_mesh`: a mesh of data = ranks
/ tp by model = tp): the parameters, gradients and optimizer state sharded
by the rule table (`parallel/sharding.py`), FSDP over the data axis, each data
rank training its own shard of the dataset, and with --tensor_parallel_size
tp tensor parallelism over the model axis (heads and MLP width split; the
tp adjacent ranks of a model group train the same rows); or with
--context_parallel_size N (N = the data ranks, ranks / tp) context
parallelism, the data ranks splitting each full row's sequence over ring
attention, inside tensor parallelism when tp > 1:

    torchrun --nproc_per_node 4 -m time_r1_tpu_torch.cli.train \
        --model_name_or_path CKPT --output_dir OUT --train_data_path train.json \
        [--tensor_parallel_size 2 | --context_parallel_size 4 --context_parallel_layout zigzag
         | --context_parallel_size 2 --tensor_parallel_size 2 | --use_peft true --tensor_parallel_size 2]

Each rank takes its own card over NCCL when the machine has one for each, else
they share the first card over gloo.

LoRA (`--use_peft true --lora_r --lora_alpha`) trains adapters over the
frozen base, which is then also the reference: no second load. Over a mesh
the adapters stay whole on every rank and the base is sharded when tp > 1.
`--train_base_quantization int8` (with --use_peft only) puts the loaded base
into int8 in the decode-fused layout one layer at a time, each bf16 layer
dropped once quantized, so the bf16 and int8 trees are never both whole on
the card: the single-card 7B configuration, whose rollouts then run over the
same tree with side-path adapters.

    python -m time_r1_tpu_torch.cli.train --model_name_or_path Qwen2.5-VL-7B \
        --output_dir OUT --train_data_path train.json --use_peft true \
        --lora_r 16 --lora_alpha 32 --train_base_quantization int8 \
        --rollout_quantization int8 --gradient_checkpointing true

"""

from __future__ import annotations

import argparse
import json
import math
import os
import random

import numpy as np
import torch
import torch.distributed as dist

from ..models.processor import Qwen25VLProcessor
from ..models.qwen25vl.convert import load_checkpoint
from ..ops.quant import quantize_layer, quantize_text_params
from ..parallel.mesh import make_mesh, maybe_init_distributed
from ..rl.trainer import GRPOTrainer, TrainConfig
from ..utils.rewards import METRIC_FUNCS_REGISTRY, REWARD_FUNCS_REGISTRY
from ..video.pipeline import video_loader


def set_global_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def load_json_dataset_tg(train_data_path: str, is_curriculum_learning: bool = False):
    """main.py:431-494: lowercase+strip sentences, drop missing videos,
    shuffle unless curriculum ordering is requested."""
    with open(train_data_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    examples = []
    for item in data:
        sentence = item.get("sentence", "").strip().lower()
        if sentence.endswith("."):
            sentence = sentence[:-1]
        if not os.path.isfile(item.get("video", "")):
            continue
        examples.append(
            {
                "task_type": "tg",
                "problem": sentence,
                "choices": "",
                "solution": (float(item["timestamp"][0]), float(item["timestamp"][1])),
                "video_path": item["video"],
                "durations": item.get("duration"),
                "video_start": item.get("video_start"),
                "video_end": item.get("video_end"),
                "preprocessed_path": "",
            }
        )
    if not examples:
        return None
    if not is_curriculum_learning:
        random.shuffle(examples)
    return examples


def get_args(argv=None):
    p = argparse.ArgumentParser(description="TimeRFT GRPO post-training (PyTorch/CUDA)")
    p.add_argument("--model_name_or_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--train_data_path", type=str, required=True)
    p.add_argument("--reward_funcs", nargs="+", default=["iou", "format"])
    p.add_argument("--max_pixels", type=int, default=12845056)
    p.add_argument("--min_pixels", type=int, default=3136)
    # per-video budgets used by make_conversation_video (timer1_trainer.py:505-506)
    p.add_argument("--total_pixels", type=int, default=3584 * 28 * 28)
    p.add_argument("--video_min_pixels", type=int, default=16 * 28 * 28)
    p.add_argument("--max_prompt_length", type=int, default=8192)
    p.add_argument("--max_completion_length", type=int, default=200)
    p.add_argument("--num_generations", type=int, default=8)
    p.add_argument("--per_device_train_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-6)
    p.add_argument("--warmup_ratio", type=float, default=0.0)
    p.add_argument("--lr_scheduler_type", type=str, default="linear", choices=["linear", "constant"])
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=0.04)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--num_train_epochs", type=float, default=5)
    p.add_argument("--logging_steps", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=50)
    p.add_argument("--save_strategy", type=str, default="steps", choices=["steps", "epoch"])
    p.add_argument("--save_only_model", type=lambda s: s.lower() == "true", default=True)
    p.add_argument("--fix_vit", type=lambda s: s.lower() == "true", default=True)
    p.add_argument("--slide_window", type=lambda s: s.lower() == "true", default=False)
    p.add_argument("--max_window_layers", type=int, default=2)
    p.add_argument("--sliding_window_length", type=int, default=4096)
    p.add_argument("--prompt_type", type=str, default="v1")
    p.add_argument("--use_grpo", type=lambda s: s.lower() == "true", default=False)
    p.add_argument("--is_curriculum_learning", type=lambda s: s.lower() == "true", default=False)
    p.add_argument("--is_early_stopping", type=lambda s: s.lower() == "true", default=False)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--data_seed", type=int, default=42)
    p.add_argument("--run_name", type=str, default="run")
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--logging_dir", type=str, default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--torch_dtype", type=str, default="bfloat16", help="accepted for recipe parity")
    p.add_argument("--gradient_checkpointing", type=lambda s: s.lower() == "true", default=True)
    p.add_argument(
        "--remat_policy",
        type=str,
        default="full",
        choices=["full", "dots", "dots_small"],
        help="residual-save policy under --gradient_checkpointing: "
        "'dots' saves projection outputs so the backward skips most recompute",
    )
    # PEFT/LoRA (trl ModelConfig flag names the reference consumes via TrlParser)
    p.add_argument("--use_peft", type=lambda s: s.lower() == "true", default=False)
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=float, default=32.0)
    p.add_argument(
        "--rollout_quantization",
        type=str,
        default="",
        choices=["", "int8", "int4"],
        help="weight-only quantized rollout sampling (logps recomputed full precision)",
    )
    p.add_argument(
        "--train_base_quantization",
        type=str,
        default="",
        choices=["", "int8"],
        help="quantize the frozen LoRA base after load, in the decode-fused "
        "qkv/gu layout, one layer at a time (the single-card 7B training "
        "configuration: rollouts share the tree through side-path adapters); "
        "requires --use_peft true",
    )
    p.add_argument("--attn_implementation", type=str, default="flash")
    p.add_argument("--dataset_name", type=str, default="xxx")
    p.add_argument("--video_folder", type=str, default="xxx")
    p.add_argument("--deepspeed", type=str, default=None, help="accepted for recipe parity")
    p.add_argument(
        "--tensor_parallel_size",
        type=int,
        default=1,
        help="model-axis size of the training mesh; the data axis takes the "
        "remaining ranks (FSDP over data, tensor parallelism over model)",
    )
    p.add_argument(
        "--context_parallel_size",
        type=int,
        default=1,
        help="shard the loss-forward sequence over the data axis via ring "
        "attention (must equal the number of ranks; uses the full-row batch layout)",
    )
    p.add_argument(
        "--context_parallel_layout",
        type=str,
        default="zigzag",
        choices=["zigzag", "contiguous"],
        help="the ring attention layout of --context_parallel_size",
    )
    return p.parse_args(argv)


def build_train_mesh(tensor_parallel_size: int = 1, device="cuda"):
    """The training mesh over every rank of a torchrun launch
    (`parallel.maybe_init_distributed`, then `make_mesh`: data = ranks / tp,
    model = tp), as JAX's `cli/train.py:167-184`; None in one process with
    tensor_parallel_size 1. Raises when tp does not divide the ranks."""
    maybe_init_distributed(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    tp = max(tensor_parallel_size, 1)
    if n == 1 and tp <= 1:
        return None
    if n % tp:
        raise ValueError(f"tensor_parallel_size={tensor_parallel_size} does not divide {n} ranks")
    return make_mesh(model_parallel=tp)


def main(args, trainer: GRPOTrainer = None, device="cuda"):
    """Train as the recipe asks; returns the trainer. Runs on the card unless
    `device` says otherwise (the tests pass "cpu"); under torchrun, on this
    rank's card (`build_train_mesh`)."""
    if args.train_base_quantization and not args.use_peft:
        raise SystemExit("--train_base_quantization requires --use_peft true")
    set_global_seed(42)
    dataset = load_json_dataset_tg(args.train_data_path, args.is_curriculum_learning)
    mesh = build_train_mesh(args.tensor_parallel_size, device) if trainer is None else None
    return _run(args, trainer, dataset, device, mesh)


@torch.no_grad()
def quantize_base_in_place(params: dict, bits: int = 8) -> dict:
    """The loaded base's text weights into their quantized, decode-fused form
    (`ops/quant.py::quantize_params(fuse=True)`), in place: each layer is
    quantized and its bf16 dict replaced, so that its memory is free before
    the next layer is quantized; then the embedding and the untied head. The
    vision tower stays as it is. Returns `params`."""
    layers = params["text"]["layers"]
    for i in range(len(layers)):
        layers[i] = quantize_layer(layers[i], bits=bits, fuse=True)
    params["text"] = quantize_text_params(params["text"], bits=bits)  # the layers are done: the embedding, the head
    return params


def _run(args, trainer, dataset, device="cuda", mesh=None):
    if trainer is None:
        params, cfg = load_checkpoint(args.model_name_or_path, device=device)
        if args.train_base_quantization:
            quantize_base_in_place(params, bits=8)
        if args.slide_window:
            cfg = cfg.with_sliding_window(True, args.sliding_window_length, args.max_window_layers)
        processor = Qwen25VLProcessor.from_pretrained(args.model_name_or_path)
        ref_params = None
        if args.beta != 0.0 and not args.use_peft:
            # the KL needs a frozen copy: a second load, whose mapped files
            # are released once it is on the device. Under LoRA the unmerged
            # base is the reference.
            ref_params, _ = load_checkpoint(args.model_name_or_path, device=device)
        config = TrainConfig(
            output_dir=args.output_dir,
            learning_rate=args.learning_rate,
            warmup_ratio=args.warmup_ratio,
            lr_scheduler_type=args.lr_scheduler_type,
            weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm,
            num_train_epochs=args.num_train_epochs,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            per_device_train_batch_size=args.per_device_train_batch_size,
            max_prompt_length=args.max_prompt_length,
            max_completion_length=args.max_completion_length,
            num_generations=args.num_generations,
            temperature=args.temperature,
            beta=args.beta,
            use_grpo=args.use_grpo,
            fix_vit=args.fix_vit,
            gradient_checkpointing=args.gradient_checkpointing,
            remat_policy=args.remat_policy,
            use_peft=args.use_peft,
            lora_r=args.lora_r,
            lora_alpha=args.lora_alpha,
            rollout_quantization=args.rollout_quantization,
            context_parallel_size=args.context_parallel_size,
            context_parallel_layout=args.context_parallel_layout,
            prompt_type=args.prompt_type,
            logging_steps=args.logging_steps,
            save_steps=args.save_steps,
            save_strategy=args.save_strategy,
            save_only_model=args.save_only_model,
            seed=args.data_seed,
            is_early_stopping=args.is_early_stopping,
            resume_from_checkpoint=args.resume_from_checkpoint,
            total_pixels=args.total_pixels,
            min_pixels=args.video_min_pixels,
            report_to=args.report_to,
            run_name=args.run_name,
            logging_dir=args.logging_dir,
        )
        trainer = GRPOTrainer(
            params,
            cfg,
            processor,
            reward_funcs=[REWARD_FUNCS_REGISTRY[f] for f in args.reward_funcs],
            metric_funcs=list(METRIC_FUNCS_REGISTRY.values()),
            config=config,
            video_loader=video_loader,
            ref_params=ref_params,
            dtype=torch.bfloat16,
            mesh=mesh,
            device=device,
        )
        del params, ref_params  # the trainer holds its own (over a mesh, its blocks and the engine's copy)

    # resume: recompute and enforce the max-steps target from
    # trainer_state.json (main.py:589-618, the SF loop's continuation: a
    # resumed round trains exactly num_train_epochs' worth of data beyond the
    # restored step, then stops)
    max_steps = None
    if args.resume_from_checkpoint:
        state_path = os.path.join(args.resume_from_checkpoint, "trainer_state.json")
        if os.path.exists(state_path):
            # params, global_step and, when the checkpoint was written with
            # --save_only_model false, the optimizer state
            trainer.load_checkpoint_state(args.resume_from_checkpoint)
            resumed_global_step = trainer.global_step
            # global_step counts step_batch micro-steps of
            # per_device_train_batch_size examples of this rank's shard each:
            # the quota is epochs · ceil(shard / bs) more
            n_local = math.ceil(len(dataset) / trainer.data_ranks)
            bs = max(int(trainer.c.per_device_train_batch_size), 1)
            quota = math.ceil(trainer.c.num_train_epochs * math.ceil(n_local / bs))
            max_steps = resumed_global_step + quota
            print(f"Resuming from step {resumed_global_step}; will stop at {max_steps}")

    trainer.train(dataset, max_steps=max_steps)
    trainer.save_checkpoint(args.output_dir)
    return trainer


if __name__ == "__main__":
    main(get_args())
