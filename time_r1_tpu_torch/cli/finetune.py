"""Downstream GRPO fine-tuning from the command line (port of
`time_r1_tpu/cli/finetune.py`, the reference's finetune.py).

    python -m time_r1_tpu_torch.cli.finetune --model_name_or_path CKPT \
        --output_dir OUT --train_data_path charades_train.json \
        --video_folder videos/ --preprocessed_data_path charades_preprocessed \
        --beta 0.0 --use_grpo false

What differs from `cli/train.py`, as in the reference:
- the dataset is Charades/ActivityNet-style json ({video_id: {duration,
  timestamps, sentences}}) over a video folder, with the videos decoded
  offline by `cli/preprocess_videos.py` (`--preprocessed_data_path`: the
  trainer reads `<path>/<video id>/video.npz` instead of decoding);
- the recipes run with --beta 0.0 (no reference copy, no KL) and
  --use_grpo false (PPO-clip) (scripts/finetune/run_charades.sh).

The other flags are `cli/train.py`'s. One process on one card, or the ranks
of a torchrun launch sharded by the rule table (FSDP over the data axis, and
with --tensor_parallel_size tp tensor parallelism over the model axis),
through `cli/train.py::build_train_mesh`.
"""

from __future__ import annotations

import json
import os
import random
import sys

import torch

from ..models.processor import Qwen25VLProcessor
from ..models.qwen25vl.convert import load_checkpoint
from ..rl.trainer import GRPOTrainer, TrainConfig
from ..utils.rewards import METRIC_FUNCS_REGISTRY, REWARD_FUNCS_REGISTRY
from ..video.pipeline import video_loader
from . import train


def load_json_dataset(train_data_path: str, video_folder: str, preprocessed_data_path: str = ""):
    """finetune.py:541-632: one example per (video, sentence), with
    preprocessed_path = {preprocessed_data_path}/{video_id}, shuffled by the
    global `random` (seeded by `main`)."""
    with open(train_data_path) as f:
        data = json.load(f)
    examples = []
    for video_id, video_data in data.items():
        for timestamps, sentence in zip(video_data["timestamps"], video_data["sentences"]):
            sentence = sentence.strip().lower()
            if sentence.endswith("."):
                sentence = sentence[:-1]
            video_path = None
            for ext in ("mp4", "mkv", "webm"):
                cand = os.path.join(video_folder, f"{video_id}.{ext}")
                if os.path.isfile(cand):
                    video_path = cand
                    break
            example = {
                "task_type": "tg",
                "problem": sentence,
                "solution": (timestamps[0], timestamps[1]),
                "video_path": video_path,
                "durations": video_data["duration"],
                "video_start": None,
                "video_end": None,
                "preprocessed_path": os.path.join(preprocessed_data_path, video_id) if preprocessed_data_path else "",
            }
            if example["preprocessed_path"] and not os.path.exists(example["preprocessed_path"]):
                print(f"Warning: Preprocessed path not found for video_id: {video_id}")
            examples.append(example)
    random.shuffle(examples)
    return examples


def main(argv=None, device="cuda"):
    """`cli/train.py`'s flags plus --preprocessed_data_path (and its
    --video_folder); returns the trainer. Runs on the card unless `device`
    says otherwise (the tests pass "cpu")."""
    argv = list(sys.argv[1:] if argv is None else argv)
    preprocessed = ""
    if "--preprocessed_data_path" in argv:
        i = argv.index("--preprocessed_data_path")
        preprocessed = argv[i + 1]
        del argv[i:i + 2]
    video_folder = "."
    if "--video_folder" in argv:
        video_folder = argv[argv.index("--video_folder") + 1]
    args = train.get_args(argv)
    random.seed(42)
    dataset = load_json_dataset(args.train_data_path, video_folder, preprocessed)
    mesh = train.build_train_mesh(args.tensor_parallel_size, device)
    return _run(args, dataset, device, mesh)


def _run(args, dataset, device="cuda", mesh=None):
    params, cfg = load_checkpoint(args.model_name_or_path, device=device)
    processor = Qwen25VLProcessor.from_pretrained(args.model_name_or_path)
    ref_params = None
    if args.beta != 0.0:
        ref_params, _ = load_checkpoint(args.model_name_or_path, device=device)
    config = TrainConfig(
        output_dir=args.output_dir,
        learning_rate=args.learning_rate,
        num_train_epochs=args.num_train_epochs,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_completion_length=args.max_completion_length,
        num_generations=args.num_generations,
        temperature=args.temperature,
        beta=args.beta,
        use_grpo=args.use_grpo,
        fix_vit=args.fix_vit,
        gradient_checkpointing=args.gradient_checkpointing,
        prompt_type=args.prompt_type,
        logging_steps=args.logging_steps,
        save_steps=args.save_steps,
        save_strategy=args.save_strategy,
        is_early_stopping=args.is_early_stopping,
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
    trainer.train(dataset)
    trainer.save_checkpoint(args.output_dir)
    return trainer


if __name__ == "__main__":
    main()
