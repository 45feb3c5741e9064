"""The TimeRFT sample-filtering (SF) loop (port of `time_r1_tpu/cli/train_sf.py`,
the reference's scripts/posttrain/train_rl_SF.sh).

    python -m time_r1_tpu_torch.cli.train_sf --model_name_or_path BASE \
        --exp_dir EXP --initial_data train.json [--rounds 5 --k 2500 ...]

One Python loop in place of the reference's three programs a round: train (5
epochs in round 0, 1 after, early-stopped, a checkpoint each epoch), take
the round's smallest checkpoint-N, self-evaluate it on the round's training
data, merge difficulty = tIoU × 100 into the annotations, and filter and
re-sample the next round's data. The artifacts stay on disk as the
reference leaves them (checkpoint directories, jsonl shards,
train_v4_cloud.json, the filtered json). The checkpoints carry their
tokenizer (`GRPOTrainer.save_checkpoint`), so each round's evaluate and the
next round's train load them as models.
"""

from __future__ import annotations

import argparse
import os
import re

from ..utils.curriculum import process_data_file
from . import calc_difficulty as calc_difficulty_cli
from . import evaluate as evaluate_cli
from . import train as train_cli


def smallest_checkpoint(output_dir: str) -> str:
    """train_rl_SF.sh:77-85: the SMALLEST-numbered checkpoint-* directory."""
    best, best_n = None, None
    for d in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", d)
        if m:
            n = int(m.group(1))
            if best_n is None or n < best_n:
                best, best_n = os.path.join(output_dir, d), n
    if best is None:
        raise FileNotFoundError(f"no checkpoint-* in {output_dir}")
    return best


def get_args(argv=None):
    p = argparse.ArgumentParser(description="TimeRFT SF loop (PyTorch/CUDA)")
    p.add_argument("--model_name_or_path", type=str, required=True)
    p.add_argument("--exp_dir", type=str, required=True)
    p.add_argument("--initial_data", type=str, required=True)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--k", type=int, default=2500)
    p.add_argument("--filter_task", type=str, default="0070_all")
    p.add_argument("--num_generations", type=int, default=8)
    p.add_argument("--max_completion_length", type=int, default=20)
    p.add_argument("--reward_funcs", nargs="+", default=["iou_v2", "format"])
    p.add_argument("--total_pixels", type=int, default=3584 * 28 * 28)
    p.add_argument("--eval_max_new_tokens", type=int, default=128)
    return p.parse_args(argv)


def main(args, device="cuda"):
    """Run the rounds; returns the last round's filtered data path. `device`
    goes to each round's train and evaluate (the tests pass "cpu")."""
    data_path = args.initial_data
    model_path = args.model_name_or_path
    for round_idx in range(args.rounds):
        round_dir = os.path.join(args.exp_dir, f"round_{round_idx}")
        os.makedirs(round_dir, exist_ok=True)

        # 1. train: 5 epochs in round 0, 1 epoch (early-stopped) after
        train_args = train_cli.get_args(
            [
                "--model_name_or_path", model_path,
                "--output_dir", round_dir,
                "--train_data_path", data_path,
                "--max_completion_length", str(args.max_completion_length),
                "--num_generations", str(args.num_generations),
                "--reward_funcs", *args.reward_funcs,
                "--num_train_epochs", "5" if round_idx == 0 else "1",
                "--is_early_stopping", "true",
                "--save_strategy", "epoch",
                "--total_pixels", str(args.total_pixels),
            ]
        )
        train_cli.main(train_args, device=device)

        # 2. the round's smallest checkpoint is the eval and next-train model
        ckpt = smallest_checkpoint(round_dir)

        # 3. self-evaluate it on the CURRENT TRAIN DATA
        eval_dir = os.path.join(round_dir, f"filtering_epoch{round_idx}")
        os.makedirs(eval_dir, exist_ok=True)
        eval_args = evaluate_cli.get_args(
            [
                "--model_base", ckpt,
                "--datasets", "tvgbench_filter",
                "--split", data_path,
                "--output_dir", eval_dir,
                "--use_r1_thinking_prompt",
                "--max_new_tokens", str(args.eval_max_new_tokens),
                "--total_pixels", str(args.total_pixels),
            ]
        )
        evaluate_cli.main(eval_args, device=device)

        # 4. the difficulty merge: train_v4_cloud.json
        merged = calc_difficulty_cli.merge(input_dir=eval_dir, split=data_path, output_dir=round_dir)

        # 5. filter and sample the next round's data
        data_path = process_data_file(merged, merged[:-5], task=args.filter_task, k=args.k)
        model_path = ckpt
        print(f"[SF] round {round_idx} done → next data: {data_path}")
    return data_path


if __name__ == "__main__":
    main(get_args())
