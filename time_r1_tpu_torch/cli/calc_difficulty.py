"""Difficulty scoring of a self-eval (port of `time_r1_tpu/cli/calc_difficulty.py`,
the reference's src/vllm_inference/calc_difficulty.py).

    python -m time_r1_tpu_torch.cli.calc_difficulty --input EVAL_DIR \
        --split train.json --output_dir OUT

Reads the self-eval's jsonl shards, rescues unparsable predictions with the
first-two-numbers parser, computes difficulty = tIoU × 100 and merges it
(with the pred) into the annotation json as
`{output_dir}/{input}/train_v4_cloud.json`, the next SF round's input.
"""

from __future__ import annotations

import argparse
import json
import os

from ..data.loaders import load_tvgbench_filter
from ..utils.metrics import calc_difficulty
from ..utils.parsing import extract_answer_force


def load_new_data(data_dir: str) -> dict:
    """calc_difficulty.py:49-66: {qid: {difficulty, pred}}, the pred rescued
    when it is None or holds a None."""
    data = {}
    for file in os.listdir(data_dir):
        if "jsonl" not in file:
            continue
        with open(os.path.join(data_dir, file)) as f:
            for line in f:
                tmp = json.loads(line)
                pred = tmp["pred"]
                if pred is None or None in pred:
                    pred = extract_answer_force(tmp["output_text"])
                data[tmp["qid"]] = {"difficulty": calc_difficulty(pred, tmp["target"]), "pred": pred}
    return data


def print_scores(difficulty_by_qid: dict) -> None:
    vals = list(difficulty_by_qid.values())
    for tau in (30.0, 50.0, 70.0):
        cnt = len([v for v in vals if v["difficulty"] > tau])
        print(round(cnt / len(vals) * 100, 1))


def merge(input_dir: str, split: str, output_dir: str) -> str:
    """calc_difficulty.py:77-102: difficulty and pred merged into the
    annotations of `split`. The output path joins `input_dir` under
    `output_dir`, as the reference does."""
    original = load_tvgbench_filter(split=split)
    by_qid = load_new_data(input_dir)
    print(len(by_qid))
    print_scores(by_qid)

    new_data = []
    for itm in original:
        if itm["qid"] in by_qid:
            itm["difficulty"] = by_qid[itm["qid"]]["difficulty"]
            itm["pred"] = by_qid[itm["qid"]]["pred"]
            new_data.append(itm)
    if len(new_data) != len(original):
        print("Not All!! Attention!!")

    out_dir = os.path.join(output_dir, input_dir)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_v4_cloud.json")
    with open(path, "w") as f:
        json.dump(new_data, f)
    print(len(new_data))
    return path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", help="jsonl shard directory")
    p.add_argument("--split", help="annotation json path")
    p.add_argument("--output_dir")
    args = p.parse_args(argv)
    merge(input_dir=args.input, split=args.split, output_dir=args.output_dir)


if __name__ == "__main__":
    main()
