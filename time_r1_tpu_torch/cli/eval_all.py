"""Score aggregation (port of `time_r1_tpu/cli/eval_all.py`, the reference's
src/vllm_inference/eval_all.py).

    python -m time_r1_tpu_torch.cli.eval_all --model_name NAME [--dataset ...]

Finds the result directories ./logs/eval/{model_name}/*{dataset}*, scores
their jsonl shards (hull-union tIoU and R1@τ, or MCQ accuracy) and writes
scores.json into each. EgoSchema's answers are uploaded to its public
validation server instead (`eval_egoschema_online`; `requests` is imported
only there).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re

from ..utils.metrics import calc_score, score_mcq_records, score_tg_records

TG = ("charades", "activitynet", "tvgbench")
MCQ = ("mvbench", "videomme", "egoschema", "tempcompass")


def find_dataset_results(dataset_name: str, model_name: str, eval_root: str = "./logs/eval"):
    root = os.path.join(eval_root, model_name)
    return sorted(os.path.join(root, d) for d in os.listdir(root) if dataset_name in d)


def _jsonl_lines(data_dir: str):
    for file in os.listdir(data_dir):
        if "jsonl" not in file:
            continue
        with open(os.path.join(data_dir, file)) as f:
            for line in f:
                yield json.loads(line)


def load_records(data_dir: str):
    return list(_jsonl_lines(data_dir))


def score_dir(data_dir: str, dataset: str):
    recs = load_records(data_dir)
    if not recs:
        return None
    by_qid = score_tg_records(recs) if dataset in TG else score_mcq_records(recs)
    return calc_score(by_qid, dataset)


def eval_egoschema_online(data_dir: str, original_data, api_url: str):
    """eval_all.py:160-180: map qid to video id, parse the last (L) (a random
    letter when there is none) and upload."""
    import requests

    qid_to_vid = {itm["qid"]: itm["video"].split("/")[-1].split(".")[0] for itm in original_data}
    data = {}
    for tmp in _jsonl_lines(data_dir):
        matches = re.findall(r"\(([A-Z])\)", tmp["output_text"])
        if matches:
            pred = ord(matches[-1]) - ord("A")
        else:
            pred = ord(random.choice(["A", "B", "C", "D", "E"])) - ord("A")
        data[qid_to_vid[tmp["qid"]]] = pred
    try:
        r = requests.post(api_url, headers={"Content-Type": "application/json"}, json=data)
        r.raise_for_status()
        try:
            return r.json()
        except ValueError:
            return {"status": "success", "response_text": r.text}
    except Exception as e:
        return {"status": "error", "message": str(e)}


def main(argv=None):
    p = argparse.ArgumentParser(description="Score eval jsonl outputs")
    p.add_argument("--dataset", nargs="+", default=list(TG + MCQ), choices=list(TG + MCQ))
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--eval_root", type=str, default="./logs/eval")
    p.add_argument("--egoschema_api", type=str, default="https://validation-server.onrender.com/api/upload/")
    args = p.parse_args(argv)
    random.seed(42)

    for dataset in args.dataset:
        print(f"==========={dataset}===========")
        for data_dir in find_dataset_results(dataset, args.model_name, args.eval_root):
            print(f"data_dir: {data_dir}")
            if dataset == "egoschema":
                from ..data.loaders import load_egoschema

                result = eval_egoschema_online(data_dir, load_egoschema(), args.egoschema_api)
                print(result)
                with open(os.path.join(data_dir, "scores.json"), "w") as f:
                    json.dump(result, f, indent=4)
                continue
            if "captioning" in data_dir:
                continue
            scores = score_dir(data_dir, dataset)
            if scores is None:
                continue
            for k, v in scores.items():
                print(f"IoU R1@ {k}: {v}" if dataset in TG else f"{k}: {v}")
            with open(os.path.join(data_dir, "scores.json"), "w") as f:
                json.dump(scores, f, indent=4)


if __name__ == "__main__":
    main()
