"""Benchmark annotation loaders (port of the JAX package's `data/loaders.py`;
the upstream src/vllm_inference/data/data_loader.py).

Each loader returns a list of dicts. TG datasets: {video, duration, timestamp,
sentence, qid[, video_start, video_end, pred]}. MCQ datasets: {video, question,
options, answer (0-based), duration, qid[, video_start, video_end]}.

qid formats and row ordering are the upstream ones, so sharded jsonl outputs
and the resume-by-qid mechanism interoperate. The loaders share two emission
shapes: sentence-grounding rows (activitynet/charades) and option-letter MCQ
parsing (videomme/egoschema/tempcompass). pandas (csv, parquet) is imported
only by the loaders that read those formats.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Tuple

DATA_ROOT = os.environ.get("TIMER1_DATA_ROOT", "./dataset")

_VIDEO_EXTS = ("mp4", "mkv", "webm")


def _read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _probe_video(video_dir: str, stem: str) -> str:
    """First existing {video_dir}/{stem}.{ext}; asserts one exists."""
    for ext in _VIDEO_EXTS:
        cand = os.path.join(video_dir, f"{stem}.{ext}")
        if os.path.exists(cand):
            return cand
    raise AssertionError(stem)


def _grounding_rows(
    prefix: str,
    videos: Iterable[Tuple[str, float, list, list]],
) -> List[dict]:
    """Flatten (video_path, duration, timestamps, sentences) groups into TG
    rows with a running qid — the emission shape shared by the
    sentence-temporal-grounding benchmarks."""
    rows: List[dict] = []
    for video_path, duration, timestamps, sentences in videos:
        for ts, sent in zip(timestamps, sentences):
            rows.append(
                {
                    "video": video_path,
                    "duration": duration,
                    "timestamp": ts,
                    "sentence": sent.strip(),
                    "qid": f"{prefix}_{len(rows)}",
                }
            )
    return rows


def _letter_options(options: Iterable[str]) -> List[str]:
    """Strip the 'A. ' / 'B. ' prefixes the MCQ sources carry."""
    return [op[2:].strip() for op in options]


def load_activitynet(split: str = "test") -> List[dict]:
    """data_loader.py:8-35 semantics; qid = activitynet_{i}."""
    root = f"{DATA_ROOT}/activitynet"
    anno = _read_json(f"{root}/annotations/sentence_temporal_grounding/{split}.json")
    return _grounding_rows(
        "activitynet",
        (
            (_probe_video(f"{root}/videos", vid), meta["duration"], meta["timestamps"], meta["sentences"])
            for vid, meta in anno.items()
        ),
    )


def _build_charades_json(txt_path: str, csv_path: str, out_path: str) -> dict:
    """One-time txt+csv → grouped-json conversion cache (the reference keeps
    the same artifact so both stacks can share it, data_loader.py:41-62)."""
    import pandas as pd

    durations = dict(zip(*(lambda df: (df["id"], df["length"]))(pd.read_csv(csv_path))))
    grouped: dict = {}
    with open(txt_path) as f:
        lines = f.readlines()
    for line in lines:
        if not line.strip():
            continue
        meta, sentence = line.split("##")
        video_id, start, end = meta.split(" ")
        entry = grouped.setdefault(
            video_id, {"duration": durations[video_id], "timestamps": [], "sentences": []}
        )
        entry["timestamps"].append([float(start), float(end)])
        entry["sentences"].append(sentence)
    with open(out_path, "w") as f:
        json.dump(grouped, f)
    return grouped


def load_charades(split: str = "test") -> List[dict]:
    """data_loader.py:38-81 semantics incl. the conversion cache."""
    root = f"{DATA_ROOT}/charades"
    json_path = f"{root}/Charades_anno/Charades_sta_{split}.json"
    if os.path.exists(json_path):
        grouped = _read_json(json_path)
    else:
        grouped = _build_charades_json(
            f"{root}/Charades_anno/Charades_sta_{split}.txt",
            f"{root}/Charades_anno/Charades_v1_{split}.csv",
            json_path,
        )
    return _grounding_rows(
        "charades",
        (
            (os.path.join(f"{root}/Charades_v1", f"{vid}.mp4"), meta["duration"], meta["timestamps"], meta["sentences"])
            for vid, meta in grouped.items()
        ),
    )


def load_tvgbench_filter(split: str) -> List[dict]:
    """data_loader.py:84-112: `split` is an explicit json path; rows keep
    their own qid + pred + video_start/end (the SF self-eval format)."""
    data = _read_json(split)
    keep = ("video", "duration", "timestamp", "sentence", "qid")
    return [
        {
            **{k: m[k] for k in keep},
            "pred": m.get("pred"),
            "video_start": m.get("video_start"),
            "video_end": m.get("video_end"),
        }
        for m in data
    ]


def load_tvgbench(split: str = "default") -> List[dict]:
    """data_loader.py:115-178 semantics: the in-repo 800-item benchmark;
    answer is an "s-e" string; qid = {source_stem}_{i}; rows with missing
    videos skipped."""
    raw = _read_json(f"{DATA_ROOT}/timer1/annotations/tvgbench.json")
    out: List[dict] = []
    source_prefix = "None"
    for item in raw:
        if not os.path.exists(item["path"]):
            continue
        if isinstance(item.get("source"), str):
            stem = os.path.splitext(os.path.basename(item["source"]))[0]
            source_prefix = stem.replace(".", "_").replace("-", "_")
        start_s, end_s = item["answer"].split("-")
        out.append(
            {
                "video": item["path"],
                "duration": item["duration"],
                "timestamp": [float(start_s), float(end_s)],
                "sentence": item["question"],
                "qid": f"{source_prefix}_{len(out)}",
                "start": item.get("start"),
                "end": item.get("end"),
            }
        )
    return out


def _iter_parquet(data_dir: str):
    import pandas as pd

    for name in sorted(os.listdir(data_dir)):
        if not name.endswith(".parquet"):
            continue
        df = pd.read_parquet(os.path.join(data_dir, name))
        yield from (row for _, row in df.iterrows())


def load_videomme(split: str = "default") -> List[dict]:
    """data_loader.py:181-206 semantics; split filters by duration class."""
    if split in ("test", "train"):
        split = "default"
    assert split in ("short", "medium", "long", "default")
    root = f"{DATA_ROOT}/videomme"
    return [
        {
            "video": os.path.join(f"{root}/data", itm["videoID"] + ".mp4"),
            "question": itm["question"],
            "options": _letter_options(itm["options"]),
            "answer": ord(itm["answer"]) - ord("A"),
            "duration": None,
            "qid": f'videomme_{itm["question_id"]}',
        }
        for itm in _iter_parquet(f"{root}/videomme")
        if split == "default" or itm["duration"] == split
    ]


def load_egoschema(split: str = "default") -> List[dict]:
    """data_loader.py:209-236 semantics."""
    if split in ("test", "train"):
        split = "default"
    assert split in ("default", "subset")
    root = f"{DATA_ROOT}/egoschema"
    source = f"{root}/Subset" if split == "subset" else f"{root}/MC"
    return [
        {
            "video": os.path.join(f"{root}/videos", itm["video_idx"] + ".mp4"),
            "question": itm["question"],
            "options": _letter_options(itm["option"]),
            "answer": itm["answer"],
            "duration": None,
            "qid": f'egoschema_{itm["question_idx"]}',
        }
        for itm in _iter_parquet(source)
    ]


def _parse_tempcompass_item(split: str, itm: dict) -> Tuple[str, list, int]:
    """Per-split question/options/answer extraction (data_loader.py:249-275)."""
    question, answer = itm["question"], itm["answer"]
    if split == "yes_no":
        options = ["yes", "no"]
        return question, options, options.index(answer)
    if split == "caption_matching":
        first, *rest = question.split("\n")
        options = [":".join(t.split(":")[1:]).strip() for t in rest]
        return first, options, options.index(":".join(answer.split(":")[1:]).strip())
    if split == "multi-choice":
        first, *rest = question.split("\n")
        return first, _letter_options(rest), ord(answer[0]) - ord("A")
    return question, [], answer  # captioning: free-form


def load_tempcompass(split: str = "default") -> List[dict]:
    """data_loader.py:239-283 semantics: 4 sub-splits."""
    if split in ("test", "train", "default"):
        split = "multi-choice"
    assert split in ("multi-choice", "captioning", "caption_matching", "yes_no")
    root = f"{DATA_ROOT}/tempcompass"
    out: List[dict] = []
    for key, dims in _read_json(f"{root}/questions/{split}.json").items():
        video_path = os.path.join(f"{root}/videos", key + ".mp4")
        for dim, items in dims.items():
            for idx, itm in enumerate(items):
                question, options, answer = _parse_tempcompass_item(split, itm)
                out.append(
                    {
                        "video": video_path,
                        "question": question,
                        "options": options,
                        "answer": answer,
                        "duration": None,
                        "qid": f"tempcompass|{split}|{key}|{dim}|{idx}",
                    }
                )
    return out


MVBENCH_VIDEO_DIRS = {
    "action_sequence": "video/star/Charades_v1_480/",
    "action_prediction": "video/star/Charades_v1_480/",
    "action_antonym": "video/ssv2_video/",
    "fine_grained_action": "video/Moments_in_Time_Raw/videos/",
    "unexpected_action": "video/FunQA_test/test/",
    "object_existence": "video/clevrer/video_validation/",
    "object_interaction": "video/star/Charades_v1_480/",
    "object_shuffle": "video/perception/videos/",
    "moving_direction": "video/clevrer/video_validation/",
    "action_localization": "video/sta/sta_video/",
    "scene_transition": "video/scene_qa/video/",
    "action_count": "video/perception/videos/",
    "moving_count": "video/clevrer/video_validation/",
    "moving_attribute": "video/clevrer/video_validation/",
    "state_change": "video/perception/videos/",
    "fine_grained_pose": "video/nturgbd/",
    "character_order": "video/perception/videos/",
    "egocentric_navigation": "video/vlnqa/",
    "episodic_reasoning": "video/tvqa/output_videos/",
    "counterfactual_inference": "video/clevrer/video_validation/",
}


def _mvbench_clip(video: str, start, end) -> str:
    """Pre-split clip filename scheme: {stem}_{start}_{end}.mp4 with '.'→'-'
    in the second fields (data_loader.py:330-342)."""
    stem = video.split(".mp4")[0]
    return f"{stem}_{str(start).replace('.', '-')}_{str(end).replace('.', '-')}.mp4"


def load_mvbench(split: str = "default") -> List[dict]:
    """data_loader.py:286-349 semantics: 20 sub-tasks; items carrying both
    start and end use pre-split clips under {video_dir}/split/."""
    root = f"{DATA_ROOT}/mvbench"
    out: List[dict] = []
    for file_name in sorted(os.listdir(f"{root}/json")):
        task = file_name.split(".")[0]
        video_dir = os.path.join(root, MVBENCH_VIDEO_DIRS[task])
        for qid, itm in enumerate(_read_json(os.path.join(f"{root}/json", file_name))):
            row = {
                "video": os.path.join(video_dir, itm["video"]),
                "question": itm["question"],
                "options": itm["candidates"],
                "answer": itm["candidates"].index(itm["answer"]),
                "duration": None,
                "qid": f"mvbench|{task}|{qid}",
            }
            if "start" in itm and "end" in itm:
                row["video"] = os.path.join(
                    video_dir, "split", _mvbench_clip(itm["video"], itm["start"], itm["end"])
                )
            else:
                if "start" in itm:
                    row["video_start"] = itm["start"]
                if "end" in itm:
                    row["video_end"] = itm["end"]
            out.append(row)
    return out


LOADERS = {
    "charades": load_charades,
    "activitynet": load_activitynet,
    "tvgbench": load_tvgbench,
    "tvgbench_filter": load_tvgbench_filter,
    "videomme": load_videomme,
    "mvbench": load_mvbench,
    "egoschema": load_egoschema,
    "tempcompass": load_tempcompass,
}

TG_DATASET_NAMES = ("charades", "activitynet", "tvgbench", "tvgbench_filter")
MCQ_DATASET_NAMES = ("videomme", "mvbench", "egoschema", "tempcompass")


def load_datasets(dataset_names, split: str) -> List[dict]:
    """_load_data parity (data/__init__.py:168-202): concatenates in order."""
    if isinstance(dataset_names, str):
        dataset_names = [dataset_names]
    data: List[dict] = []
    for name in dataset_names:
        data += LOADERS[name](split=split)
    return data


def split_data(data: List[dict], curr_idx: int, total_idx: int) -> List[dict]:
    """Contiguous shard by index (data/__init__.py:204-211)."""
    data_len = (len(data) + total_idx - 1) // total_idx
    st = curr_idx * data_len
    ed = min(len(data), st + data_len)
    return data[st:ed]
