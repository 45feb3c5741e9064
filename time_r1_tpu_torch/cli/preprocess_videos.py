"""Offline video preprocessing (port of `time_r1_tpu/cli/preprocess_videos.py`,
the reference's src/utils/preprocess_dataset.py).

    python -m time_r1_tpu_torch.cli.preprocess_videos --train_data_path train.json \
        --video_folder videos/ --output_dir charades_preprocessed [--num_workers 16]

Decodes and budget-resizes each video once (`video.pipeline.fetch_video`)
and stores `video.npz` (frames TCHW float32, fps) and `video_kwargs.json`
under `output_dir/<video id>`, skipping a video whose directory exists. The
fine-tuning trainer reads them instead of decoding (`cli/finetune.py`,
`GRPOTrainer._load_frames`). Videos are processed by a pool of spawned
processes; a video that fails is reported and counted, and the others go on, as the
reference's script does (preprocess_dataset.py:94-98).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os

import numpy as np

from ..video import pipeline


def preprocess_single_video(task_args):
    """(video_path, total_pixels, min_pixels, out_dir) → a status dict."""
    video_path, total_pixels, min_pixels, out_dir = task_args
    try:
        if os.path.exists(out_dir):
            return {"preprocessed_path": out_dir, "status": "success"}
        frames, fps = pipeline.fetch_video({"video": video_path, "total_pixels": total_pixels,
                                            "min_pixels": min_pixels})
        os.makedirs(out_dir, exist_ok=True)
        np.savez_compressed(os.path.join(out_dir, "video.npz"), video=frames.astype(np.float32), fps=fps)
        with open(os.path.join(out_dir, "video_kwargs.json"), "w") as f:
            json.dump({"fps": [fps]}, f)
        return {"preprocessed_path": out_dir, "status": "success"}
    except Exception as e:  # the reference's per-video tolerance (preprocess_dataset.py:94-98)
        print(f"Warning: Preprocessing failed for video {video_path}: {e}")
        return {"video_path": video_path, "status": "failed", "error": str(e)}


def process_split(file_path, video_folder, output_dir, total_pixels, min_pixels, num_workers=8):
    """Preprocess every video of an annotation file: a dict keyed by video id
    (Charades/ActivityNet) or a list of items with a "video" (an id, or a
    path). Returns the successful results."""
    with open(file_path) as f:
        data = json.load(f)
    tasks = []
    items = data.items() if isinstance(data, dict) else ((d["video"], d) for d in data)
    for video_id, _ in items:
        video_path = None
        if os.path.isfile(str(video_id)):
            video_path = str(video_id)
            video_id = os.path.splitext(os.path.basename(video_path))[0]
        else:
            for ext in ("mp4", "mkv", "webm"):
                cand = os.path.join(video_folder, f"{video_id}.{ext}")
                if os.path.isfile(cand):
                    video_path = cand
                    break
        if video_path is None:
            print(f"Warning: Video file not found for ID: {video_id}")
            continue
        tasks.append((video_path, total_pixels, min_pixels, os.path.join(output_dir, video_id)))

    ok, failed = [], 0
    if num_workers <= 1:
        results = list(map(preprocess_single_video, tasks))
    else:
        # spawned workers: the parent may run threads (torch's), which fork does not carry safely
        with mp.get_context("spawn").Pool(processes=num_workers) as pool:
            results = list(pool.imap_unordered(preprocess_single_video, tasks))
    for r in results:
        if r["status"] == "success":
            ok.append(r)
        else:
            failed += 1
    print(f"Preprocessing finished. Failed: {failed}, Successful: {len(ok)}")
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(description="Offline video preprocessing for the fine-tuning recipes")
    p.add_argument("--dataset", type=str, default="charades")
    p.add_argument("--train_data_path", type=str, required=True)
    p.add_argument("--video_folder", type=str, required=True)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--max_pix_size", type=int, default=3584)
    p.add_argument("--min_pix_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=16)
    args = p.parse_args(argv)
    out = args.output_dir or f"./{args.dataset}_preprocessed_data_maxpix_{args.max_pix_size}"
    os.makedirs(out, exist_ok=True)
    process_split(args.train_data_path, args.video_folder, out, args.max_pix_size * 28 * 28,
                  args.min_pix_size * 28 * 28, args.num_workers)
    print("Preprocessing complete. Datasets saved to:", out)


if __name__ == "__main__":
    main()
