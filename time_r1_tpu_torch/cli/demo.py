"""Single-video temporal grounding demo (port of `time_r1_tpu/cli/demo.py`,
the reference's demo.py).

    python -m time_r1_tpu_torch.cli.demo --model_base CKPT \
        --video_path VIDEO --query "person sitting down in a chair."

The serving path of `cli/evaluate.py` for one request: `Engine` through
`TextEngine`, greedy. The demo's prompt template has leading and trailing
newlines: it is NOT the eval's r1 template (demo.py:15-21). Appends one
record to {output_dir}/tmp_output.jsonl and writes a timing summary. Runs on
the card unless `device` says otherwise. `--pipeline_parallel_size pp > 1`
serves through `parallel/pipeline.py::PPEngine(params, cfg, n_stages=pp)`
under torchrun (pp ranks, as JAX's `cli/demo.py:83-88`): every rank loads the
whole checkpoint on the host and keeps its stage; global rank 0 prints and
writes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..data.prompts import DEFAULT_SYS_PROMPT
from ..models.processor import Qwen25VLProcessor
from ..models.qwen25vl.convert import load_checkpoint
from ..sampler.engine import Engine, Request
from ..sampler.text_engine import TextEngine
from ..utils.parsing import extract_answer_tg
from ..video.pipeline import fetch_video

PROMPT_TEMPLATE = """
To accurately pinpoint the event "{}" in the video, determine the precise time period of the event.

Output your thought process within the <think> </think> tags, including analysis with either specific time ranges (xx.xx to xx.xx) in <timestep> </timestep> tags.

Then, provide the start and end times (in seconds, precise to two decimal places) in the format "start time to end time" within the <answer> </answer> tags. For example: "12.54 to 17.83".
"""


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Single-video temporal grounding demo (PyTorch/CUDA)")
    p.add_argument("--model_base", type=str, default="./ckpts/Time-R1-7B")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--output_dir", type=str, default="logs/demo")
    p.add_argument("--video_path", type=str, default="./assets/OHOFG.mp4")
    p.add_argument("--query", type=str, default="person sitting down in a chair.")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--total_pixels", type=int, default=3584 * 28 * 28)
    p.add_argument("--min_pixels", type=int, default=16 * 28 * 28)
    p.add_argument("--device", type=str, default="auto", help="accepted for recipe parity")
    p.add_argument("--pipeline_parallel_size", type=int, default=1,
                   help="stage-shard the decoder layers over a pipeline mesh (launch with torchrun)")
    return p.parse_args(argv)


def build_request(processor: Qwen25VLProcessor, args) -> Request:
    ele = {"video": args.video_path, "min_pixels": args.min_pixels, "total_pixels": args.total_pixels}
    frames, sample_fps = fetch_video(ele)
    messages = [
        {"role": "system", "content": [{"type": "text", "text": DEFAULT_SYS_PROMPT}]},
        {
            "role": "user",
            "content": [
                {"type": "video", "video": args.video_path},
                {"type": "text", "text": PROMPT_TEMPLATE.format(args.query)},
            ],
        },
    ]
    text = processor.apply_chat_template(messages, add_generation_prompt=True)
    proc = processor(text=[text], videos=[frames], fps=[sample_fps])
    ids = proc.input_ids[0][proc.attention_mask[0] == 1].tolist()
    return Request(
        input_ids=ids,
        patches=proc.pixel_values_videos,
        grid_thw=tuple(int(x) for x in proc.video_grid_thw[0]),
        second_per_grid_t=proc.second_per_grid_ts[0],
    )


def main(args, engine: Engine = None, processor: Qwen25VLProcessor = None, device="cuda"):
    """Answer the query; returns (pred, output text)."""
    import torch.distributed as dist

    os.makedirs(args.output_dir, exist_ok=True)
    output_file = os.path.join(args.output_dir, "tmp_output.jsonl")

    if engine is None:
        pp = getattr(args, "pipeline_parallel_size", 1) or 1
        if pp > 1:
            from ..parallel import maybe_init_distributed
            from ..parallel.pipeline import PPEngine

            dev = maybe_init_distributed(device) or device
            params, cfg = load_checkpoint(args.model_base, device="cpu")  # each rank keeps its stage
            world = dist.get_world_size() if dist.is_initialized() else 1
            if world < pp:
                raise ValueError(f"pipeline_parallel_size={pp} × tensor_parallel_size=1 needs {pp} devices "
                                 f"but only {world} exist (torchrun --nproc_per_node {pp})")
            engine = PPEngine(params, cfg, n_stages=pp, dtype=params["text"]["norm"].dtype, device=dev)
        else:
            params, cfg = load_checkpoint(args.model_base, device=device)
            engine = Engine(params, cfg, device=device)
        processor = Qwen25VLProcessor.from_pretrained(args.model_base)
    text_engine = TextEngine(engine, processor)

    # the demo's fixed metadata (demo.py:166-174)
    target = [1.0, 7.5]
    duration = 35.04

    request = build_request(processor, args)
    t0 = time.perf_counter()
    output_texts = text_engine.generate([request], max_new_tokens=args.max_new_tokens)
    pred = extract_answer_tg(output_texts[0])
    if dist.is_initialized() and dist.get_rank() != 0:  # over a mesh global rank 0 prints and writes
        return pred, output_texts[0]
    print(output_texts[0], pred)
    with open(output_file, "a+") as f:
        f.write(json.dumps({"pred": pred, "target": target, "duration": duration,
                            "output_text": output_texts[0]}) + "\n")
    total = time.perf_counter() - t0
    print(f"\n--- Timing Summary ---\nTotal program execution time: {total:.2f} seconds")
    with open(os.path.join(args.output_dir, "timing_summary_vllm.txt"), "w") as f:
        f.write("\n--- Timing Summary ---\n")
        f.write(f"Total program execution time: {total:.2f} seconds\n")
    return pred, output_texts[0]


if __name__ == "__main__":
    main(get_args())
