"""Sharded, resumable batch evaluation (port of `time_r1_tpu/cli/evaluate.py`,
the reference's evaluate.py).

    python -m time_r1_tpu_torch.cli.evaluate --model_base CKPT \
        --datasets tvgbench_filter --split train.json --output_dir OUT [flags]

Flag names follow the reference CLI; `--datatype` is set from the dataset
names as evaluate.py:307-319 does. Writes per-line-flushed jsonl shards
`{datatype}_{curr}_{total}.jsonl`, resumed by qid, and a timing summary
(`timing_summary_vllm.txt`).

The generation engine:
- `Engine` through `TextEngine` by default (the SF loop's self-eval);
- `PagedEngine` with `--use_continuous_batching` and `--kv_block_size > 0`
  (max_len rounded up to the page size);
- `ContinuousEngine` with `--use_continuous_batching --kv_block_size 0`,
  which has no int8 KV cache (ValueError);
- `--quantization` and `--kv_cache_dtype` go to the `Engine` constructor,
  `--kv_cache_dtype` also to `PagedEngine`.
The continuous engines compute in the bucket engine's dtype. MCQ on the train
split is scored from the option letters' probabilities at the prompt's last
position (`Engine.last_token_logits`). An undecodable video still gets a
record (pred unparsable, scored 0 with the row in the denominator).

Runs on the card unless `device` says otherwise (the tests pass "cpu").

Over a mesh, under torchrun (JAX's `cli/evaluate.py:150-263`); every rank
loads the whole checkpoint on the host and keeps its part on its card:
- `--tensor_parallel_size tp > 1` without PP: the tensor-parallel `Engine`
  over `make_mesh(tp)` (data 1), tp ranks (`torchrun --nproc_per_node tp`);
  `--tp_group_index gi` puts local rank r on card gi·tp + r (ValueError where
  the machine shows fewer than tp·(gi+1) cards; group 0 shares one card over
  gloo where it shows fewer than tp);
- `--pipeline_parallel_size pp > 1`: `parallel/pipeline.py::PPEngine` over
  `make_pp_mesh(pp, tp)`, pp·tp ranks. Unset, tp is world // pp clamped to
  a divisor of the kv heads, and 1 under `--quantization`; too few ranks
  raise JAX's ValueError, and so does prob-based MCQ scoring (it needs the
  bucket engine);
- `--use_continuous_batching` under TP: `PagedEngine` / `ContinuousEngine`
  over the TP engine's serving tree and shard (JAX's `:216-251` hands them
  `engine.params`, which GSPMD splits), with `--quantization int8|int4` and
  `--kv_cache_dtype int8` as on one card; under PP the flag is ignored and
  `PPEngine` generates, as in JAX (`:216-217`);
- global rank 0 (model rank 0 of stage 0) writes the jsonl shard and the
  timing summary; the other ranks write nothing. Every rank reads the shard
  for the resume before any writes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np

from ..data.eval_dataset import EvalDataset
from ..data.prompts import ANSWER_PROMPT
from ..models.processor import Qwen25VLProcessor
from ..models.qwen25vl.convert import load_checkpoint
from ..sampler.continuous import ContinuousEngine
from ..sampler.engine import Engine
from ..sampler.paged import PagedEngine
from ..sampler.text_engine import TextEngine
from ..utils.parsing import extract_answer

DATASETS = ["charades", "activitynet", "videomme", "mvbench", "tvgbench_filter", "tvgbench", "egoschema",
            "tempcompass"]
MCQ_DATASETS = ("mvbench", "videomme", "tempcompass", "egoschema")
TG_DATASETS = ("tvgbench", "tvgbench_filter", "charades", "activitynet")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Sharded batch eval (PyTorch/CUDA)")
    p.add_argument("--datatype", default="tg", choices=["tg", "mcq"])
    p.add_argument("--model_base", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--output_dir", type=str, default="checkpoints")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--curr_idx", type=int, default=0)
    p.add_argument("--total_idx", type=int, default=1)
    p.add_argument("--total_pixels", type=int, default=3584 * 28 * 28)
    p.add_argument("--min_pixels", type=int, default=16 * 28 * 28)
    p.add_argument("--datasets", nargs="+", type=str, required=True, choices=DATASETS)
    p.add_argument("--use_r1_thinking_prompt", action="store_true")
    p.add_argument("--use_vllm_inference", action="store_true", help="accepted for recipe parity")
    p.add_argument(
        "--tensor_parallel_size",
        type=int,
        default=None,
        help="shard the model over a tensor-parallel mesh of this many ranks (launch with torchrun)",
    )
    p.add_argument(
        "--tp_group_index",
        type=int,
        default=0,
        help="which tensor-parallel device group this process uses; meaningful only with "
        "--tensor_parallel_size > 1",
    )
    p.add_argument(
        "--pipeline_parallel_size", type=int, default=1,
        help="stage-shard the decoder layers over a pipeline mesh (launch with torchrun)",
    )
    p.add_argument("--device", type=str, default="auto", help="accepted for recipe parity")
    p.add_argument(
        "--quantization",
        type=str,
        default="",
        choices=["", "int8", "int4"],
        help="weight-only quantized serving (vLLM --quantization capability; int4 halves int8's weight bytes)",
    )
    p.add_argument(
        "--kv_cache_dtype",
        type=str,
        default="",
        choices=["", "int8"],
        help="int8 KV cache for the decode phase (vLLM --kv-cache-dtype capability)",
    )
    p.add_argument("--prompt_type", type=str, default="r1")
    p.add_argument("--use_nothink", action="store_true")
    p.add_argument("--use_prepared_video", action="store_true")
    p.add_argument(
        "--use_continuous_batching",
        action="store_true",
        help="continuous batching over the paged KV pool (vLLM engine model); "
        "composes with --quantization and --kv_cache_dtype",
    )
    p.add_argument(
        "--kv_block_size",
        type=int,
        default=128,
        help="KV page size for continuous batching (vLLM --block-size); "
        "0: the slot-pool scheduler (a contiguous cache per slot)",
    )
    p.add_argument("--max_model_len", type=int, default=0, help="slot length for continuous batching (0: auto)")
    p.add_argument("--limit", type=int, default=0, help="stop after N items (0 = all)")
    p.add_argument(
        "--video_cache_size",
        type=int,
        default=8,
        help="entries of the in-process LRU cache of decoded videos (repeated videos decode once); 0 disables",
    )
    p.add_argument(
        "--num_workers",
        type=int,
        default=8,
        help="parallel host video-decode workers feeding the prefetch queue",
    )
    args = p.parse_args(argv)

    if any(d in args.datasets for d in MCQ_DATASETS):
        args.datatype = "mcq"
    elif any(d in args.datasets for d in TG_DATASETS):
        args.datatype = "tg"
    else:
        raise ValueError("Unsupported dataset type.")
    return args


def build_mesh_engine(args, device="cuda"):
    """The engine over a mesh (JAX's `cli/evaluate.py:150-197`): a
    `PPEngine` when --pipeline_parallel_size > 1, else the tensor-parallel
    `Engine`; returns (engine, processor). Joins torchrun's group first."""
    import torch.distributed as dist

    from ..parallel import ShardContext, make_mesh, maybe_init_distributed
    from ..parallel.pipeline import PPEngine

    pp = getattr(args, "pipeline_parallel_size", 1) or 1
    tp_arg = getattr(args, "tensor_parallel_size", None)
    gi = getattr(args, "tp_group_index", 0)
    quant = getattr(args, "quantization", "") or ""
    dev = maybe_init_distributed(device, first_card=gi * (tp_arg or 1) if pp <= 1 else 0) or device
    world = dist.get_world_size() if dist.is_initialized() else 1
    params, cfg = load_checkpoint(args.model_base, device="cpu")  # whole on the host; each rank keeps its part
    dtype = params["text"]["norm"].dtype  # the checkpoint's load dtype (bf16)
    if pp > 1:
        tp = tp_arg
        if tp is None:
            # the reference uses every device: tp = devices // pp (vllm_infer.py:50), clamped to a divisor
            # of the kv heads (whole GQA groups a rank); fused int8 columns cannot split
            tp = max(world // pp, 1)
            while tp > 1 and cfg.text.num_key_value_heads % tp != 0:
                tp -= 1
            if quant:
                tp = 1
        if world < pp * tp:
            raise ValueError(f"pipeline_parallel_size={pp} × tensor_parallel_size={tp} needs {pp * tp} devices "
                             f"but only {world} exist (torchrun --nproc_per_node {pp * tp})")
        engine = PPEngine(params, cfg, n_stages=pp, dtype=dtype, tp=tp, quantization=quant, device=dev)
        return engine, Qwen25VLProcessor.from_pretrained(args.model_base)
    tp = tp_arg
    if world != tp:
        raise ValueError(f"tensor_parallel_size={tp} group {gi} needs {tp} ranks (torchrun --nproc_per_node {tp}) "
                         f"but the group has {world}")
    engine = Engine(params, cfg, dtype=dtype, device=dev, quantization=quant or None,
                    kv_cache_quant=getattr(args, "kv_cache_dtype", "") == "int8",
                    shard=ShardContext.build(make_mesh(tp), params))
    return engine, Qwen25VLProcessor.from_pretrained(args.model_base)


def make_generation_engine(args, engine: Engine):
    """The engine that generates: `engine` itself, or a continuous-batching
    engine over its weights (evaluate.py:205-244), and over its shard under
    TP. A `PPEngine` (--pipeline_parallel_size > 1) generates itself: the
    flag is ignored there, as in JAX."""
    if not getattr(args, "use_continuous_batching", False) or (getattr(args, "pipeline_parallel_size", 1) or 1) > 1:
        return engine
    # max_model_len as the reference sizes it: total_pixels//28//28 + 4096 + max_new_tokens (vllm_infer.py:52)
    max_len = args.max_model_len or (args.total_pixels // 28 // 28 + 4096 + args.max_new_tokens)
    kv_block = getattr(args, "kv_block_size", 128)
    kv_quant = getattr(args, "kv_cache_dtype", "") == "int8"
    kw = dict(max_slots=max(args.batch_size, 1), max_len=max_len, dtype=engine.dtype, device=engine.device,
              shard=getattr(engine, "shard", None))
    if kv_block > 0:
        kw["max_len"] = -(-max_len // kv_block) * kv_block
        return PagedEngine(engine.params, engine.cfg, page_size=kv_block, kv_cache_quant=kv_quant, **kw)
    if kv_quant:
        raise ValueError(
            "--kv_cache_dtype int8 requires the paged pool "
            "(--kv_block_size > 0); the legacy slot engine is bf16-only"
        )
    return ContinuousEngine(engine.params, engine.cfg, **kw)


def failed_record(b: dict, datatype: str) -> dict:
    """The record of an undecodable video: its pred is unparsable, so it
    scores 0.0 with the row in the denominator (the reference emits a
    prediction for every row through its backend fallback,
    vision_process.py:362-368; dropping rows would inflate calc_score), and a
    resume skips the row instead of trying it again."""
    return {
        "qid": b["qid"],
        "pred": [None, None] if datatype == "tg" else None,
        "target": list(b["timestamps"]) if datatype == "tg" else b["answer"],
        "duration": b.get("duration"),
        "output_text": "",
        "error": b.get("error", "video load failed"),
    }


def prob_records(engine: Engine, processor, batch: list) -> list:
    """MCQ on the train split: the option letters' softmax at each prompt's
    last position (the assistant-prefix answer prompt, evaluate.py:88,104-122)."""
    logits = engine.last_token_logits([b["request"] for b in batch])
    out = []
    for b, lg in zip(batch, logits):
        option_ids = [processor.tokenizer.encode(letter, add_special_tokens=False)[0] for letter in b["options"]]
        opt = lg[option_ids]
        probs = np.exp(opt - opt.max())
        probs = probs / probs.sum()
        out.append({
            "qid": b["qid"],
            "pred": int(probs.argmax()),
            "target": b["answer"],
            "duration": b.get("duration"),
            "probs": [float(p) for p in probs],
        })
    return out


def text_record(b: dict, text: str, datatype: str) -> dict:
    return {
        "qid": b["qid"],
        "pred": extract_answer(text, "tg") if datatype == "tg" else None,
        "target": list(b["timestamps"]) if datatype == "tg" else b["answer"],
        "duration": b.get("duration"),
        "output_text": text,
    }


def main(args, engine: Engine = None, processor: Qwen25VLProcessor = None, device="cuda"):
    """Evaluate as the flags ask; returns the jsonl shard's path. A given
    `engine` (and `processor`) is used as is; otherwise both load from
    --model_base onto `device` (over a mesh, `build_mesh_engine`)."""
    import torch.distributed as dist

    pp = getattr(args, "pipeline_parallel_size", 1) or 1
    mesh = pp > 1 or (getattr(args, "tensor_parallel_size", None) or 1) > 1
    # mcq + train split: probability-based scoring over the option letters
    prob_mode = args.datatype == "mcq" and args.split == "train"
    if prob_mode and pp > 1:
        raise ValueError("prob-based MCQ scoring needs the bucket engine; it is unavailable under "
                         "--pipeline_parallel_size > 1")
    os.makedirs(args.output_dir, exist_ok=True)
    output_file = os.path.join(args.output_dir, f"{args.datatype}_{args.curr_idx}_{args.total_idx}.jsonl")

    already_finished = set()
    try:
        with open(output_file) as g:
            for line in g:
                already_finished.add(json.loads(line)["qid"])
    except Exception:
        pass

    if engine is None and mesh:
        engine, processor = build_mesh_engine(args, device)
    elif engine is None:
        params, cfg = load_checkpoint(args.model_base, device=device)
        engine = Engine(
            params,
            cfg,
            device=device,
            quantization=getattr(args, "quantization", "") or None,
            kv_cache_quant=getattr(args, "kv_cache_dtype", "") == "int8",
        )
        processor = Qwen25VLProcessor.from_pretrained(args.model_base)
    text_engine = TextEngine(make_generation_engine(args, engine), processor)
    # over a mesh global rank 0 writes; every rank has read the shard for the resume before it does
    writes = not dist.is_initialized() or dist.get_rank() == 0
    if dist.is_initialized():
        dist.barrier()

    dataset = EvalDataset(
        processor,
        datatype=args.datatype,
        dataset_names=args.datasets,
        split=args.split,
        curr_idx=args.curr_idx,
        total_idx=args.total_idx,
        already_finished=already_finished,
        min_pixels=args.min_pixels,
        total_pixels=args.total_pixels,
        use_r1_thinking_prompt=args.use_r1_thinking_prompt,
        prompt_type=args.prompt_type,
        use_nothink=args.use_nothink,
        use_prepared_video=args.use_prepared_video,
        use_answer_prompt=prob_mode,
        cache_size=getattr(args, "video_cache_size", 8),
        num_workers=getattr(args, "num_workers", 8),
    )
    answer_prompt = ANSWER_PROMPT if args.datatype == "mcq" and args.split != "train" else None

    t0 = time.perf_counter()
    n_done = 0
    limit = getattr(args, "limit", 0)
    with open(output_file, "a+") if writes else contextlib.nullcontext() as f:
        def write(rec: dict) -> None:
            nonlocal n_done
            if writes:
                f.write(json.dumps(rec) + "\n")
                f.flush()
            n_done += 1

        for batch in dataset.iter_batches(args.batch_size):
            if limit and n_done >= limit:
                break
            for b in batch:
                if b.get("failed"):
                    write(failed_record(b, args.datatype))
            batch = [b for b in batch if not b.get("failed")]
            if not batch:
                continue
            if prob_mode:
                for rec in prob_records(engine, processor, batch):
                    write(rec)
                continue
            outputs = text_engine.generate(
                [b["request"] for b in batch], max_new_tokens=args.max_new_tokens, answer_prompt=answer_prompt
            )
            for b, text in zip(batch, outputs):
                write(text_record(b, text, args.datatype))

    total = time.perf_counter() - t0
    if not writes:
        return output_file
    print(f"\n--- Timing Summary ---\nTotal program execution time: {total:.2f} seconds")
    with open(os.path.join(args.output_dir, "timing_summary_vllm.txt"), "w") as tf:
        tf.write("\n--- Timing Summary ---\n")
        tf.write(f"Total program execution time: {total:.2f} seconds\n")
        tf.write(f"Items evaluated: {n_done}\n")
    return output_file


if __name__ == "__main__":
    main(get_args())
