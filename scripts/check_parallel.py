#!/usr/bin/env python3
"""Quick check of the port's parallelism on the card: a kernel build, then
`chip_smoke.py`'s phase 13 ((a) ring attention over 2 and 4 ranks against
one process's K1/B1/B2, (b) the context-parallel GRPO loss and gradients of
Qwen2.5-VL-3B over 2 ranks against one process's, (c) a data-parallel
step_batch over 2 ranks against one process over both examples, then
`cli.train.main` with --context_parallel_size 2) and phase 14 ((d) the 3B's
split loss step under remat as FSDP (2x1) and TP (1x2) against one process's,
after phase 2's K1, B1, B2, S1, S2, K2 and K3 cases at the TP-local heads;
(e) step_batch over TP with int8 rollouts, `cli.train.main
--tensor_parallel_size 2` and FSDP with offload_optimizer; (f), asked for by
name only and on 4 cards, Qwen2.5-VL-7B's full parameters over NCCL on 4x1,
2x2 and 1x4 meshes), phase 15 as (h) (phase 2's D2 and Q2 cases at the
TP-local shapes first; then the TP Engine and PPEngine over 2 ranks against
one process's, and `cli.evaluate --tensor_parallel_size 2` /
`--pipeline_parallel_size 2` and `cli.demo --pipeline_parallel_size 2`),
and (g), asked for by name only and on 4 cards: Qwen2.5-VL-7B served over
NCCL by the TP Engine at tp 4, PPEngine at 4 stages and at 2 stages of tp 2,
against one card's (in bf16 at full depth, and in f32 at 4 layers). (h) also
runs phase 16 in phase 15's spawn (PagedEngine, ContinuousEngine and the
int4 TP Engine over 2 ranks against one process's, `cli.evaluate` with
`scripts/test.sh`'s continuous int8 flags at tp 2 and the continuous flag
under pp 2), after phase 2's P1 / P2 and Q1 cases at the TP-local shapes.
(i), asked for by name only and on 4 cards: Qwen2.5-VL-7B at full depth
through `cli.evaluate --tensor_parallel_size 4` over NCCL with
`scripts/test.sh`'s eval flags (continuous batching over the paged pool,
int8 KV pages), int8 and int4 weights, against one card's `cli.evaluate`
(the records, decode ms a step, the weights and the peak a rank; writes
~16 GB under TMPDIR). The ranks are processes over gloo, all on the first
card; where the machine shows several cards, (a), (c), (d), (e) and (h) run
again over NCCL, a card a rank (with --nccl, phases 14-16 only over NCCL).
(j), asked for by name only and on 4 cards: Qwen2.5-VL-3B past its 2 kv
heads (each replicated on 2 ranks) at full depth over NCCL: `cli.evaluate
--tensor_parallel_size 4` with `scripts/test.sh`'s eval flags, plain (the
checkpoint read in f32: records equal one card's) and continuous with int8
weights and int8 pages, and `cli.train --tensor_parallel_size 4` for 2
step_batch calls (losses within 2e-2 of one card's); then tp 8 over 8 gloo
ranks on the first card at 2 decoder layers (the TP Engine at G = 8 and one
step_batch against one process's; writes ~24 GB under TMPDIR). (k): phase 2's
K1, B1, B2, S1, S2, K2, K3, D2, P1, P2, Q1 and Q2 cases at the TP-local
shapes (the 3B at tp 4 and 8 among them), then phase 17: the 3B at tp 4
over 4 gloo ranks on one card (the TP Engine, PagedEngine over int8, one
step_batch) against one process's.
(l): phase 19 alone: phase 2's K1, B1, B2, S1, S2, K2 and K3 cases at
the 3B's TP-local heads, then (a) LoRA r 16 over a 1x2 mesh (one
step_batch with int8 rollouts, bf16 and f32) and (c) an FSDP step with
data rank 1's example text-only and the ViT trained, in one spawn of 2
gloo ranks, and (b) the 3B's CP loss on a 2x2 mesh (CP 2, TP 2) and (d)
LoRA under CP on it, in one spawn of 4, each against one process's. (m),
asked for by name only and on 4 cards: Qwen2.5-VL-7B's LoRA r 16 over
its bf16 base at full depth through `cli.train --use_peft true
--tensor_parallel_size 4` over NCCL, 2 step_batch calls, against one
card's LoRA run (writes ~16 GB under TMPDIR).
Given parts among a-m, only those run; none runs a, b, c, d, e and h.

    python3 scripts/check_parallel.py [--nccl] [a] [b] [c] [d] [e] [f] [g] [h] [i] [j] [k] [l] [m]

Writes up to 15 GB under the temporary directory (TMPDIR) and deletes it.
Prints the card's name and power limit first. Needs a CUDA device and nvcc;
exits 2 without one.
"""

import argparse
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # as chip_smoke.main

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main(parts, nccl_only: bool = False) -> int:
    if not torch.cuda.is_available():
        print("check_parallel: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    parts = "".join(sorted(set(parts))) or "abcdeh"
    t0 = time.perf_counter()
    chip_smoke.phase_build()
    if set(parts) & set("abc"):
        chip_smoke.phase_parallel(card, "".join(p for p in parts if p in "abc"))
    if set(parts) & set("def"):
        if "d" in parts:  # phase 2's cases at the local heads before any rank runs them
            results = {name: {} for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "shared_prefix_fwd",
                                             "shared_prefix_bwd", "window_attention_rope", "full_attention_rope")}
            for tag, shape in chip_smoke.TP_ATTN.items():
                for dtype in (torch.bfloat16, torch.float32):
                    chip_smoke.attention_head_cases(results, shape, tag if dtype is torch.bfloat16 else f"{tag}_f32",
                                                    dtype)
            chip_smoke.vision_local_head_cases(torch.Generator(device="cuda").manual_seed(0), results)
        chip_smoke.phase_sharded(card, "".join(p for p in parts if p in "def"), nccl_only=nccl_only)
    if "h" in parts:  # phase 2's D2, Q2, P1, P2 and Q1 at the TP-local shapes before any rank runs them
        chip_smoke.tp_decode_quant_cases(torch.Generator(device="cuda").manual_seed(9),
                                         {"shared_prefix_decode_full": {}, "fused_mlp_int8": {}})
        chip_smoke.tp_paged_q1_cases(torch.Generator(device="cuda").manual_seed(11),
                                     {"paged_prefix_attention": {}, "paged_prefix_attention_q8": {},
                                      "int4_matmul": {}})
        chip_smoke.phase_mesh_serving(card, nccl_only=nccl_only)
    if "g" in parts:
        chip_smoke.phase_mesh_7b(card)
    if "i" in parts:
        chip_smoke.phase_eval_7b(card)
    if "k" in parts:  # phase 2's cases at the TP-local shapes, then phase 17
        results = {name: {} for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "shared_prefix_fwd",
                                         "shared_prefix_bwd", "window_attention_rope", "full_attention_rope",
                                         "shared_prefix_decode_full", "fused_mlp_int8", "paged_prefix_attention",
                                         "paged_prefix_attention_q8", "int4_matmul")}
        for tag, shape in chip_smoke.TP_ATTN.items():
            for dtype in (torch.bfloat16, torch.float32):
                chip_smoke.attention_head_cases(results, shape, tag if dtype is torch.bfloat16 else f"{tag}_f32", dtype)
        chip_smoke.vision_local_head_cases(torch.Generator(device="cuda").manual_seed(0), results)
        chip_smoke.tp_decode_quant_cases(torch.Generator(device="cuda").manual_seed(9), results)
        chip_smoke.tp_paged_q1_cases(torch.Generator(device="cuda").manual_seed(11), results)
        chip_smoke.phase_kv_replication(card)
    if "j" in parts:
        chip_smoke.phase_three_b_tp4(card)
    if "l" in parts:  # phase 2's cases at the local heads, then phase 19 in the spawns of phases 14 and 17
        results = {name: {} for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "shared_prefix_fwd",
                                         "shared_prefix_bwd", "window_attention_rope", "full_attention_rope")}
        for dtype in (torch.bfloat16, torch.float32):
            chip_smoke.attention_head_cases(results, chip_smoke.TP_ATTN["3B_tp2_G8"],
                                            "3B_tp2_G8" if dtype is torch.bfloat16 else "3B_tp2_G8_f32", dtype)
        chip_smoke.vision_local_head_cases(torch.Generator(device="cuda").manual_seed(0), results)
        sharded = chip_smoke.phase_sharded(card, "l")
        kvrep = chip_smoke.phase_kv_replication(card, runs=(), step=False, a13=True)
        chip_smoke.a13_summary(card, sharded["a13"], kvrep["a13"])
    if "m" in parts:
        chip_smoke.phase_lora_7b_tp4(card)
    chip_smoke.close_rank_pool()
    chip_smoke.log(f"[env] check_parallel: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="chip_smoke.py's phases 13-17 and 19, or parts a-m of them")
    parser.add_argument("parts", nargs="*", choices=["a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m"])
    parser.add_argument("--nccl", action="store_true", help="phases 14-16 over NCCL only (several cards)")
    args = parser.parse_args()
    sys.exit(main(args.parts, args.nccl))
