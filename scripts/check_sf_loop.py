#!/usr/bin/env python3
"""Quick check of the evaluation entry point and the TimeRFT sample-filtering
loop on one card: a kernel build, then `chip_smoke.py`'s phases 3f and 10
alone.

    python3 scripts/check_sf_loop.py

Phase 3f runs `python -m time_r1_tpu_torch.cli.evaluate`'s `main` at
reduced depth in f32 on the card and on the CPU through Engine, PagedEngine
and ContinuousEngine and holds the records equal. Phase 10 runs one SF round
of `cli.train_sf.main` on Qwen2.5-VL-3B (bf16, seeded weights, a native base
checkpoint): train, the smallest checkpoint, its self-eval, the difficulty
merge and the filter, with each stage's seconds and exact launch counts,
then a two-round handoff at 2 decoder layers. It writes up to 32 GB under
the temporary directory (TMPDIR), refuses to start with less free, and
deletes it at the end. Prints the card's name and power limit first and
phase 10's summary, beside the card, last. Needs a CUDA device and nvcc;
exits 2 without one.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # as chip_smoke.main

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("check_sf_loop: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    chip_smoke.phase_build()
    chip_smoke.phase_reduced_eval()
    chip_smoke.phase_sf_round(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
