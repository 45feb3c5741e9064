#!/usr/bin/env python3
"""Quick check of the port's host input path on one card: a kernel build,
then `chip_smoke.py`'s phase 8 alone.

    python3 scripts/check_input_path.py

Phase 8 drives Qwen2.5-VL-3B (bf16, random weights, a reference copy) from
video frames: seeded raw frames at 360x640 in place of the decoder, the
port's planner, resize and processor over a stand-in tokenizer, the resize
on the card (TF32 requested by the caller) against the host's, one served
32 s clip and two `step_batch` calls with requests=None, every launch count
checked. It prints the card's name and power limit first and phase 8's
summary, beside the card, last. Needs a CUDA device and nvcc; exits 2
without one.
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
        print("check_input_path: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    chip_smoke.phase_build()
    chip_smoke.phase_input_path(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
