#!/usr/bin/env python3
"""Quick check of a GRPO run from the command line on one card: a kernel
build, then `chip_smoke.py`'s phase 9 alone.

    python3 scripts/check_train_loop.py

Phase 9 writes Qwen2.5-VL-3B (bf16, seeded weights) as an HF checkpoint
and reads it back bit-equal, runs `python -m time_r1_tpu_torch.cli.train`'s
`main` on it for one epoch of 4 examples (remat "full", every launch count,
the lr of each update, the checkpoints), resumes a 2-layer run from its
native checkpoint, and holds each remat policy's loss and gradients against
none. It writes up to 26 GB under the temporary directory (TMPDIR) and
refuses to start with less free. It prints the card's name and power limit
first and phase 9's summary, beside the card, last. Needs a CUDA device and
nvcc; exits 2 without one.
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
        print("check_train_loop: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    chip_smoke.phase_build()
    chip_smoke.phase_cli_train(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
