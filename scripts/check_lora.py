#!/usr/bin/env python3
"""Quick check of LoRA GRPO on one card: a kernel build, then
`chip_smoke.py`'s LoRA parts alone: phase 2's attention kernels at the 7B's
head layout (K1, B1, B2, S1, S2 at 28 q heads over 4 kv heads), phase 3's
side-path forward and in-layer merged loss (card against CPU), phase 3e's
captured decode (its eight configurations, the two LoRA ones with a second
adapter set) and phase 11 (LoRA GRPO on the 7B over an int8 base through
`cli.train.main`, the bf16-base route with int8 rollouts, a resumed run).

    python3 scripts/check_lora.py

Phase 11 writes up to 40 GB under the temporary directory (TMPDIR), refuses
to start with less free, and deletes it at the end. Prints the card's name
and power limit first and phase 11's summary, beside the card, last. Needs a
CUDA device and nvcc; exits 2 without one.
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
        print("check_lora: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    chip_smoke.phase_build()
    names = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "shared_prefix_fwd", "shared_prefix_bwd")
    results = {name: {"name": name} for name in names}
    chip_smoke.attention_7b_cases(results)
    chip_smoke.phase_reduced_lora()
    chip_smoke.phase_captured_decode()
    chip_smoke.phase_lora_7b(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
