#!/usr/bin/env python3
"""Quick check of full-parameter GRPO on one card: a kernel build, then
`chip_smoke.py`'s phase 12 alone: (a) the 7B's full parameters with the
optimizer state in page-locked host memory, (b) offload against a
device-resident state bit for bit at 2 layers of the 7B's widths, (c) the
full-row loss on the 3B, (d) `cli.finetune.main` from
`cli.preprocess_videos`' npz files. Given parts among b, c and d, only those
run.

    python3 scripts/check_full_param_7b.py [b] [c] [d]

(a) pins about 43 GiB of host memory and refuses to start with less than
that plus 8 GiB available; (d) writes up to 26 GB under the temporary
directory (TMPDIR) and deletes it. Prints the card's name and power limit
first. Needs a CUDA device and nvcc; exits 2 without one.
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


def main(parts) -> int:
    if not torch.cuda.is_available():
        print("check_full_param_7b: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    t0 = time.perf_counter()
    chip_smoke.phase_build()
    if not parts:
        chip_smoke.phase_full_param_7b(card)
    runs = {"b": chip_smoke.offload_bit_equal, "c": chip_smoke.full_row_3b, "d": chip_smoke.finetune_3b}
    for part in sorted(set(parts)):
        runs[part](card)
    chip_smoke.log(f"[env] check_full_param_7b: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="chip_smoke.py's phase 12, or parts b, c, d of it")
    parser.add_argument("parts", nargs="*", choices=["b", "c", "d"])
    sys.exit(main(parser.parse_args().parts))
