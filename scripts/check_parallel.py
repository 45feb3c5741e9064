#!/usr/bin/env python3
"""Quick check of data and context parallelism on one card: a kernel build,
then `chip_smoke.py`'s phase 13 alone: (a) ring attention over 2 and 4 ranks
against one process's K1/B1/B2, (b) the context-parallel GRPO loss and
gradients of Qwen2.5-VL-3B over 2 ranks against one process's, (c) a
data-parallel step_batch over 2 ranks against one process over both
examples, then `cli.train.main` with --context_parallel_size 2. The ranks are
processes over gloo, all on the first card. Given parts among a, b and c,
only those run.

    python3 scripts/check_parallel.py [a] [b] [c]

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


def main(parts) -> int:
    if not torch.cuda.is_available():
        print("check_parallel: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    t0 = time.perf_counter()
    chip_smoke.phase_build()
    chip_smoke.phase_parallel(card, "".join(sorted(set(parts))) or "abc")
    chip_smoke.log(f"[env] check_parallel: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="chip_smoke.py's phase 13, or parts a, b, c of it")
    parser.add_argument("parts", nargs="*", choices=["a", "b", "c"])
    sys.exit(main(parser.parse_args().parts))
