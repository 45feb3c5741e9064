#!/usr/bin/env python3
"""The captured decode on the card, alone: `chip_smoke.py` phase 1 (the
kernel build), phase 2's D1/D2 checks and times (D2 reads its suffix length
from device memory), then phase 3e (replay against the eager loop in six
configurations at reduced depth, and one replayed step's launches by
torch.profiler). Needs a CUDA device and nvcc; exits 2 without a card.

    python3 scripts/check_captured_decode.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # as chip_smoke.py's main

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    chip_smoke.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}")
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    chip_smoke.phase_build()
    d2 = chip_smoke.decode_kernels(torch.Generator(device="cuda").manual_seed(3))
    result = {"d2": {k: v for k, v in d2["shared_prefix_decode_full"].items() if k != "cases"},
              "captured": chip_smoke.phase_captured_decode()}
    print(json.dumps(result), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
