#!/usr/bin/env python3
"""Quick check of Q1, the int4 dequant-matmul (`csrc/int4_matmul.cu`), on one
card: a build, then `chip_smoke.py`'s phase-2 Q1 checks alone.

    python3 scripts/check_int4_matmul_tc.py

It prints the card, the build's ptxas report (registers, spill) and Q1's
tensor-core block layouts; Q1 against its plain version at
`chip_smoke.Q1_CASES` and the ragged shape in bf16 and f32, each launch's
route, two bf16 launches bit-equal, the refusals; and device times (CUDA
events behind a GPU spin) at `chip_smoke.Q1_TIMED` beside the bound, the
library's and PyTorch's sum over the same bytes. Needs a CUDA device and
nvcc; exits 2 without one.
"""

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    chip_smoke.phase_build()
    result = chip_smoke.q1_kernel(torch.Generator(device="cuda").manual_seed(3))
    print(json.dumps(result), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
