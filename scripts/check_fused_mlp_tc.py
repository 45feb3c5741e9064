#!/usr/bin/env python3
"""Quick check of Q2, the fused int8 SwiGLU MLP (`csrc/fused_mlp.cu`), on one
card: a build, then `chip_smoke.py`'s phase-2 Q2 checks alone.

    python3 scripts/check_fused_mlp_tc.py

It prints the card, the build's ptxas report (registers, spill) and Q2's
shared memory; Q2 against its plain version at `chip_smoke.Q2_CASES` in
bf16 and f32, two launches bit-equal, the refusals; and device times (CUDA
events behind a GPU spin) at the 3B rollout shape and at 7B beside the
plain version's, the library's and the bound. Needs a CUDA device and nvcc;
exits 2 without one.
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
    result = chip_smoke.q2_kernel(torch.Generator(device="cuda").manual_seed(3))
    print(json.dumps(result), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
