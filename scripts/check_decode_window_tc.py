#!/usr/bin/env python3
"""Quick check of the bf16 tensor-core D2 (G-way decode attention) and K2
(vision window attention) on one card: a build, then `chip_smoke.py`'s
phase-2 checks of D1, D2, K2 and K2's edge cases alone.

    python3 scripts/check_decode_window_tc.py

It prints the card, the build's ptxas report (registers, spill) and the
tensor-core blocks' shared memory; D1 and D2 against their plain versions
at the rollout's shape in bf16 and f32 over caches in the activation dtype
and int8 (suffix lengths 0, 1, 199, Lp 2000), D2 at `chip_smoke.D2_TC_CASES`
(the 7B rollout's N = 56 over 4 kv heads, 16 rollouts a prompt at N = 128
and 112, head dim 64, two prompts, a fully masked first int8 chunk), two D2
launches bit-equal in each, the refusals (f16, head dim 96); K2 at the serving shape and at `chip_smoke.K2_TC_CASES` (head dims
64 and 128, a fully dead window) and its refusals; each with device times
(CUDA events behind a GPU spin), the plain version's and one SDPA call's.
Needs a CUDA device and nvcc; exits 2 without one.
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
    results = chip_smoke.decode_kernels(torch.Generator(device="cuda").manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(0)
    results.update(chip_smoke.window_kernel(gen))
    print(json.dumps(results), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
