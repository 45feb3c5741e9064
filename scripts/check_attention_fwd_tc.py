#!/usr/bin/env python3
"""Quick check of the bf16 tensor-core attention forwards (K1 flash
attention, K3 full-slice vision attention with the rope) on one card: a
build, then `chip_smoke.py`'s phase-2 checks of K1, K2 and K3 alone.

    python3 scripts/check_attention_fwd_tc.py

It prints the card, the build's ptxas report (registers, spill) and each
tensor-core block's shared memory; K1, K2 and K3 against their plain versions
at the serving shapes in bf16 and f32, with device times (CUDA events behind a
GPU spin), the plain version's and one SDPA call's; then K1 at the edge cases
of `chip_smoke.K1_EDGE_CASES` (phase 4's prefill at q_offset 0 and 128, phase
5's B = 1 prompt forward, timed, head dims 64 and 80, G 1, non-causal, ragged
Sq 200 over Skv 328, all-masked rows; out and lse) and K3 at those of
`K3_EDGE_CASES` (S 100 with a slice whose keys are all masked, S 2048, nh 1,
head dims 64 and 128), every value finite, and the refusals (f16, head dim
96, a misaligned q). About 25 s of command time on an H100, build included:
a short call before the whole of `chip_smoke.py`. Needs a CUDA device and
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = chip_smoke.serving_attention_kernels(gen)
    chip_smoke.fwd_tc_edge_cases(gen, results["flash_attention"], results["full_attention_rope"])
    print(json.dumps(results), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
