#!/usr/bin/env python3
"""Where the time of the bf16 P1/P2 (paged decode attention, tensor-core
kernel) goes, on one card.

    python3 scripts/profile_paged_tc.py

At phase 2's main shape (q (4, 2, 8, 128) bf16 over 128-key pages, lengths
0, 327, 1689, 2041 of a 32-page table row), P1 over bf16 pages and P2 over
int8 pages, at 1, 2 and 4 64-key tiles a chunk: the device time (CUDA events
behind a GPU spin, `chip_smoke.cuda_ms`) of the kernel cut at its entry (0),
once each block knows whether it is live (1), once every warp has its tiles
(2), once every warp has its products (3), once each block has written its
merged state (4), and whole. The cuts
come from a timing build of `csrc/paged_attention.cu` with
-DT1_PG_PROFILE_STOPS (into `time_r1_tpu_torch/_build/pg_stops/`, never
loaded by the port). Beside them, one `torch.sum` over the live K/V bytes
(the gathered pages, contiguous) as what PyTorch's own streaming reaches.
Needs a CUDA device and nvcc; exits 2 without one.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from time_r1_tpu_torch import kernels  # noqa: E402
from time_r1_tpu_torch.ops import paged_attention as pa  # noqa: E402


def build_stops():
    """paged_attention.cu's timing build: its t1_paged_tc_stop."""
    d = kernels.BUILD / "pg_stops"
    d.mkdir(parents=True, exist_ok=True)
    lib = d / "libpaged_attention.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DT1_PG_PROFILE_STOPS", "-o", str(lib),
                    str(kernels.CSRC / "paged_attention.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).t1_paged_tc_stop
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    kernels.build()
    stop_fn = build_stops()
    dev = torch.device("cuda")
    c = chip_smoke.paged_case(torch.Generator(device=dev).manual_seed(5), dev, (0, 327, 1689, 2041), 128, 32, 128)
    q = c["q"].to(torch.bfloat16)
    runs = {
        "P1": ("paged_prefix_attention",
               (q, c["kp"].to(torch.bfloat16), c["vp"].to(torch.bfloat16), None, None, c["table"], c["lengths"],
                c["P"])),
        "P2": ("paged_prefix_attention_q8", (q, c["k8"], c["v8"], c["ks"], c["vs"], c["table"], c["lengths"], c["P"])),
    }
    result = {}
    for label, (name, args) in runs.items():
        quant = args[3] is not None
        for ct in (1, 2, 4):
            row = {}
            for stop in (0, 1, 2, 3, 4):
                prm, _ = pa.tc_params(name, *args, ctiles=ct)

                def call(prm=prm, stop=stop):
                    kernels.check(stop_fn(stop, int(quant), 128, ctypes.addressof(prm), kernels.stream(q)), name)

                row[f"stop {stop}"] = chip_smoke.cuda_ms(call, 200)
            row["whole"] = chip_smoke.cuda_ms(lambda: pa.launch_tc(name, *args, ctiles=ct), 200)
            result[f"{label} CT {ct}"] = row
            chip_smoke.log(f"[profile] {label} CT {ct}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) + " ms")
    live = torch.cat([c["kp"][:, c["table"][s, :-(-n // 128)].long()].reshape(2, -1, 128)[:, :n]
                      for s, n in enumerate(c["lengths"].tolist()) if n], dim=1).to(torch.bfloat16)
    kv = torch.stack([live, live.clone()])
    result["torch.sum over the live K/V"] = chip_smoke.cuda_ms(lambda: kv.sum(dtype=torch.float32), 200)
    chip_smoke.log(f"[profile] torch.sum over the live K/V ({kv.numel() * 2} bytes): "
                   f"{result['torch.sum over the live K/V']:.4f} ms")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
